"""The fused ring (``csrc/ring.cu``): the K-hop source ring of the particle
decomposition in one kernel launch (comm ``rdma``).

Replaces ``nbody_tpu/parallel/ring_kernel.py::_kernel``.  The JAX version
runs inside ``shard_map``, one kernel per chip, and streams each shard's
packed source block to the right neighbour by remote DMA.  The port's
single controller takes all K shards of one card in one call: the kernel
keeps the protocol (two ring slots a shard, an entry barrier with both
neighbours, a per-slot "free" handshake before each overwrite, one copy a
hop into the right neighbour's other slot), with the slots and flags in the
card's memory (see the note in ``csrc/ring.cu``).

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors it
runs ``ring_accelerations_plain``, the same K-hop loop in plain PyTorch.
Shards on more than one device raise: the slots would have to be peer
memory of other cards (ROADMAP.md queue 1 item 11(b)).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.tiled_kernel import (
    accelerations_between_plain,
    check_input,
    check_tiles,
    refuse_autograd,
)
from ..utils import build

MAX_SHARDS = 64  # csrc/ring.cu kMaxShards: the kernel's pointer tables

# Kernel launches on CUDA tensors; chip_smoke.py zeroes and reads it.
launches = 0


def ring_accelerations_plain(pos_shards: list, mass_shards: list) -> list:
    """The ring in plain PyTorch: at hop h shard k holds the source block of
    shard (k - h) mod K, and adds its one-sided sweep, in the kernel's hop
    order."""
    k = len(pos_shards)
    out = []
    for s, pos in enumerate(pos_shards):
        acc = None
        for h in range(k):
            src = (s - h) % k
            a = accelerations_between_plain(
                pos, pos_shards[src].to(pos.device),
                mass_shards[src].to(pos.device))
            acc = a if acc is None else acc + a
        out.append(acc)
    return out


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def ring_accelerations(pos_shards: list, mass_shards: list, tile_i: int = 0,
                       tile_j: int = 0) -> list:
    """Accelerations of every shard's targets due to all shards' sources,
    through the ring: K (3, N/K) positions and K (N/K,) masses -> K
    (3, N/K) fp32.  ``tile_i``/``tile_j`` as for Kernel A's
    ``accelerations_between`` (defaults 64 and 256); the kernel masks ragged
    tiles, so N/K need not be a multiple of either."""
    global launches
    k = len(pos_shards)
    if not 1 <= k <= MAX_SHARDS or len(mass_shards) != k:
        raise ValueError(
            f"need 1..{MAX_SHARDS} shards with a mass each, got {k} positions "
            f"and {len(mass_shards)} masses")
    devices = {t.device for t in (*pos_shards, *mass_shards)}
    if len(devices) > 1:
        raise NotImplementedError(
            "the ring over shards on more than one device needs peer-memory "
            "ring slots: ROADMAP.md queue 1 item 11(b)")
    dev = devices.pop()
    nl = pos_shards[0].shape[1]
    for s in range(k):
        check_input(f"pos[{s}]", pos_shards[s], (3, nl), dev)
        check_input(f"mass[{s}]", mass_shards[s], (nl,), dev)
    if dev.type == "cpu":
        return ring_accelerations_plain(pos_shards, mass_shards)
    if dev.type != "cuda":
        raise ValueError(f"ring kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("ring kernel", *pos_shards, *mass_shards)
    ti, tj = check_tiles(tile_i, tile_j)
    out = torch.empty((k, 3, nl), dtype=torch.float32, device=dev)
    slots = torch.empty((k, 2, nl, 4), dtype=torch.float32, device=dev)
    # ready[k], recv[k][hop], free[k][hop]; zeroed in C
    flags = torch.empty(k + 2 * k * k, dtype=torch.int32, device=dev)
    outs = list(out.unbind(0))
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_ring_accel(
            _pointers(pos_shards), _pointers(mass_shards), _pointers(outs),
            _pointers(slots.unbind(0)), k, nl, flags.data_ptr(), ti, tj,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nbt_ring_accel")
    launches += 1
    return outs
