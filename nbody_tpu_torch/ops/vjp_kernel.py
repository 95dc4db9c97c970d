"""The force VJP kernel (``csrc/vjp.cu``): the backward of the all-pairs
self-acceleration in one pass.

Replaces ``nbody_tpu/ops/grad.py::_vjp_kernel`` (``force_vjp_pallas``),
f32 only.  ``force_vjp(pos (3,N), mass (N,), g (3,N)) -> (d_pos (3,N),
d_mass (N,))`` has the contract of ``grad.force_vjp``, the plain chunked
sweep, which is its oracle.

On a CUDA tensor the wrapper launches the hand-written kernel or raises; on
a CPU tensor it runs ``grad.force_vjp``.  The kernel masks its ragged
edges, so N needs no padding.  Design and bound: see the note at the top of
``csrc/vjp.cu``.
"""

from __future__ import annotations

import torch

from ..utils import build
from . import grad
from .tiled_kernel import check_input, default_tile_i, refuse_autograd

# Targets per CTA (256 threads): Kernel A's rule, tiled_kernel.default_
# tile_i: 64, two a thread (nbt::tiled_targets), or 32, one a thread, where
# 64 would leave SMs without a CTA.  At N=16384 64 x 512 took 0.466 ms
# against 0.477 for 32 x 512, 0.574 for 128 and 1.126 for 256; at N=2048
# the call is host-bound, 32 and 64 within noise of each other (H100,
# scripts/sweep_shapes.py --vjp-tiles, PERF.md).
DEFAULT_TILE_J = 512  # sources per shared-memory tile
THREADS = 256
MAX_TILE_J = 1024  # 32 KB of staged sources and cotangents

# Kernel launches on CUDA tensors; chip_smoke.py zeroes and reads it.
launches = 0


def force_vjp(pos: torch.Tensor, mass: torch.Tensor, g: torch.Tensor,
              tile_i: int = 0, tile_j: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangents (d_pos, d_mass) of the self-acceleration for the output
    cotangent ``g``.  pos (3,N), mass (N,), g (3,N) -> ((3,N), (N,)) fp32.

    ``tile_i``: targets per CTA, a multiple of 32 dividing 256 (default
    64, or 32 where 64 gives fewer CTAs than the card has SMs); a thread
    takes two where it is a multiple of 64 and tile_j allows it
    (``nbt::tiled_targets``).  ``tile_j``: sources per shared-memory tile,
    a multiple of 256/tile_i, at most 1024 (default 512)."""
    global launches
    dev = pos.device
    n = pos.shape[1]
    check_input("pos", pos, (3, n), dev)
    check_input("mass", mass, (n,), dev)
    check_input("g", g, (3, n), dev)
    if dev.type == "cpu":
        return grad.force_vjp(pos, mass, g)
    if dev.type != "cuda":
        raise ValueError(f"vjp kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("vjp kernel", pos, mass, g)
    ti = tile_i or default_tile_i(n, dev)
    tj = tile_j or DEFAULT_TILE_J
    if ti % 32 or THREADS % ti:
        raise ValueError(f"tile_i={ti} must be a multiple of 32 dividing {THREADS}")
    if tj % (THREADS // ti) or not 0 < tj <= MAX_TILE_J:
        raise ValueError(
            f"tile_j={tj} must be a multiple of {THREADS // ti} in (0, {MAX_TILE_J}]"
        )
    d_pos = torch.empty((3, n), dtype=torch.float32, device=dev)
    d_mass = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return d_pos, d_mass
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_force_vjp(
            pos.data_ptr(), mass.data_ptr(), g.data_ptr(), n, d_pos.data_ptr(),
            d_mass.data_ptr(), ti, tj, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nbt_force_vjp")
    launches += 1
    return d_pos, d_mass
