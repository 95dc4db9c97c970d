"""Kernel B: the pair-symmetric self-sweep (``csrc/sym.cu``).

Replaces ``nbody_tpu/ops/pallas_sym.py::_sym_kernel`` with
``fold_mass=True``, f32 only.  Each unordered B x B tile pair is computed
once with the mass-folded weight w = (G m_i)(G m_j)/(d^2+eps^2)^{3/2};
diagonal tiles take a one-sided sum; a = S / (G m), zero mass giving 0.

On Hopper the CTAs run in no order, so the j-side reaction is kept in
deterministic per-tile-pair partials, P[it][jt] and P[jt][it], which a
second kernel adds in a fixed order (see the note in ``csrc/sym.cu``).
The partials take ``scratch_bytes(n, block)`` = 12 N^2 / B bytes of device
memory; ``fits`` bounds them by a share of the card's memory, and the
registry's ``auto`` takes the tiled kernel above it.  The TPU's VMEM cap
(``max_sym_n``) does not carry over.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs ``accelerations_plain``, the same tile-pair algorithm in plain
PyTorch, so the CPU tests exercise the mass-folded math and the partials.
"""

from __future__ import annotations

import torch

from ..types import G_NEWTON, SOFTENING_SQUARED
from ..utils import build
from .tiled_kernel import check_input, refuse_autograd

DEFAULT_BLOCK = 128
MAX_BLOCK = 256  # 8 warps of j-side partials fill 24 KB of shared memory
# ``auto`` takes this kernel while its partials fit this share of the card.
SCRATCH_SHARE = 1 / 8

# Kernel launches on CUDA tensors; chip_smoke.py zeroes and reads it.
launches = 0


def scratch_bytes(n: int, block: int) -> int:
    """Bytes of partials: T x T tile pairs of (3, B) fp32, T = n / B."""
    return 3 * 4 * n * (n // block)


def fits(n: int, block: int, device: torch.device) -> bool:
    """Whether the CUDA kernel takes this shape and its partials stay
    within SCRATCH_SHARE of the card's memory."""
    if block % 32 or block > MAX_BLOCK or n % block:
        return False
    total = torch.cuda.get_device_properties(device).total_memory
    return scratch_bytes(n, block) <= SCRATCH_SHARE * total


def accelerations_plain(pos: torch.Tensor, mass: torch.Tensor,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: for each i tile, the
    diagonal tile and every later tile in one broadcast block, written into
    the same (T, T, 3, B) partials, then the ordered sum and the divide."""
    n = pos.shape[1]
    b = min(block, n)
    if n % b:
        raise ValueError(f"N={n} must be divisible by block={b}")
    t_count = n // b
    gm = mass * G_NEWTON
    part = torch.empty((t_count, t_count, 3, b), dtype=pos.dtype,
                       device=pos.device)
    for it in range(t_count):
        i0 = it * b
        d = pos[:, None, i0:] - pos[:, i0:i0 + b, None]  # (3, B, N - i0)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
        inv = 1.0 / torch.sqrt(d2)
        w = (gm[i0:i0 + b, None] * gm[None, i0:]) * (inv * inv * inv)
        p = (d * w).reshape(3, b, t_count - it, b)  # [c, i, jt - it, j]
        part[it, it:] = p.sum(dim=3).permute(2, 0, 1)  # i side: P[it][jt]
        # j side of the off-diagonal tiles: P[jt][it] = -sum_i w d
        part[it + 1:, it] = -p[:, :, 1:].sum(dim=1).permute(1, 0, 2)
    s = part.sum(dim=1).permute(1, 0, 2).reshape(3, n)
    pos_mass = gm > 0
    return torch.where(pos_mass, s / torch.where(pos_mass, gm, 1.0), 0.0)


def accelerations(pos: torch.Tensor, mass: torch.Tensor, block: int = 0,
                  tile_i: int = 0, tile_j: int = 0) -> torch.Tensor:
    """All-pairs self-accelerations via the pair-symmetric sweep.
    pos (3, N), mass (N,) -> (3, N) fp32.  N must be divisible by the block
    (``block``, else ``tile_i``, else DEFAULT_BLOCK); on CUDA the block is
    a multiple of 32, at most 256.  ``tile_j`` is accepted for
    registry-option uniformity and unused."""
    global launches
    del tile_j
    dev = pos.device
    n = pos.shape[1]
    check_input("pos", pos, (3, n), dev)
    check_input("mass", mass, (n,), dev)
    b = min(block or tile_i or DEFAULT_BLOCK, n)
    if n % b:
        raise ValueError(f"N={n} must be divisible by block={b}")
    if dev.type == "cpu":
        return accelerations_plain(pos, mass, b)
    if dev.type != "cuda":
        raise ValueError(f"sym kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("sym kernel", pos, mass)
    if b % 32 or b > MAX_BLOCK:
        raise ValueError(f"block={b} must be a multiple of 32, at most {MAX_BLOCK}")
    part = torch.empty(scratch_bytes(n, b) // 4, dtype=torch.float32, device=dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_sym_accel(
            pos.data_ptr(), mass.data_ptr(), n, b, part.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nbt_sym_accel")
    launches += 1
    return out
