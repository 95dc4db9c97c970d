"""The |r|^2-expansion force sweep, ``--kernel pallas_mxu`` (``csrc/mxu.cu``).

Replaces ``nbody_tpu/ops/pallas_mxu.py::_kernel``: squared distances as the
dot product of augmented rows A_j = [x, y, z, |r|^2, 1, G m, 0, 0] and
B_i = [-2x, -2y, -2z, 1, |r|^2 + eps^2, 0, 0, 0], clamped at eps^2; the
weights w = G m_j d2^{-3/2}; m_i = sum_j w_ij [x_j, y_j, z_j, 1]; and
a_i = m_i[0:3] - r_i m_i[3].  The public functions keep the JAX package's
layout (``accelerations_between(pos_tgt (3,Nt), pos_src (3,Ns), mass_src
(Ns,)) -> (3,Nt)``) and its refusal of the bf16 distance mode.

On a CUDA tensor the wrapper launches the hand-written kernel (d2 on the
FP32 pipes in the plain version's rounding, m = w P on the tensor cores as
3xTF32 ``mma.sync``) or raises; on a CPU tensor it runs
``accelerations_between_plain``, JAX's function the JAX way in plain
PyTorch.  The kernel masks its ragged edges, so Nt and Ns need no padding.
Design and bound: see the note at the top of ``csrc/mxu.cu``.
"""

from __future__ import annotations

import torch

from ..types import G_NEWTON, SOFTENING_SQUARED
from ..utils import build
from .tiled_kernel import check_input, refuse_autograd

WARPS = 8  # a CTA's warps; each takes 16 targets (the mma's M)
TILE_I = (16, 32, 64, 128)  # 16 targets times the warps that split them
DEFAULT_TILE_I = 64
DEFAULT_TILE_J = 512
MAX_TILE_J = 2048  # 104 KB: (x, y, z, |r|^2), G m and 32 bytes of B a source

# Kernel launches on CUDA tensors; chip_smoke.py zeroes and reads it.
launches = 0


def check_fp32_distances(dist_dtype: str) -> None:
    """The JAX package's refusal (``pallas_mxu.py:90-94``)."""
    if dist_dtype != "float32":
        raise ValueError(
            "pallas_mxu supports only fp32 distances (the |r|^2 expansion "
            "already loses bits; use --kernel pallas for bf16 mode)"
        )


def check_tiles(tile_i: int, tile_j: int) -> tuple[int, int]:
    """The mxu kernel's tiles (0: the defaults), or a ValueError.  A CTA's
    8 warps take 16 targets each: ``tile_i`` = 16 x the warps a source tile's
    targets split into (16, 32, 64 or 128), and the other 128 / tile_i warps
    split each source tile in k-steps of 8 sources, so ``tile_j`` is a
    multiple of 1024 / tile_i, at most 2048."""
    ti = tile_i or DEFAULT_TILE_I
    tj = tile_j or DEFAULT_TILE_J
    if ti not in TILE_I:
        raise ValueError(f"tile_i={ti} must be one of {TILE_I} for the mxu "
                         "kernel (16 targets a warp)")
    step = 8 * (16 * WARPS // ti)
    if tj % step or not 0 < tj <= MAX_TILE_J:
        raise ValueError(
            f"tile_j={tj} must be a multiple of {step} in (0, {MAX_TILE_J}] "
            f"for the mxu kernel at tile_i={ti}")
    return ti, tj


def accelerations_between_plain(pos_tgt: torch.Tensor, pos_src: torch.Tensor,
                                 mass_src: torch.Tensor, chunk: int = 1024
                                 ) -> torch.Tensor:
    """JAX's function the JAX way, over chunks of targets: the augmented
    rows A (8, Ns) and B (8, C), d2 = max(A . B, eps^2) summed over the
    five nonzero terms in k order, w = G m_j d2^{-3/2} (IEEE ``1 / sqrt``),
    m = P . w with P_j = [x, y, z, 1], then a = m[0:3] - r m[3].  Each
    product and sum is rounded on its own; the kernel rounds d2 the same
    way, takes w within a few ulp (the SFU's rsqrt) and m on the tensor
    cores (3xTF32), so the two agree to fp32 rounding."""
    ns = pos_src.shape[1]
    gm = mass_src * G_NEWTON
    ones_s = torch.ones(ns, dtype=pos_src.dtype, device=pos_src.device)
    r2s = pos_src[0] ** 2 + pos_src[1] ** 2 + pos_src[2] ** 2
    a = torch.stack([pos_src[0], pos_src[1], pos_src[2], r2s, ones_s, gm])
    p = torch.stack([pos_src[0], pos_src[1], pos_src[2], ones_s])
    out = []
    for c0 in range(0, pos_tgt.shape[1], chunk):
        t = pos_tgt[:, c0:c0 + chunk]
        r2t = t[0] ** 2 + t[1] ** 2 + t[2] ** 2
        b = torch.stack([-2.0 * t[0], -2.0 * t[1], -2.0 * t[2],
                         torch.ones_like(r2t), r2t + SOFTENING_SQUARED])
        d2 = b[0][:, None] * a[0][None, :]  # (C, Ns)
        for k in range(1, 5):  # the nonzero terms; k = 5..7 add exact zeros
            d2 = d2 + b[k][:, None] * a[k][None, :]
        d2 = torch.clamp(d2, min=SOFTENING_SQUARED)
        inv = 1.0 / torch.sqrt(d2)
        w = a[5][None, :] * (inv * inv * inv)
        m = torch.stack([(w * p[k][None, :]).sum(dim=1) for k in range(4)])
        out.append(m[0:3] - t * m[3:4])
    return torch.cat(out, dim=1)


def accelerations_between(pos_tgt: torch.Tensor, pos_src: torch.Tensor,
                          mass_src: torch.Tensor, tile_i: int = 0,
                          tile_j: int = 0, dist_dtype: str = "float32"
                          ) -> torch.Tensor:
    """Accelerations of targets due to sources through the |r|^2 expansion.
    pos_tgt (3, Nt), pos_src (3, Ns), mass_src (Ns,) -> (3, Nt) fp32.

    ``tile_i``: targets per CTA, 16, 32, 64 or 128 (default 64).
    ``tile_j``: sources per shared-memory tile, a multiple of 1024/tile_i,
    at most 2048 (default 512).  ``dist_dtype`` other than float32 raises,
    as in the JAX package."""
    global launches
    check_fp32_distances(dist_dtype)
    dev = pos_tgt.device
    nt, ns = pos_tgt.shape[1], pos_src.shape[1]
    check_input("pos_tgt", pos_tgt, (3, nt), dev)
    check_input("pos_src", pos_src, (3, ns), dev)
    check_input("mass_src", mass_src, (ns,), dev)
    if dev.type == "cpu":
        return accelerations_between_plain(pos_tgt, pos_src, mass_src)
    if dev.type != "cuda":
        raise ValueError(f"mxu kernel runs on cuda or cpu, not {dev}")
    refuse_autograd("mxu kernel", pos_tgt, pos_src, mass_src)
    ti, tj = check_tiles(tile_i, tile_j)
    out = torch.empty((3, nt), dtype=torch.float32, device=dev)
    if nt == 0 or ns == 0:
        return out.zero_()
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.nbt_mxu_accel(
            pos_tgt.data_ptr(), nt, pos_src.data_ptr(), mass_src.data_ptr(),
            ns, out.data_ptr(), ti, tj, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nbt_mxu_accel")
    launches += 1
    return out


def accelerations(pos: torch.Tensor, mass: torch.Tensor, tile_i: int = 0,
                  tile_j: int = 0, dist_dtype: str = "float32") -> torch.Tensor:
    """All-pairs self-accelerations. pos (3,N), mass (N,) -> (3,N)."""
    return accelerations_between(pos, pos, mass, tile_i=tile_i, tile_j=tile_j,
                                 dist_dtype=dist_dtype)
