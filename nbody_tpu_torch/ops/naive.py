"""Naive all-pairs force in plain PyTorch: the oracle of both CUDA kernels.

The port of ``nbody_tpu.ops.naive``: one O(N^2) softened-gravity evaluation
as broadcast tensor ops, with fp32 deltas or, under
``dist_dtype="bfloat16"``, deltas subtracted in fp32 and rounded through
bf16 (fp32 arithmetic), as the JAX package's naive.  The target axis is
processed in chunks so the temporaries are O(chunk * N) instead of O(N^2).
Self-interaction is included (dx=0 makes it exactly zero), matching
ver0/GSimulation.cpp:132-147.
"""

from __future__ import annotations

import torch

from ..types import G_NEWTON, SOFTENING_SQUARED
from .tiled_kernel import check_dist_dtype, round_deltas


def _acc_block(pos_t: torch.Tensor, pos_s: torch.Tensor, gm: torch.Tensor,
               bf16: bool) -> torch.Tensor:
    """Accelerations on a block of targets. pos_t (3,C), pos_s (3,N), gm (N,)."""
    d = round_deltas(pos_s[:, None, :] - pos_t[:, :, None], bf16)  # (3, C, N)
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
    inv = torch.rsqrt(d2)
    w = gm[None, :] * (inv * inv * inv)  # (C, N)
    return (d * w).sum(dim=2)  # sum over sources: (3, C)


def accelerations_between(pos_tgt: torch.Tensor, pos_src: torch.Tensor,
                          mass_src: torch.Tensor, chunk: int = 1024,
                          dist_dtype: str = "float32") -> torch.Tensor:
    """Accelerations of targets due to sources.
    pos_tgt (3, Nt), pos_src (3, Ns), mass_src (Ns,) -> acc (3, Nt), fp32."""
    bf16 = check_dist_dtype(dist_dtype)
    gm = mass_src * G_NEWTON
    return torch.cat(
        [_acc_block(pos_tgt[:, c0:c0 + chunk], pos_src, gm, bf16)
         for c0 in range(0, pos_tgt.shape[1], chunk)],
        dim=1,
    )


def accelerations(pos: torch.Tensor, mass: torch.Tensor, **opts) -> torch.Tensor:
    """All-pairs self-accelerations. pos (3,N), mass (N,) -> (3,N).
    Tile options are accepted and ignored, so ``naive`` drops in wherever
    a kernel name is configurable."""
    for k in ("tile_i", "tile_j", "block"):
        opts.pop(k, None)
    return accelerations_between(pos, pos, mass, **opts)
