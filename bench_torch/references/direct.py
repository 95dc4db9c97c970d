"""Direct sum (``ver0/GSimulation.cpp:132-161``): a_i = G sum_j m_j
(x_j - x_i) (|x_j - x_i|^2 + eps^2)^(-3/2), the self pair included (its
delta is 0).  The direct configurations' control is the program's own bf16
distance mode, so this reference has no control of its own."""

from __future__ import annotations

import torch

from harness.reference import G_NEWTON, SOFTENING_SQUARED


def direct_accel(pos: torch.Tensor, mass: torch.Tensor,
                 rows: int = 4096) -> torch.Tensor:
    """All-pairs softened accelerations, (3, N) -> (3, N), in pos's dtype.

    |x_j - x_i|^2 + eps^2 is one product of 5-vectors, [x_i, |x_i|^2 + eps^2,
    1] . [-2 x_j, 1, |x_j|^2]: the float64 rounding of that expansion is
    under 1e-12 of eps^2 for |x| < 100."""
    x = pos.T
    n = x.shape[0]
    sq = (x * x).sum(1, keepdim=True)
    one = torch.ones_like(sq)
    lhs = torch.cat([x, sq + SOFTENING_SQUARED, one], 1)
    rhs = torch.cat([-2.0 * x, one, sq], 1).T.contiguous()
    src = torch.cat([x * mass[:, None], mass[:, None]], 1)
    out = torch.empty_like(x)
    for r0 in range(0, n, rows):
        w = lhs[r0:r0 + rows] @ rhs
        w.pow_(-1.5)
        s = w @ src
        out[r0:r0 + rows] = s[:, :3] - x[r0:r0 + rows] * s[:, 3:]
    return G_NEWTON * out.T


def forces(config: dict, mass: torch.Tensor, dtype=torch.float64,
           control: bool = False):
    """For each block's entry positions, the block's force function."""
    if control:
        raise ValueError("the direct reference has no control: the "
                         "configuration's control is the program's")
    return lambda entry: (lambda pos: direct_accel(pos, mass))
