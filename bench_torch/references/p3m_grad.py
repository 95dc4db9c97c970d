"""P3M, open boundary, as the program's differentiable path computes it
for a rollout gradient (``harness/grad_check.py``): ``references/p3m.py``'s
force, with the mesh box, r_c^2 and the kernel spectra made on every force
call from the positions it is given, not frozen at a block's entry, so the
gradient flows through them as through the program's
(``make_accel_fn("p3m", differentiable=True)`` builds them on every call,
and its short-range VJP returns r_c^2's cotangent).

The program stops no gradient on this path, and neither does this: the
integer CIC corners and cell ids, the in-box masks and the choice of
octant carry none in either, and everything else (the box's extremes and
quantiles, the CIC fractions, the spectra, the pair deltas and weights,
the monopoles) is differentiated as it is computed.

To fit on the card, the short-range sum is checkpointed
(``torch.utils.checkpoint``) chunk by chunk of ``harness/neighbours.py``'s
candidate pairs: a chunk's backward makes its pairs again, so no pair
index is kept between the forward and the backward.  The control
(``control=True``) is ``references/p3m.py``'s: float32, the pair deltas,
density, spectra and force grids rounded through bfloat16; the gradient is
taken through the roundings as they stand.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from harness import neighbours, reference

# Candidate pairs of a checkpointed chunk.
CHUNK = neighbours.PAIR_CHUNK


class P3MGrad(reference.solver("p3m").P3M):
    def _short_range(self, pos, mass, members, env):
        with torch.no_grad():
            plan = neighbours.fine_plan(pos, members, env["lo_box"],
                                        env["span"], self.nc, self.sub)
        acc = torch.zeros_like(pos)
        for t0, t1 in plan.chunks(CHUNK):
            acc = acc + checkpoint(self._chunk, pos, mass, env["rc2"], plan,
                                   t0, t1, use_reentrant=False)
        return acc

    def _chunk(self, pos, mass, rc2, plan, t0, t1):
        i, j, d, _ = neighbours.inside_pairs(pos, *plan.pairs(t0, t1), rc2)
        return self._pair_sum(torch.zeros_like(pos), mass, i, j, d, rc2)


def force(config: dict, mass: torch.Tensor, dtype=torch.float64,
          control: bool = False):
    """positions -> accelerations, the box and spectra made on each call."""
    p3m = P3MGrad(config["grid"], config["cutoff_cells"], dtype=dtype,
                  bf16=control)

    def accel(pos):
        return p3m.accel(pos, mass, p3m.block_env(pos, mass))

    return accel
