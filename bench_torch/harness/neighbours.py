"""The short-range geometry of the plain P3M reference, shared with the
yardstick's pair count: the mesh box, the cell grid, and every unordered
pair of bodies closer than the cutoff radius, found in plain torch.

* the mesh box: per axis the inner-99% quantile span of the massive
  particles (every ``N // 65536``-th one), a quarter span more each side,
  clipped to the extent;
* the cells: nc = min(sub * ng / cutoff, 40) an axis over the box, with a
  neighbour reach of ``sub`` cells (``sub`` 2 where ng / cutoff < 24, else
  1); the cutoff radius r_c is ``sub`` cell widths of the box's shortest
  axis.
"""

from __future__ import annotations

import math

import torch

# Pairs generated at once by the pair search.
PAIR_CHUNK = 1 << 24
# Cells of the pair search: FINE times finer than the cell grid, so that a
# neighbourhood holds less volume outside the cutoff sphere.
FINE = 2


def cell_grid(grid: int, cutoff_cells: int) -> tuple[int, int]:
    """(nc cells an axis, neighbour reach sub)."""
    sub = 1 if grid // cutoff_cells >= 24 else 2
    return min(max(2, (sub * grid) // cutoff_cells), 40), sub


def robust_box(pos: torch.Tensor, mass: torch.Tensor):
    real = mass[None, :] > 0
    lo_exact = torch.where(real, pos, math.inf).amin(1, keepdim=True)
    hi_exact = torch.where(real, pos, -math.inf).amax(1, keepdim=True)
    stride = max(1, pos.shape[1] // 65536)
    sample = torch.where(real[:, ::stride], pos[:, ::stride], math.nan)
    q = torch.nanquantile(
        sample, torch.tensor([0.005, 0.995], dtype=pos.dtype,
                             device=pos.device), dim=1)
    q_lo, q_hi = q[0][:, None], q[1][:, None]
    span_q = 0.25 * (q_hi - q_lo)
    lo = torch.maximum(lo_exact, q_lo - span_q)
    hi = torch.minimum(hi_exact, q_hi + span_q)
    return lo, torch.maximum(hi, lo + 1e-6)


def cutoff_squared(span: torch.Tensor, nc: int, sub: int):
    return (span[:, 0].min() * sub / nc) ** 2


def in_box(pos, mass, lo_box, hi_box) -> torch.Tensor:
    """The massive bodies inside the mesh box: those the short range
    takes."""
    return ((pos >= lo_box) & (pos <= hi_box)).all(0) & (mass > 0)


def cell_ids(pos, lo_box, span, nc: int) -> torch.Tensor:
    g = ((pos - lo_box) * (nc / span)).clamp(0.0, nc - 1.0)
    c = torch.floor(g).long()
    return (c[0] * nc + c[1]) * nc + c[2]


class PairPlan:
    """The candidate pairs of ``neighbour_pairs``, made in chunks on demand:
    each member's runs of neighbours (``lengths`` from ``first``) in the
    cell-sorted order, so that chunk ``[t0, t1)`` of those members can be
    made again without keeping its indices (the reference's gradient
    recomputes a chunk in its backward)."""

    def __init__(self, cid: torch.Tensor, members: torch.Tensor, nc: int,
                 reach: int):
        dev = cid.device
        idx = torch.nonzero(members).flatten()
        c = cid[idx]
        order = torch.argsort(c, stable=True)
        idx, c = idx[order], c[order]
        m = idx.shape[0]
        counts = torch.bincount(c, minlength=nc ** 3)
        starts = torch.cumsum(counts, 0) - counts
        cx, cy, cz = c // (nc * nc), (c // nc) % nc, c % nc
        # Half the neighbourhood: the offsets above (0, 0, 0) in
        # lexicographic order, and in the cell itself the members after
        # this one.
        offs = torch.tensor([(ox, oy, oz) for ox in range(-reach, reach + 1)
                             for oy in range(-reach, reach + 1)
                             for oz in range(-reach, reach + 1)
                             if (ox, oy, oz) > (0, 0, 0)], device=dev)
        nx = cx[:, None] + offs[None, :, 0]
        ny = cy[:, None] + offs[None, :, 1]
        nz = cz[:, None] + offs[None, :, 2]
        ok = ((nx >= 0) & (nx < nc) & (ny >= 0) & (ny < nc) & (nz >= 0)
              & (nz < nc))
        nb = torch.where(ok, (nx * nc + ny) * nc + nz, 0)
        del nx, ny, nz
        at = torch.arange(m, device=dev)
        self.lengths = torch.cat([(starts[c] + counts[c] - at - 1)[:, None],
                                  torch.where(ok, counts[nb], 0)], 1)
        self.first = torch.cat([(at + 1)[:, None], starts[nb]], 1)
        self.idx, self.m = idx, m
        self.cum = torch.cumsum(self.lengths.sum(1), 0).cpu()

    def chunks(self, chunk: int = PAIR_CHUNK) -> list:
        """[(t0, t1)]: runs of members of about ``chunk`` pairs each."""
        out, t0, cum = [], 0, self.cum
        while t0 < self.m:
            done = int(cum[t0 - 1]) if t0 else 0
            t1 = int(torch.searchsorted(cum, done + chunk, side="right"))
            t1 = min(max(t1, t0 + 1), self.m)
            out.append((t0, t1))
            t0 = t1
        return out

    def pairs(self, t0: int, t1: int):
        """(i, j): the candidate pairs of members ``[t0, t1)``."""
        dev = self.idx.device
        width = self.lengths.shape[1]
        ln = self.lengths[t0:t1].flatten()
        run = torch.repeat_interleave(
            torch.arange(ln.shape[0], device=dev), ln)
        run_start = torch.cumsum(ln, 0) - ln
        k = torch.arange(run.shape[0], device=dev) - run_start[run]
        j = self.first[t0:t1].flatten()[run] + k
        i = t0 + run // width
        return self.idx[i], self.idx[j]


def neighbour_pairs(cid: torch.Tensor, members: torch.Tensor, nc: int,
                    reach: int, chunk: int = PAIR_CHUNK):
    """Yield (i, j) index tensors covering every unordered pair of members
    in the same cell or in cells up to ``reach`` apart on each axis once,
    i != j, in chunks of about ``chunk`` pairs.  ``cid``: cell ids on an
    nc^3 grid."""
    plan = PairPlan(cid, members, nc, reach)
    for t0, t1 in plan.chunks(chunk):
        yield plan.pairs(t0, t1)


def inside_pairs(pos, i, j, rc2):
    """(i, j, d = x_j - x_i, r^2) of the candidate pairs (i, j) closer than
    r_c.  The gathers are ``index_select``s: their backward adds into the
    positions' gradient directly, where an indexing gather's sorts its
    indices first."""
    d = pos.index_select(1, j) - pos.index_select(1, i)
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    inside = torch.nonzero(r2 < rc2).flatten()
    return i[inside], j[inside], d[:, inside], r2[inside]


def fine_plan(pos, members, lo_box, span, nc: int, sub: int) -> PairPlan:
    """The candidate pairs of ``near_pairs``: cells ``FINE`` times finer
    than the cell grid, a reach of ``FINE * sub`` of them."""
    ncf = FINE * nc
    return PairPlan(cell_ids(pos, lo_box, span, ncf), members, ncf,
                    FINE * sub)


def near_pairs(pos, members, lo_box, span, nc: int, sub: int, rc2):
    """Yield (i, j, d = x_j - x_i, r^2) for every unordered pair of members
    closer than r_c, once."""
    plan = fine_plan(pos, members, lo_box, span, nc, sub)
    for t0, t1 in plan.chunks():
        yield inside_pairs(pos, *plan.pairs(t0, t1), rc2)
