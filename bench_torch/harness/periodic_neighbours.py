"""The short-range geometry of the plain periodic P3M reference, shared with
the yardstick's pair count (``metrics/sr_periodic_roofline.py``): every
unordered minimum-image pair of bodies closer than the cutoff radius in a
cubic box of edge L, found in plain torch by a cell search that wraps round
the box.

* the cells: nc an axis across the box by the program's rule
  (``neighbours.cell_grid``), r_c = sub L / nc;
* the search: cells ``neighbours.FINE`` times finer, a reach of
  ``FINE * sub`` of them an axis, each neighbour's index taken modulo the
  grid; a pair's separation is its minimum image, d - L round(d / L).  No
  ghost image is made.  The box is all of space, so every massive body is
  binned.
"""

from __future__ import annotations

import torch

from . import neighbours


def cutoff(grid: int, cutoff_cells: int, box: float) -> tuple:
    """(nc, sub, r_c) of the periodic cell grid."""
    nc, sub = neighbours.cell_grid(grid, cutoff_cells)
    return nc, sub, sub * box / nc


def wrap(pos: torch.Tensor, box: float) -> torch.Tensor:
    """Positions folded into [0, L) per axis."""
    w = pos - box * torch.floor(pos / box)
    # x - L floor(x / L) can round to L itself.
    return torch.where(w >= box, w - box, w)


def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


class PeriodicPairPlan(neighbours.PairPlan):
    """``neighbours.PairPlan`` on a grid that wraps: each member's runs of
    neighbours in the cell-sorted order, the neighbour cells taken modulo
    ``nc``.  With nc >= 2 reach + 1 the half neighbourhood names each pair
    of distinct cells once; on a coarser grid (r_c not below half the box,
    which the program refuses too) it would name some twice."""

    def __init__(self, pos_w: torch.Tensor, members: torch.Tensor,
                 box: float, nc: int, reach: int):
        if nc < 2 * reach + 1:
            raise ValueError(f"a wrapped grid of {nc} cells an axis cannot "
                             f"take a reach of {reach}")
        dev = pos_w.device
        co = torch.floor(pos_w * (nc / box)).long().clamp(0, nc - 1)
        cid = (co[0] * nc + co[1]) * nc + co[2]
        idx = torch.nonzero(members).flatten()
        c = cid[idx]
        order = torch.argsort(c, stable=True)
        idx, c = idx[order], c[order]
        m = idx.shape[0]
        counts = torch.bincount(c, minlength=nc ** 3)
        starts = torch.cumsum(counts, 0) - counts
        cx, cy, cz = c // (nc * nc), (c // nc) % nc, c % nc
        offs = torch.tensor([(ox, oy, oz) for ox in range(-reach, reach + 1)
                             for oy in range(-reach, reach + 1)
                             for oz in range(-reach, reach + 1)
                             if (ox, oy, oz) > (0, 0, 0)], device=dev)
        nb = (((cx[:, None] + offs[None, :, 0]) % nc) * nc
              + (cy[:, None] + offs[None, :, 1]) % nc) * nc \
            + (cz[:, None] + offs[None, :, 2]) % nc
        at = torch.arange(m, device=dev)
        self.lengths = torch.cat([(starts[c] + counts[c] - at - 1)[:, None],
                                  counts[nb]], 1)
        self.first = torch.cat([(at + 1)[:, None], starts[nb]], 1)
        del nb
        self.idx, self.m = idx, m
        self.cum = torch.cumsum(self.lengths.sum(1), 0).cpu()


def near_pairs(pos: torch.Tensor, members: torch.Tensor, box: float,
               nc: int, sub: int, rc2: float):
    """Yield (i, j, d, r^2) for every unordered pair of members whose
    minimum-image separation d (of x_j from x_i) is shorter than r_c, once.
    ``pos`` need not be wrapped."""
    pos_w = wrap(pos, box)
    plan = PeriodicPairPlan(pos_w, members, box, neighbours.FINE * nc,
                            neighbours.FINE * sub)
    for t0, t1 in plan.chunks():
        i, j = plan.pairs(t0, t1)
        d = min_image(pos_w.index_select(1, j) - pos_w.index_select(1, i),
                      box)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inside = torch.nonzero(r2 < rc2).flatten()
        yield i[inside], j[inside], d[:, inside], r2[inside]


def sr_pairs(pos: torch.Tensor, mass: torch.Tensor, grid: int,
             cutoff_cells: int, box: float) -> tuple[int, int]:
    """(unordered minimum-image pairs inside r_c, bodies) of the periodic
    short-range sum on this state: the bodies are the massive ones, all of
    them binned.  pos (3, N) float32, counted in float64."""
    nc, sub, rc = cutoff(grid, cutoff_cells, box)
    members = mass > 0
    count = sum(int(i.shape[0]) for i, _, _, _ in near_pairs(
        pos.double(), members, box, nc, sub, rc * rc))
    return count, int(members.sum())


def mean_sr_pairs(states, grid: int, cutoff_cells: int, box: float) -> tuple:
    """(pairs, bodies) of ``sr_pairs``, each the mean over the (pos, mass)
    ``states``."""
    counts = [sr_pairs(pos, mass, grid, cutoff_cells, box)
              for pos, mass in states]
    return (sum(c[0] for c in counts) / len(counts),
            sum(c[1] for c in counts) / len(counts))

