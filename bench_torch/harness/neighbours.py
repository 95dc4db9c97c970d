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


def neighbour_pairs(cid: torch.Tensor, members: torch.Tensor, nc: int,
                    reach: int, chunk: int = PAIR_CHUNK):
    """Yield (i, j) index tensors covering every unordered pair of members
    in the same cell or in cells up to ``reach`` apart on each axis once,
    i != j, in chunks of about ``chunk`` pairs.  ``cid``: cell ids on an
    nc^3 grid."""
    dev = cid.device
    idx = torch.nonzero(members).flatten()
    c = cid[idx]
    order = torch.argsort(c, stable=True)
    idx, c = idx[order], c[order]
    m = idx.shape[0]
    counts = torch.bincount(c, minlength=nc ** 3)
    starts = torch.cumsum(counts, 0) - counts
    cx, cy, cz = c // (nc * nc), (c // nc) % nc, c % nc
    # Half the neighbourhood: the offsets above (0, 0, 0) in lexicographic
    # order, and in the cell itself the members after this one.
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
    lengths = torch.cat([(starts[c] + counts[c] - at - 1)[:, None],
                         torch.where(ok, counts[nb], 0)], 1)
    first = torch.cat([(at + 1)[:, None], starts[nb]], 1)
    del ok, nb
    width = lengths.shape[1]
    cum = torch.cumsum(lengths.sum(1), 0).cpu()
    t0 = 0
    while t0 < m:
        done = int(cum[t0 - 1]) if t0 else 0
        t1 = int(torch.searchsorted(cum, done + chunk, side="right"))
        t1 = min(max(t1, t0 + 1), m)
        ln = lengths[t0:t1].flatten()
        run = torch.repeat_interleave(
            torch.arange(ln.shape[0], device=dev), ln)
        run_start = torch.cumsum(ln, 0) - ln
        k = torch.arange(run.shape[0], device=dev) - run_start[run]
        j = first[t0:t1].flatten()[run] + k
        i = t0 + run // width
        yield idx[i], idx[j]
        t0 = t1


def near_pairs(pos, members, lo_box, span, nc: int, sub: int, rc2):
    """Yield (i, j, d = x_j - x_i, r^2) for every unordered pair of members
    closer than r_c, once."""
    ncf = FINE * nc
    cid = cell_ids(pos, lo_box, span, ncf)
    for i, j in neighbour_pairs(cid, members, ncf, FINE * sub):
        d = pos[:, j] - pos[:, i]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inside = torch.nonzero(r2 < rc2).flatten()
        yield i[inside], j[inside], d[:, inside], r2[inside]
