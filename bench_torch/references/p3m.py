"""P3M, open boundary, as the program's mesh tier defines it (ng mesh
points an axis, a split radius of ``cutoff_cells`` mesh cells):

* the mesh box (``harness/neighbours.py``), frozen with the kernel spectra
  at each block's entry;
* the long range: the masses inside the box deposited by cloud-in-cell on
  ng^3 points over the box with one spare point each side (spacing
  span / (ng - 3)), convolved on the doubled (2 ng)^3 grid with the
  sampled softened kernel times the smoothstep taper
  S(q) = q^3 (6 q^2 - 15 q + 10), q = r^2 / r_c^2, each spectrum divided
  by the squared cloud-in-cell window (sinc^4 per axis, sinc at least
  1e-3), and interpolated back by cloud-in-cell;
* the short range: the complement kernel (1 - S) summed exactly over every
  pair of in-box bodies inside r_c, each pair once with its reaction.  The
  configuration's cell capacity holds every body (the program's plan
  health check reads no overflow), so no body falls back to the mesh;
* outside the box: a particle feels the in-box mass as one point; the mass
  outside the box acts as one point per octant around the box centre, on
  every particle.

The control (``control=True``) runs in float32 and rounds every
short-range pair delta, the deposited density, the kernel spectra and the
force grids through bfloat16 (PyTorch has no bfloat16 transform, so the
FFTs run in float32 between the roundings).
"""

from __future__ import annotations

import math

import torch

from harness import neighbours
from harness.reference import G_NEWTON, SOFTENING_SQUARED, round_bf16


def taper(q: torch.Tensor) -> torch.Tensor:
    q = q.clamp(0.0, 1.0)
    return q * q * q * (q * (q * 6.0 - 15.0) + 10.0)


class P3M:
    """P3M accelerations of one configuration, in ``dtype``; ``bf16``
    rounds the pair deltas, the density, the spectra and the force grids
    through bfloat16 (the control)."""

    def __init__(self, grid: int, cutoff_cells: int, dtype=torch.float64,
                 bf16: bool = False):
        self.ng = int(grid)
        self.nc, self.sub = neighbours.cell_grid(self.ng, int(cutoff_cells))
        self.dtype = dtype
        self.low = round_bf16 if bf16 else (lambda x: x)

    # Frozen at each block's entry: the box, r_c^2 and the kernel spectra.
    def block_env(self, pos, mass) -> dict:
        ng, m = self.ng, 2 * self.ng
        lo_box, hi_box = neighbours.robust_box(pos, mass)
        span = hi_box - lo_box
        h = (span / (ng - 3))[:, 0]
        rc2 = neighbours.cutoff_squared(span, self.nc, self.sub)
        idx = torch.arange(m, device=pos.device)
        d = torch.where(idx < ng, idx, idx - m).to(self.dtype)
        r = [(d * h[0])[:, None, None], (d * h[1])[None, :, None],
             (d * h[2])[None, None, :]]
        r2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
        u = torch.rsqrt(r2 + SOFTENING_SQUARED)
        u3 = u * u * u
        comp = u3 * (1.0 - taper(r2 / rc2))
        jt = torch.minimum(idx, m - idx).to(self.dtype)
        x = math.pi * jt / m
        sinc = torch.where(jt == 0, torch.ones_like(x), torch.sin(x) / x)
        inv = 1.0 / sinc.clamp_min(1e-3) ** 4
        w = (inv[:, None, None] * inv[None, :, None]
             * inv[: m // 2 + 1][None, None, :])
        long_hat = [self.low(torch.fft.rfftn(ra * (u3 - comp)) * w)
                    for ra in r]
        return dict(lo_box=lo_box, hi_box=hi_box, span=span, h=h, rc2=rc2,
                    long_hat=long_hat)

    def _corners(self, pos, lo, h):
        ng = self.ng
        g = ((pos - lo) * (1.0 / h[:, None])).clamp(0.0, ng - 1.0)
        i0 = torch.floor(g).clamp(0, ng - 2)
        frac = (g - i0).clamp(0.0, 1.0)
        i0 = i0.long()
        for cx in (0, 1):
            wx = frac[0] if cx else 1.0 - frac[0]
            for cy in (0, 1):
                wy = frac[1] if cy else 1.0 - frac[1]
                for cz in (0, 1):
                    wz = frac[2] if cz else 1.0 - frac[2]
                    flat = ((i0[0] + cx) * ng + i0[1] + cy) * ng + i0[2] + cz
                    yield flat, wx * wy * wz

    def _deposit_hat(self, corners, mass):
        ng, m = self.ng, 2 * self.ng
        rho = torch.zeros(ng ** 3, dtype=self.dtype, device=mass.device)
        for flat, w in corners:
            rho.index_add_(0, flat, mass * w)
        return torch.fft.rfftn(self.low(rho).view(ng, ng, ng), s=(m, m, m))

    def _field(self, specs, corners):
        ng, m = self.ng, 2 * self.ng
        grids = self.low(torch.stack([
            -torch.fft.irfftn(s, s=(m, m, m))[:ng, :ng, :ng].reshape(-1)
            for s in specs]))
        out = None
        for flat, w in corners:
            term = w * grids[:, flat]
            out = term if out is None else out + term
        return out

    def _short_range(self, pos, mass, members, env):
        """The complement summed exactly over every pair of members inside
        r_c (it is exactly 0 from r_c on), each pair once, with its
        reaction."""
        acc = torch.zeros_like(pos)
        rc2 = env["rc2"]
        for i, j, d, _ in neighbours.near_pairs(
                pos, members, env["lo_box"], env["span"], self.nc, self.sub,
                rc2):
            self._pair_sum(acc, mass, i, j, d, rc2)
        return acc

    def _pair_sum(self, acc, mass, i, j, d, rc2):
        """Add the complement of the pairs (i, j), d = x_j - x_i, to
        ``acc`` (3, N), each with its reaction."""
        d = self.low(d)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        u = torch.rsqrt(r2 + SOFTENING_SQUARED)
        w = (1.0 - taper(r2 / rc2)) * (u * u * u)
        acc.index_add_(1, i, d * (w * mass[j]))
        acc.index_add_(1, j, d * (-w * mass[i]))
        return acc

    def accel(self, pos, mass, env) -> torch.Tensor:
        lo_box, hi_box, h = env["lo_box"], env["hi_box"], env["h"]
        inside = ((pos >= lo_box) & (pos <= hi_box)).all(0)
        m_in = torch.where(inside, mass, 0.0)
        corners = list(self._corners(pos, lo_box - h[:, None], h))
        rho_hat = self._deposit_hat(corners, m_in)
        acc = self._field([rho_hat * lh for lh in env["long_hat"]], corners)
        members = neighbours.in_box(pos, mass, lo_box, hi_box)
        acc = acc + torch.where(members[None, :],
                                self._short_range(pos, mass, members, env),
                                0.0)
        # Far field.
        tiny = 1e-30
        m_tot = m_in.sum()
        com = (pos * m_in).sum(1, keepdim=True) / m_tot.clamp_min(tiny)
        acc = torch.where(inside[None, :], acc, monopole(pos, m_tot, com))
        m_out = mass - m_in
        ctr = 0.5 * (lo_box + hi_box)
        side = (pos > ctr).long()
        octant = side[0] * 4 + side[1] * 2 + side[2]
        for k in range(8):
            m_k = torch.where(octant == k, m_out, 0.0)
            mk = m_k.sum()
            com_k = (pos * m_k).sum(1, keepdim=True) / mk.clamp_min(tiny)
            acc = acc + monopole(pos, mk, com_k)
        return G_NEWTON * acc


def monopole(pos, m_tot, com):
    d = com - pos
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFTENING_SQUARED
    u = torch.rsqrt(r2)
    return m_tot * d * (u * u * u)


def forces(config: dict, mass: torch.Tensor, dtype=torch.float64,
           control: bool = False):
    """For each block's entry positions, the block's force function (the
    box and spectra frozen there, as the program freezes them)."""
    p3m = P3M(config["grid"], config["cutoff_cells"], dtype=dtype,
              bf16=control)

    def block(entry):
        env = p3m.block_env(entry, mass)
        return lambda pos: p3m.accel(pos, mass, env)

    return block
