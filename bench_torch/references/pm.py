"""Plain particle-mesh (PM) gravity, open boundary, as the program's mesh
tier defines it with no short-range split (ng mesh points an axis), written
from the method (Hockney and Eastwood 1988) and not from the program:

* the mesh box (``harness/neighbours.robust_box``), frozen with the kernel
  spectra at each block's entry: spacing h = span / (ng - 3) an axis, the
  grid's origin one spacing below the box;
* the mesh: the masses inside the box deposited by cloud-in-cell on the
  ng^3 points, each cell's contributions summed by one accumulating
  ``index_put_`` (sorted, no atomics, no fixed point); the softened kernel
  d (|d|^2 + eps^2)^(-3/2) sampled at the signed wraparound displacements
  of the doubled (2 ng)^3 grid, with no window division, no taper and no
  split; ``rfftn``, the three products, ``irfftn``, the [:ng]^3 corner
  kept and negated; a cloud-in-cell gather at each body;
* outside the box: a body feels the in-box mass as one point, and the mass
  outside the box acts as one point per octant around the box centre on
  every body (``references/p3m.monopole``).

Departures from the program: everything runs in float64, the box, the
spacing and the spectra included, where the program works in float32; the
density sums each cell's float64 contributions in one sorted pass, where
the program's deposit kernel (``csrc/deposit.cu``) sums the float32
contributions in 64-bit fixed point and rounds each cell to float32.

The control (``control=True``) runs in float32 and rounds the deposited
density, the kernel spectra and the force grids through bfloat16
(PyTorch has no bfloat16 transform, so the FFTs run in float32 between the
roundings).
"""

from __future__ import annotations

import torch

from harness import neighbours
from harness.reference import G_NEWTON, SOFTENING_SQUARED, round_bf16
from references.p3m import monopole


class PM:
    """Plain PM accelerations of one configuration, in ``dtype``; ``bf16``
    rounds the density, the spectra and the force grids through bfloat16
    (the control)."""

    def __init__(self, grid: int, dtype=torch.float64, bf16: bool = False):
        self.ng = int(grid)
        self.dtype = dtype
        self.low = round_bf16 if bf16 else (lambda x: x)

    # Frozen at each block's entry: the box and the kernel spectra.
    def block_env(self, pos, mass) -> dict:
        ng, m = self.ng, 2 * self.ng
        lo_box, hi_box = neighbours.robust_box(pos, mass)
        h = ((hi_box - lo_box) / (ng - 3))[:, 0]
        idx = torch.arange(m, device=pos.device)
        d = torch.where(idx < ng, idx, idx - m).to(self.dtype)
        r = [(d * h[0])[:, None, None], (d * h[1])[None, :, None],
             (d * h[2])[None, None, :]]
        u = torch.rsqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
                        + SOFTENING_SQUARED)
        u3 = u * u * u
        spectra = [self.low(torch.fft.rfftn(ra * u3)) for ra in r]
        return dict(lo_box=lo_box, hi_box=hi_box, h=h, spectra=spectra)

    def _corners(self, pos, lo, h) -> list:
        """The 8 cloud-in-cell corners on the flat ng^3 grid: (flat index,
        weight)."""
        ng = self.ng
        g = ((pos - lo) / h[:, None]).clamp(0.0, ng - 1.0)
        i0 = torch.floor(g).clamp(0, ng - 2)
        frac = (g - i0).clamp(0.0, 1.0)
        i0 = i0.long()
        out = []
        for cx in (0, 1):
            wx = frac[0] if cx else 1.0 - frac[0]
            for cy in (0, 1):
                wy = frac[1] if cy else 1.0 - frac[1]
                for cz in (0, 1):
                    wz = frac[2] if cz else 1.0 - frac[2]
                    out.append((((i0[0] + cx) * ng + i0[1] + cy) * ng
                                + i0[2] + cz, wx * wy * wz))
        return out

    def _density(self, corners, mass):
        ng = self.ng
        rho = torch.zeros(ng ** 3, dtype=self.dtype, device=mass.device)
        rho.index_put_((torch.cat([flat for flat, _ in corners]),),
                       torch.cat([mass * w for _, w in corners]),
                       accumulate=True)
        return self.low(rho).view(ng, ng, ng)

    def _grids(self, rho, spectra):
        ng, m = self.ng, 2 * self.ng
        rho_hat = torch.fft.rfftn(rho, s=(m, m, m))
        return self.low(torch.stack([
            -torch.fft.irfftn(rho_hat * s, s=(m, m, m))[:ng, :ng, :ng]
            .reshape(-1) for s in spectra]))

    def accel(self, pos, mass, env) -> torch.Tensor:
        lo_box, hi_box, h = env["lo_box"], env["hi_box"], env["h"]
        inside = ((pos >= lo_box) & (pos <= hi_box)).all(0)
        m_in = torch.where(inside, mass, 0.0)
        corners = self._corners(pos, lo_box - h[:, None], h)
        grids = self._grids(self._density(corners, m_in), env["spectra"])
        acc = None
        for flat, w in corners:
            term = w * grids[:, flat]
            acc = term if acc is None else acc + term
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


def forces(config: dict, mass: torch.Tensor, dtype=torch.float64,
           control: bool = False):
    """For each block's entry positions, the block's force function (the
    box and spectra frozen there, as the program freezes them).  Nothing of
    it may run in TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pm = PM(config["grid"], dtype=dtype, bf16=control)

    def block(entry):
        env = pm.block_env(entry, mass)
        return lambda pos: pm.accel(pos, mass, env)

    return block
