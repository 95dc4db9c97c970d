"""P3M in a periodic cubic box of edge L (the configuration's ``box``), as
the program's periodic mesh tier defines it (ng mesh points an axis across
the box, a split radius of ``cutoff_cells`` mesh cells), written from the
method (Hockney and Eastwood 1988, ch. 8) and not from the program:

* the state is never wrapped; the force wraps positions into [0, L);
* the long range: the masses deposited by cloud-in-cell on the ng^3 grid
  of spacing h = L / ng, the upper corners wrapped round the box; the
  forward transform; each force component's spectrum multiplied by
  C_j = (i k_j phi_hat + s_hat_j) W, where phi_hat = 4 pi g(eps |k|) / k^2
  / h^3 is the transform of the softened potential 1 / sqrt(r^2 + eps^2)
  over the grid's cell volume (g(x) = x K1(x)), its k = 0 mode dropped (the
  uniform background subtracted); s_hat_j is the transform of the
  complement kernel d_j (1 - S(r^2 / r_c^2)) u^3, u = (r^2 + eps^2)^-1/2,
  sampled at the grid's minimum-image displacements (S the smoothstep
  taper q^3 (6 q^2 - 15 q + 10) in q = r^2 / r_c^2); W the inverse squared
  cloud-in-cell window (sinc^4 per axis, sinc at least 1e-3); k_j's
  Nyquist entry zeroed on its own axis, as a force factor of a real field;
  then the inverse transform and a wrapped cloud-in-cell gather;
* the short range: the complement kernel summed exactly over every
  minimum-image pair closer than r_c = sub L / nc (the program's cell-grid
  rule), each pair once with its reaction, found by a cell search that
  wraps round the box (``harness/periodic_neighbours.py``), not from ghost
  images.  Every body is binned: the configuration's cell capacity bins
  every body and image (the program's plan health check reads no
  overflow), so no pair falls back to the mesh.

Departures from the program: g is ``torch.special.modified_bessel_k1``
in float64, where the program evaluates Abramowitz and Stegun's
polynomials in float32 (absolute error under 2.2e-7); everything runs in
float64, the wavenumbers and h included, where the program rounds 2 pi / L
and L / ng to float32; the spectra are made once, as constants of the box,
where the program makes them once a run; the pairs come from minimum images
rather than ghost images, and sum in another order.

The control (``control=True``) runs in float32 and rounds every
short-range pair delta, the deposited density, the spectra and the force
grids through bfloat16 (the transforms run in float32 between the
roundings).
"""

from __future__ import annotations

import math

import torch

from harness import periodic_neighbours as pn
from harness.reference import G_NEWTON, SOFTENING_SQUARED, round_bf16

def taper(q: torch.Tensor) -> torch.Tensor:
    q = q.clamp(0.0, 1.0)
    return q * q * q * (q * (q * 6.0 - 15.0) + 10.0)


class PeriodicP3M:
    """Periodic P3M accelerations of one configuration, in ``dtype``;
    ``bf16`` rounds the pair deltas, the density, the spectra and the force
    grids through bfloat16 (the control)."""

    def __init__(self, grid: int, cutoff_cells: int, box: float, device,
                 dtype=torch.float64, bf16: bool = False):
        self.ng, self.box = int(grid), float(box)
        self.nc, self.sub, rc = pn.cutoff(self.ng, int(cutoff_cells),
                                          self.box)
        self.rc2 = rc * rc
        self.dtype = dtype
        self.low = round_bf16 if bf16 else (lambda x: x)
        self.spectra = self._spectra(device)

    def _spectra(self, device) -> list:
        """The three C_j half spectra (ng, ng, ng // 2 + 1)."""
        ng, box, dt = self.ng, self.box, self.dtype
        h = box / ng
        two_pi = 2.0 * math.pi
        k_full = two_pi * torch.fft.fftfreq(ng, d=h, dtype=dt, device=device)
        k_half = two_pi * torch.fft.rfftfreq(ng, d=h, dtype=dt, device=device)
        kx, ky, kz = (k_full[:, None, None], k_full[None, :, None],
                      k_half[None, None, :])
        k2 = kx * kx + ky * ky + kz * kz
        kk = torch.sqrt(k2)
        x = math.sqrt(SOFTENING_SQUARED) * kk
        g = x * torch.special.modified_bessel_k1(x.clamp_min(1e-30))
        phi = torch.where(k2 > 0, 4.0 * math.pi * g
                          / k2.clamp_min(1e-30) / h ** 3, 0.0)
        # The complement kernel at the minimum-image grid displacements;
        # the ambiguous L / 2 point lies beyond r_c, where it is 0.
        idx = torch.arange(ng, device=device)
        d = torch.where(idx <= ng // 2, idx, idx - ng).to(dt) * h
        r = [d[:, None, None], d[None, :, None], d[None, None, :]]
        r2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
        u = torch.rsqrt(r2 + SOFTENING_SQUARED)
        comp = (1.0 - taper(r2 / self.rc2)) * (u * u * u)
        jt = torch.minimum(idx, ng - idx).to(dt)
        xs = math.pi * jt / ng
        sinc = torch.where(jt == 0, torch.ones_like(xs), torch.sin(xs) / xs)
        inv = 1.0 / sinc.clamp_min(1e-3) ** 4
        w = (inv[:, None, None] * inv[None, :, None]
             * inv[: ng // 2 + 1][None, None, :])
        nyq = ng // 2 if ng % 2 == 0 else None
        out = []
        for axis, (ka, ra) in enumerate(zip((kx, ky, kz), r)):
            if nyq is not None:
                # k_j's Nyquist entry, on its own axis only.
                keep = torch.ones(ka.shape[axis], dtype=dt, device=device)
                keep[nyq] = 0.0
                ka = ka * keep.view(ka.shape)
            s_hat = torch.fft.rfftn(ra * comp)
            out.append(self.low(torch.complex(torch.zeros_like(phi),
                                              ka * phi) * w + s_hat * w))
        return out

    def _corners(self, pos_w):
        """The 8 wrapped cloud-in-cell corners: (flat index, weight)."""
        ng = self.ng
        g = pos_w * (ng / self.box)
        i0 = torch.floor(g)
        frac = g - i0
        i0 = i0.long()
        for cx in (0, 1):
            wx = frac[0] if cx else 1.0 - frac[0]
            ix = (i0[0] + cx) % ng
            for cy in (0, 1):
                wy = frac[1] if cy else 1.0 - frac[1]
                iy = (i0[1] + cy) % ng
                for cz in (0, 1):
                    wz = frac[2] if cz else 1.0 - frac[2]
                    iz = (i0[2] + cz) % ng
                    yield (ix * ng + iy) * ng + iz, wx * wy * wz

    def _long_range(self, pos_w, mass):
        ng = self.ng
        corners = list(self._corners(pos_w))
        rho = torch.zeros(ng ** 3, dtype=self.dtype, device=mass.device)
        for flat, w in corners:
            rho.index_add_(0, flat, mass * w)
        rho_hat = torch.fft.rfftn(self.low(rho).view(ng, ng, ng))
        grids = self.low(torch.stack([
            torch.fft.irfftn(rho_hat * c, s=(ng, ng, ng)).reshape(-1)
            for c in self.spectra]))
        out = None
        for flat, w in corners:
            term = w * grids[:, flat]
            out = term if out is None else out + term
        return out

    def _short_range(self, pos, mass):
        """The complement summed exactly over every minimum-image pair
        inside r_c, each pair once, with its reaction."""
        acc = torch.zeros_like(pos)
        for i, j, d, _ in pn.near_pairs(pos, mass > 0, self.box, self.nc,
                                        self.sub, self.rc2):
            d = self.low(d)
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            u = torch.rsqrt(r2 + SOFTENING_SQUARED)
            w = (1.0 - taper(r2 / self.rc2)) * (u * u * u)
            acc.index_add_(1, i, d * (w * mass[j]))
            acc.index_add_(1, j, d * (-w * mass[i]))
        return acc

    def accel(self, pos, mass) -> torch.Tensor:
        pos_w = pn.wrap(pos, self.box)
        acc = self._long_range(pos_w, mass) + self._short_range(pos_w, mass)
        return G_NEWTON * acc


def forces(config: dict, mass: torch.Tensor, dtype=torch.float64,
           control: bool = False):
    """For each block's entry positions, the block's force function: the
    box and the spectra are constants, so every block gets the same one.
    Nothing of it may run in TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p3m = PeriodicP3M(config["grid"], config["cutoff_cells"], config["box"],
                      mass.device, dtype=dtype, bf16=control)

    def block(entry):
        return lambda pos: p3m.accel(pos, mass)

    return block
