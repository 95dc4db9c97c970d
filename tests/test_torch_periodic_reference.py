"""The port's periodic P3M against the benchmark's plain periodic reference
(``bench_torch/references/p3m_periodic.py``) on the CPU at small sizes:
the force in float64 against the port's float32, in the branch where every
body bins and in the one where cells overflow; the reference's short range
against a brute-force minimum-image sum; its total against an independent
k-space sum; the yardstick's pair count against brute force; and the
control (the reference in float32 with bfloat16 roundings) outside the
tolerance the port meets."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_torch")
sys.path.insert(0, BENCH)

from chip_smoke import corner_blob, kspace_sum  # noqa: E402
from harness import ics, reference  # noqa: E402
from harness import periodic_neighbours as pn  # noqa: E402
from nbody_tpu_torch.models.gravity import make_accel_fn  # noqa: E402
from nbody_tpu_torch.ops import pm  # noqa: E402

REF = reference.solver("p3m_periodic")
BOX = dict(boundary="periodic", box_size=1.0)
# The port's float32 against the float64 reference, relative L2 over all
# bodies: float32 rounding of the positions (2^-24 of x ~ 0.5 against
# separations of r_c / 10), of the ng^3 transforms and of the short-range
# sums, and the spectra's float32 Bessel polynomial (absolute error under
# 2.2e-7).  The readings below sit at 0.9e-7 to 3.3e-7.
PORT_TOL = 2e-6


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def uniform(n: int, seed: int):
    pos, _, mass = ics.make("reference", n, seed)
    return pos, mass


def states():
    """(name, pos, mass, grid): the upstream's uniform cube (every body
    near a face makes images) and a Gaussian blob wrapped round a box
    corner (pairs cross one, two and three faces), at a 2-cell reach
    (grid 16) and a 1-cell one (grid 32, n = 2048)."""
    return [("uniform", *uniform(4096, 3), 16),
            ("uniform", *uniform(2048, 8), 32),
            ("corner blob", *corner_blob(2048, 5), 16),
            ("corner blob", *corner_blob(2048, 5), 32)]


def reference_accel(pos, mass, grid: int, control: bool = False):
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    if control:
        return REF.PeriodicP3M(grid, 4, 1.0, "cpu", dtype=torch.float32,
                               bf16=True).accel(p, m).double()
    return REF.PeriodicP3M(grid, 4, 1.0, "cpu").accel(p.double(), m.double())


@pytest.mark.parametrize("case", range(4))
def test_port_meets_the_reference(case):
    """Through the registry (``make_accel_fn``) at the plan the engine
    measures: every body and image binned, the exact short range."""
    _, pos, mass, grid = states()[case]
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    plan = pm.suggest_sr_plan(p, m, grid, 4, **BOX)
    assert float(pm.cell_overflow_fraction(p, m, grid, 4, plan["capacity"],
                                           **BOX)) == 0.0
    got = make_accel_fn("p3m", grid=grid, **plan, **BOX)(p, m).double()
    want = reference_accel(pos, mass, grid)
    assert rel(got, want) < PORT_TOL
    # The reference wraps inside the force: whole boxes change nothing.
    shift = torch.from_numpy(np.random.default_rng(case).integers(
        -3, 4, pos.shape)).double()
    moved = REF.PeriodicP3M(grid, 4, 1.0, "cpu").accel(
        p.double() + shift, m.double())
    assert torch.equal(moved, want)


@pytest.mark.parametrize("case", [0, 2])
def test_overflow_branch_degrades_to_the_mesh(case):
    """At a quarter of the largest cell's bodies a capacity, the
    overflowed bodies keep mesh-quality forces (the complement field):
    the port leaves the reference by far more than float32 does, and by
    less than plain periodic PM on the same grid, which has no short range
    at all."""
    _, pos, mass, grid = states()[case]
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    geom, _, cid, _ = pm._plan_bin(p, m, grid, 4, **BOX)
    cap = int(pm._cid_counts(cid, geom.nc ** 3).max()) // 4
    assert float(pm.cell_overflow_fraction(p, m, grid, 4, cap, **BOX)) > 0.1
    plan = pm.suggest_sr_plan(p, m, grid, 4, capacity=cap, **BOX)
    want = reference_accel(pos, mass, grid)
    over = rel(pm.accelerations(p, m, grid=grid, cutoff_cells=4, **plan,
                                **BOX).double(), want)
    plain = rel(pm.accelerations(p, m, grid=grid, **BOX).double(), want)
    assert 1e3 * PORT_TOL < over < plain


@pytest.mark.parametrize("grid", [16, 32])
def test_short_range_against_brute_force(grid):
    """The reference's pair search (a cell search that wraps round the
    box) against every minimum-image pair at N=512, in float64: the same
    pairs, summed in another order."""
    pos, mass = (torch.from_numpy(a).double() for a in uniform(512, 21))
    ref = REF.PeriodicP3M(grid, 4, 1.0, "cpu")
    pos_w = pn.wrap(pos, 1.0)
    got = ref._short_range(pos_w, mass)
    d = pn.min_image(pos_w[:, None, :] - pos_w[:, :, None], 1.0)  # x_j - x_i
    r2 = (d * d).sum(0)
    u = torch.rsqrt(r2 + reference.SOFTENING_SQUARED)
    w = torch.where(r2 < ref.rc2, (1.0 - REF.taper(r2 / ref.rc2)) * u ** 3,
                    0.0)
    w.fill_diagonal_(0.0)
    want = (d * (w * mass[None, :])).sum(2)
    assert float((w > 0).sum()) > 0
    assert rel(got, want) < 1e-12


@pytest.mark.parametrize("grid,bound", [(32, 2.5e-2), (64, 1.5e-2)])
def test_reference_against_a_kspace_sum(grid, bound):
    """The reference's whole force against the direct Fourier-series sum
    of the softened periodic force (``chip_smoke.kspace_sum``, fp64, an
    independent ground truth) on the corner blob: within P3M's own error
    at this grid, the bounds tests/test_torch_periodic.py holds the port
    to, and three times below plain periodic PM's."""
    pos, mass = corner_blob(96, 5)
    truth = torch.from_numpy(kspace_sum(pos, mass, 1.0))
    err = rel(reference_accel(pos, mass, grid), truth)
    plain = rel(pm.accelerations(torch.from_numpy(pos),
                                 torch.from_numpy(mass), grid=grid,
                                 **BOX).double(), truth)
    assert err < bound and err < plain / 3


@pytest.mark.parametrize("grid,n,blob", [(16, 512, False), (64, 2048, False),
                                         (32, 1024, True)])
def test_pair_count_against_brute_force(grid, n, blob):
    """``sr_periodic_roofline``'s pairs: the unordered minimum-image pairs
    inside r_c, counted by the wrapped cell search, equal brute force."""
    pos, mass = corner_blob(n, 4) if blob else uniform(n, 13)
    p = torch.from_numpy(pos)
    got, bodies = pn.sr_pairs(p, torch.from_numpy(mass), grid, 4, 1.0)
    _, _, rc = pn.cutoff(grid, 4, 1.0)
    pos_w = pn.wrap(p.double(), 1.0)
    d = pn.min_image(pos_w[:, None, :] - pos_w[:, :, None], 1.0)
    r2 = (d * d).sum(0)
    want = int(torch.triu(r2 < rc * rc, diagonal=1).sum())
    assert got == want > 0 and bodies == n


@pytest.mark.parametrize("case", range(4))
def test_control_fails_the_ports_tolerance(case):
    """The control, the reference in float32 with its pair deltas,
    density, spectra and force grids rounded through bfloat16, leaves the
    float64 reference by over a hundred times the port's tolerance."""
    _, pos, mass, grid = states()[case]
    err = rel(reference_accel(pos, mass, grid, control=True),
              reference_accel(pos, mass, grid))
    assert err > 100 * PORT_TOL
