"""The plain reference against the program on the CPU at small sizes, and
the control against the cells' limits at a size a test run can hold."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import cells

import control  # noqa: E402  (bench_torch/control.py)
from harness import ics, reference  # noqa: E402

DIRECT = reference.solver("direct")
P3M = reference.solver("p3m")


@pytest.mark.parametrize("dist,n,seed", [
    ("reference", 1000, 42), ("reference", 777, 2 ** 31 + 9),
    ("plummer", 5000, 2 ** 32 + 1)])
def test_initial_conditions_equal_the_programs(dist, n, seed):
    from nbody_tpu_torch.models.distributions import make_arrays

    for a, b in zip(ics.make(dist, n, seed), make_arrays(dist, n, seed=seed)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dist,n,tol", [
    ("reference", 2000, 1e-12),
    # Outliers at |x| ~ 100: the expansion's rounding grows with |x|^2.
    ("plummer", 300, 1e-8)])
def test_direct_against_pair_differences(dist, n, tol):
    pos, _, mass = (torch.from_numpy(a).double()
                    for a in ics.make(dist, n, 4))
    got = DIRECT.direct_accel(pos, mass, rows=128)
    d = pos[:, None, :] - pos[:, :, None]
    r2 = (d * d).sum(0) + reference.SOFTENING_SQUARED
    want = reference.G_NEWTON * (d * (mass[None, :] * r2 ** -1.5)).sum(2)
    gap = (got - want).norm(dim=0) / want.norm(dim=0)
    assert float(gap.max()) < tol


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dist,n,grid", [
    ("plummer", 6000, 32),     # sub 1
    ("plummer", 6000, 16),     # sub 2: ng / cutoff under 24
    ("reference", 8192, 32)])
def test_p3m_against_the_program(dist, n, grid):
    """At the configurations' capacity every body is binned, and the
    program's float32 accelerations meet the float64 reference's."""
    from nbody_tpu_torch.ops import pm

    capacity = cells.spec.load("p3m-plummer-n262144").config["program"][
        "pm_capacity"]
    p32, _, m32 = (torch.from_numpy(a) for a in ics.make(dist, n, 5))
    assert float(pm.cell_overflow_fraction(p32, m32, grid, 4,
                                           capacity)) == 0.0
    plan = pm.suggest_sr_plan(p32, m32, grid, 4, capacity=capacity)
    env = pm.make_mesh_env(p32, m32, grid=grid, cutoff_cells=4)
    prog = pm.p3m_accelerations(p32, m32, grid=grid, cutoff_cells=4,
                                mesh_env=env, **plan).double()
    ref = P3M.P3M(grid, 4)
    p, m = p32.double(), m32.double()
    want = ref.accel(p, m, ref.block_env(p, m))
    ctl = P3M.P3M(grid, 4, dtype=torch.float32, bf16=True)
    err_ctl = rel(ctl.accel(p32, m32, ctl.block_env(p32, m32)).double(), want)
    err = rel(prog, want)
    assert err < 1e-6
    assert err_ctl > 4 * err


@pytest.mark.parametrize("workload", sorted(cells.TINY))
def test_control_fails_where_the_program_passes(workload, monkeypatch):
    cells.one_segment(monkeypatch)
    cell = cells.tiny(workload)
    r = control.readings(cell, 2 ** 31 + 3, 1.0, platform="cpu")
    limits = cell.check["limits"]
    assert all(r["program"][k] <= v["limit"] for k, v in limits.items()), r
    assert any(not r["control"][k] <= v["limit"]
               for k, v in limits.items()), r
