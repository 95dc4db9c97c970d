"""The port's plain particle-mesh solver (``pm``, open boundary) against the
benchmark's plain PM reference (``bench_torch/references/pm.py``) on the
CPU at small sizes: the force in float64 against the port's float32, with
the box and spectra made from the state and frozen at a block's entry;
the reference against the direct softened sum where every pair lies more
than 8 mesh cells apart, and its momentum; the control (the reference in
float32 with bfloat16 roundings) outside the tolerance the port meets; and
the least time that ``deposit_roofline`` divides by."""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_torch")
sys.path.insert(0, BENCH)

from harness import ics, neighbours, reference  # noqa: E402
from harness.reference import G_NEWTON, SOFTENING_SQUARED  # noqa: E402
from nbody_tpu_torch.ops import pm  # noqa: E402

REF = reference.solver("pm")

# The port's float32 against the float64 reference, relative L2 over all
# bodies.  Uniform states: float32 rounding of the positions against the
# cell (the CIC weights), of the sampled kernel and of the (2 ng)^3
# transforms; where outliers pull the box off the exact extent, the port's
# box quantiles interpolate in float32 too.  The readings sit at 1.4e-7 to
# 8.0e-7.  Plummer: the box is the quantiles' on every axis, and the
# float32 interpolation moves it by ~1e-6 of its span, which shifts every
# CIC weight against the steep field of the core, and a body within that
# distance of a face takes the monopole in one and the mesh in the other.
# The readings sit at 1.1e-6 to 7.0e-6.
PORT_TOL = {"uniform": 2e-6, "outliers": 2e-6, "plummer": 2e-5}

# The reference against the direct softened sum, every pair more than 8
# cells apart on some axis: the CIC assignment and interpolation smooth
# and make anisotropic the mesh's force at a few cells (Hockney and
# Eastwood 1988, ch. 5), and what is left at 8 cells reads 0.07-0.15% in
# L2 and at most 1.2% on one body at grid 32 and 64.
FAR_TOL = 5e-3
FAR_BODY_TOL = 3e-2
FAR_CELLS = 8


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def state(kind: str, n: int, seed: int):
    """(pos, mass) float32: the upstream's uniform cube, a Plummer sphere,
    or the cube with one body in 64 thrown out past its faces."""
    dist = "plummer" if kind == "plummer" else "reference"
    pos, _, mass = ics.make(dist, n, seed)
    pos, mass = torch.from_numpy(pos), torch.from_numpy(mass)
    if kind == "outliers":
        g = torch.Generator().manual_seed(seed)
        k = n // 64
        pos = pos.clone()
        pos[:, :k] = (0.5 + 3.0 * (pos[:, :k] - 0.5)
                      + torch.randn(3, k, generator=g))
    return pos, mass


# (distribution, N, grid): both reaches of the kernel sampling against the
# box, N from 512 to 4096.
CASES = [("uniform", 4096, 16), ("uniform", 2048, 32),
         ("plummer", 4096, 16), ("plummer", 2048, 32),
         ("outliers", 4096, 16), ("outliers", 512, 32)]


def outside(pos, mass) -> int:
    """Bodies outside the reference's robust box."""
    lo, hi = neighbours.robust_box(pos.double(), mass.double())
    p = pos.double()
    return int((~((p >= lo) & (p <= hi)).all(0)).sum())


def reference_accel(pos, mass, grid: int, entry=None, control=False):
    """The reference's force at ``pos``, its box and spectra made at
    ``entry`` (default ``pos``)."""
    entry = pos if entry is None else entry
    if control:
        r = REF.PM(grid, dtype=torch.float32, bf16=True)
        return r.accel(pos, mass, r.block_env(entry, mass)).double()
    r = REF.PM(grid)
    m = mass.double()
    return r.accel(pos.double(), m, r.block_env(entry.double(), m))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-n{c[1]}-g{c[2]}")
def test_port_meets_the_reference(case):
    kind, n, grid = case
    pos, mass = state(kind, n, 3)
    if kind != "uniform":
        assert outside(pos, mass) > 0
    got = pm.accelerations(pos, mass, grid).double()
    assert rel(got, reference_accel(pos, mass, grid)) < PORT_TOL[kind]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-n{c[1]}-g{c[2]}")
def test_frozen_env_meets_the_reference(case):
    """As the engine steps: the box and spectra of the block's entry
    (``make_mesh_env``), the force at positions moved since."""
    kind, n, grid = case
    pos, mass = state(kind, n, 3)
    g = torch.Generator().manual_seed(1)
    moved = pos + 0.01 * pos.std() * torch.randn(pos.shape, generator=g)
    env = pm.make_mesh_env(pos, mass, grid=grid)
    got = pm.accelerations(moved, mass, grid, mesh_env=env).double()
    want = reference_accel(moved, mass, grid, entry=pos)
    assert rel(got, want) < PORT_TOL[kind]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-n{c[1]}-g{c[2]}")
def test_control_fails_the_ports_tolerance(case):
    """Float32 with the density, the spectra and the force grids rounded
    through bfloat16 reads ~1e-3: outside every tolerance the port meets."""
    kind, n, grid = case
    pos, mass = state(kind, n, 3)
    want = reference_accel(pos, mass, grid)
    ctl = reference_accel(pos, mass, grid, control=True)
    assert rel(ctl, want) > 10 * max(PORT_TOL.values())


def direct(pos, mass):
    """The softened all-pairs sum, float64."""
    d = pos[:, None, :] - pos[:, :, None]  # d[:, i, j] = x_j - x_i
    r2 = (d * d).sum(0) + SOFTENING_SQUARED
    return G_NEWTON * (d * (mass[None, None, :] * r2 ** -1.5)).sum(2)


def separated(grid: int, seed: int, k: int = 48):
    """Up to ``k`` bodies in the unit cube, every pair more than
    ``FAR_CELLS`` mesh cells apart on some axis (with 5% to spare on the
    spacing, span / (ng - 3) with the span at most 1)."""
    rng = np.random.default_rng(seed)
    sep = FAR_CELLS / (grid - 3) * 1.05
    pts = []
    for _ in range(200000):
        x = rng.random(3)
        if all(np.abs(x - q).max() > sep for q in pts):
            pts.append(x)
            if len(pts) == k:
                break
    pos = torch.tensor(np.array(pts).T)
    mass = torch.tensor(rng.random(len(pts)) + 0.5) * 1e9
    return pos, mass


@pytest.mark.parametrize("grid,seed", [(32, 0), (32, 1), (64, 0), (64, 2)])
def test_reference_meets_the_direct_sum_far_apart(grid, seed):
    pos, mass = separated(grid, seed)
    r = REF.PM(grid)
    env = r.block_env(pos, mass)
    cells = ((pos[:, None, :] - pos[:, :, None]).abs()
             / env["h"][:, None, None]).amax(0)
    cells = cells + torch.eye(pos.shape[1]) * 2 * FAR_CELLS
    assert pos.shape[1] >= 24 and float(cells.min()) > FAR_CELLS
    got, want = r.accel(pos, mass, env), direct(pos, mass)
    assert rel(got, want) < FAR_TOL
    assert float(((got - want).norm(dim=0) / want.norm(dim=0)).max()) \
        < FAR_BODY_TOL


@pytest.mark.parametrize("grid", [16, 32])
def test_reference_conserves_momentum(grid):
    """Every body inside the box: the mesh force is a convolution with an
    odd kernel, deposited and interpolated by the same weights, so the
    total force sums to 0 up to float64 round-off."""
    pos, mass = state("uniform", 4096, 5)
    assert outside(pos, mass) == 0
    p, m = pos.double(), mass.double()
    r = REF.PM(grid)
    acc = r.accel(p, m, r.block_env(p, m))
    net = (acc * m).sum(1).norm() / (acc.norm(dim=0) * m).sum()
    assert float(net) < 1e-13


def test_deposit_roofline_least_time():
    """One deposit at N=1048576 on 128^3: 16 B a body read and 4 B a grid
    point written, 25,165,824 B at 3.35 TB/s, 7.512 us."""
    path = os.path.join(BENCH, "metrics", "deposit_roofline.py")
    spec = importlib.util.spec_from_file_location("deposit_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    least = mod.least_seconds(1048576, 128)
    assert least == pytest.approx((16 * 1048576 + 4 * 128 ** 3) / 3.35e12,
                                  rel=1e-12)
    assert least == pytest.approx(7.512e-6, abs=1e-9)
