"""The fixed-point CIC deposit (``nbody_tpu_torch.ops.deposit_kernel``) on
the CPU: its plain version, which the card's kernel (``csrc/deposit.cu``)
equals bit for bit (tests/test_torch_cuda.py), and the mesh solver's
choice between it and ``pm._scatter``.

* ``deposit_plain`` against the float64 sum of ``_scatter``'s own float32
  contributions: within one float32 ulp plus n_c 2^-62 sum |m| a cell (n_c
  the cell's non-zero contributions, each rounded once to the fixed-point
  grid), open and periodic, with bodies clamped at both grid edges, bodies
  wrapped from outside the box, zero masses and masses over six decades.
* The same grid bit for bit under a permutation of the bodies: the
  integer sums and the scale (an exact sum |m|) do not depend on order.
* The dispatch: CPU tensors, and inputs that require grad, deposit through
  ``_scatter`` bit for bit, and the kernel's launch counter does not move.
"""

import math

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import deposit_kernel, pm

torch.set_num_threads(2)

NG = 32


def _masses(rng, n, kind):
    if kind == "decades":
        m = 10.0 ** rng.uniform(-6.0, 0.0, n)
        m[rng.random(n) < 0.1] = 0.0
        return m
    return 1.0 + rng.random(n)


def _case(name, n=4000, seed=0):
    """(pos, mass, kwargs of deposit_plain) of a named case."""
    rng = np.random.default_rng(seed)
    boundary, _, kind = name.partition(" ")
    if boundary == "periodic":
        box = float(kind)
        pos = rng.uniform(-box, 2.0 * box, (3, n))
        mass = _masses(rng, n, "decades")
        kw = dict(box=box)
    else:
        pos = rng.random((3, n))
        mass = _masses(rng, n, kind)
        if kind == "edges":  # past both grid edges (beyond the box's
            # quantiles, so the box leaves them out): clamped
            pos[:, :10] = -1e6 * (1.0 + rng.random((3, 10)))
            pos[:, 10:20] = 5.0 + rng.random((3, 10))
            pos[0, 20:25] = -1e6
            pos[2, 25:30] = 1e6
        lo_box, hi_box = pm._robust_box(torch.tensor(pos, dtype=torch.float32),
                                        torch.tensor(mass, dtype=torch.float32))
        mesh = pm._OpenMesh(NG, lo_box, hi_box)
        kw = dict(lo=mesh.lo, inv_h=mesh.inv_h)
    return (torch.tensor(pos, dtype=torch.float32),
            torch.tensor(mass, dtype=torch.float32), kw)


CASES = ["open uniform", "open edges", "open decades", "periodic 1.0",
         "periodic 0.7"]


@pytest.mark.parametrize("name", CASES)
def test_deposit_plain_is_the_float64_sum_of_scatters_terms(name):
    pos, mass, kw = _case(name)
    got = deposit_kernel.deposit_plain(pos, mass, NG, **kw).reshape(-1)
    ref = torch.zeros(NG ** 3, dtype=torch.float64)
    n_c = torch.zeros(NG ** 3, dtype=torch.float64)
    for flat, w in deposit_kernel._corners(pos, NG, **kw):
        v = mass * w
        ref.index_add_(0, flat.long(), v.double())
        n_c.index_add_(0, flat.long(), (v != 0).double())
    if name == "open edges":  # the clamped bodies fill the corner cells
        assert float(ref[0]) > 0 and float(ref[-1]) > 0
    ulp = torch.tensor(np.spacing(np.abs(ref.numpy()).astype(np.float32)),
                       dtype=torch.float64)
    tol = ulp + n_c * 2.0 ** -62 * float(mass.double().abs().sum())
    err = (got.double() - ref).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    assert float(ref.sum()) == pytest.approx(float(mass.double().sum()),
                                             rel=1e-6)


@pytest.mark.parametrize("name", ["open edges", "open decades",
                                  "periodic 0.7"])
def test_deposit_plain_is_order_free(name):
    pos, mass, kw = _case(name, seed=3)
    perm = torch.randperm(pos.shape[1], generator=torch.Generator()
                          .manual_seed(11))
    grid = deposit_kernel.deposit_plain(pos, mass, NG, **kw)
    again = deposit_kernel.deposit_plain(pos[:, perm].contiguous(),
                                         mass[perm].contiguous(), NG, **kw)
    assert torch.equal(grid, again)
    # The scale: 2^61 over sum |m|, the sum exact before its one rounding.
    total = math.fsum(abs(float(m)) for m in mass)
    assert deposit_kernel._mass_scale(mass[perm]) == \
        deposit_kernel._mass_scale(mass)
    assert deposit_kernel._mass_scale(mass) == pytest.approx(
        2.0 ** deposit_kernel.SCALE_BITS / total, rel=1e-15)


@pytest.mark.parametrize("grad", [False, True], ids=["cpu", "requires grad"])
@pytest.mark.parametrize("boundary", ["open", "periodic"])
def test_dispatch_keeps_scatter(boundary, grad):
    name = "open decades" if boundary == "open" else "periodic 1.0"
    pos, mass, kw = _case(name, n=1500, seed=5)
    pos.requires_grad_(grad)
    mass.requires_grad_(grad)
    before = deposit_kernel.launches
    if boundary == "open":
        got = pm._deposit(pos, mass, kw["lo"], kw["inv_h"], NG)
        want = pm._scatter(pm._corner_iter(*pm._cic_weights(
            pos, kw["lo"], kw["inv_h"], NG), NG), mass, NG)
    else:
        got = pm._deposit_periodic(pos, mass, kw["box"], NG)
        want = pm._scatter(pm._periodic_corners(pos, kw["box"], NG), mass, NG)
    assert deposit_kernel.launches == before
    assert got.requires_grad == grad
    assert torch.equal(got.detach(), want.detach())


@pytest.mark.parametrize("fault", ["nan position", "inf mass", "nan lo",
                                   "zero masses"])
def test_deposit_plain_non_finite_and_empty(fault):
    pos, mass, kw = _case("open uniform", n=500, seed=2)
    if fault == "nan position":
        pos[1, 17] = math.nan
    elif fault == "inf mass":
        mass[3] = math.inf
    elif fault == "nan lo":
        kw["lo"] = kw["lo"].clone()
        kw["lo"][2, 0] = math.nan
    else:
        mass.zero_()
    grid = deposit_kernel.deposit_plain(pos, mass, NG, **kw)
    if fault == "zero masses":
        assert torch.equal(grid, torch.zeros((NG, NG, NG)))
    else:
        assert bool(grid.isnan().all())


def test_deposit_on_the_cpu_is_the_plain_version():
    for name in ("open edges", "periodic 0.7"):
        pos, mass, kw = _case(name, n=800, seed=9)
        before = deposit_kernel.launches
        assert torch.equal(deposit_kernel.deposit(pos, mass, NG, **kw),
                           deposit_kernel.deposit_plain(pos, mass, NG, **kw))
        assert deposit_kernel.launches == before


@pytest.mark.parametrize("bad", ["float64 pos", "short mass",
                                 "strided pos", "no box", "both boxes",
                                 "box 0"])
def test_deposit_checks_its_inputs(bad):
    pos, mass, kw = _case("open uniform", n=300, seed=1)
    if bad == "float64 pos":
        pos = pos.double()
    elif bad == "short mass":
        mass = mass[:-1]
    elif bad == "strided pos":
        pos = torch.cat([pos, pos], dim=1)[:, ::2]
    elif bad == "no box":
        kw = {}
    elif bad == "both boxes":
        kw["box"] = 1.0
    else:
        kw = dict(box=0.0)
    with pytest.raises((TypeError, ValueError)):
        deposit_kernel.deposit(pos, mass, NG, **kw)
