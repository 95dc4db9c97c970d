"""The rollout gradient job on the CPU at a small size: a sound run is
correct; with the gradient broken underneath, ``correct`` comes out false,
once for each fault the cell can have; and the float64 reference gradient
agrees with central finite differences of the reference loss."""

from __future__ import annotations

import argparse
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import cells

import run  # noqa: E402  (bench_torch/run.py, on the path through cells)
from harness import grad_check, ics  # noqa: E402
from test_faults import _half_batch, _unchanged  # noqa: E402

WORKLOAD = "p3m-grad-plummer-n262144"


@pytest.fixture(autouse=True)
def _one_segment(monkeypatch):
    cells.one_segment(monkeypatch)


def outcome(seed: int = 2 ** 31 + 7) -> dict:
    cell = cells.tiny(WORKLOAD)
    args = argparse.Namespace(workload=WORKLOAD, seed=seed, seconds=1.0,
                              trace=0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.report(cell, args, platform="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_gradient_is_correct():
    res = outcome()
    assert res["correct"] is True
    assert res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert set(res["compared"]) == {"loss", "gx", "gv", "x", "overflow"}
    assert res["compared"]["overflow"]["value"] == 0.0
    assert {"setup_s", "step_ms"} <= set(res["metrics"])
    assert res["attempted"] == 1


class _Cotangent(torch.autograd.Function):
    """The identity, whose backward applies ``fn`` to the cotangent."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _gradient_fault(fn):
    """The program's rollout with ``fn`` applied to the gradients of its
    initial positions and velocities."""
    def patch(monkeypatch):
        from nbody_tpu_torch.models import rollout

        make = rollout.make_rollout_fn

        def faulty(*args, **kwargs):
            inner = make(*args, **kwargs)
            return lambda pos, vel, mass: inner(_Cotangent.apply(pos, fn),
                                                _Cotangent.apply(vel, fn),
                                                mass)
        monkeypatch.setattr(rollout, "make_rollout_fn", faulty)
    return patch


def _zero_largest(g):
    """One body's gradient zeroed: the body whose gradient is largest."""
    g = g.clone()
    g[:, int(g.norm(dim=0).argmax())] = 0.0
    return g


def _reaction_dropped(monkeypatch):
    """The short-range VJP without its reaction: the symmetric worklist's
    sources take no cotangent from their targets."""
    from nbody_tpu_torch.ops import sr_kernel

    plain = sr_kernel.sweep_vjp_plain
    monkeypatch.setattr(sr_kernel, "sweep_vjp_plain",
                        lambda *a, symmetric=False, **k: plain(
                            *a, symmetric=False, **k))


def _advance(make):
    """``make`` applied to the step the rollout takes
    (``rollout.advance``)."""
    def patch(monkeypatch):
        from nbody_tpu_torch.models import rollout

        monkeypatch.setattr(rollout, "advance", make(rollout.advance))
    return patch


FAULTS = {"gradient scaled by 1.01": _gradient_fault(lambda g: 1.01 * g),
          "one body's gradient zeroed": _gradient_fault(_zero_largest),
          "the VJP's reaction dropped": _reaction_dropped,
          "state unchanged": _advance(_unchanged),
          "half the batch": _advance(_half_batch)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_gradient_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert outcome()["correct"] is False


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 11])
def test_reference_gradient_against_finite_differences(seed):
    """Along 3 seeded directions in (x(0), v(0)), the float64 gradient
    against (L(+h) - L(-h)) / 2h of the same loss, its target held."""
    cell = cells.tiny(WORKLOAD)
    n, steps = 512, int(cell.traffic["block_steps"])
    dt = float(np.float32(cell.traffic["dt"]))
    pos, vel, mass = (torch.from_numpy(a) for a in ics.make(
        "plummer", n, seed))
    ref = grad_check.rollout_gradient(pos, vel, mass, cell.config,
                                      cell.traffic["dt"], steps)
    force = grad_check.reference.solver("p3m_grad").force(
        cell.config, mass.double())
    target = pos.double() + (steps * dt) * vel.double()
    gen = torch.Generator().manual_seed(seed)
    h = 1e-6
    for _ in range(3):
        ux, uv = (torch.randn(3, n, generator=gen, dtype=torch.float64)
                  for _ in range(2))
        with torch.no_grad():
            up, down = (grad_check.rollout_loss(
                pos.double() + s * h * ux, vel.double() + s * h * uv, force,
                dt, steps, target)[0] for s in (1.0, -1.0))
        fd = float(up - down) / (2 * h)
        want = float((ref["gx"] * ux).sum() + (ref["gv"] * uv).sum())
        assert abs(fd - want) <= 1e-6 * abs(want), (fd, want)


def test_a_loaded_jax_package_prints_no_result(monkeypatch):
    """With the JAX package in ``sys.modules`` once the window has closed,
    the run prints no result and exits with another code than 0."""
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nbody_tpu", types.ModuleType(
        "nbody_tpu"))
    cell = cells.tiny(WORKLOAD)
    args = argparse.Namespace(workload=WORKLOAD, seed=5, seconds=1.0,
                              trace=0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.report(cell, args, platform="cpu") == 3
    assert out.getvalue() == ""
    assert run.forbidden_modules() == ["nbody_tpu"]
