"""A whole run, but for the look for a card, on the CPU at a small size:
sound, it is correct; with the timed path broken underneath, ``correct``
comes out false, once for each fault a cell can have.  (There is no
exchange between chips: every cell takes one.)"""

from __future__ import annotations

import argparse
import contextlib
import io
import json

import pytest
import torch

import cells

import run  # noqa: E402  (bench_torch/run.py, on the path through cells)

WORKLOADS = ("direct-n16384", "p3m-plummer-n262144")


@pytest.fixture(autouse=True)
def _one_segment(monkeypatch):
    cells.one_segment(monkeypatch)


def outcome(workload: str, seed: int = 2 ** 31 + 5) -> dict:
    cell = cells.tiny(workload)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=1.0,
                              trace=0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.report(cell, args, platform="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    res = outcome(workload)
    assert res["correct"] is True
    assert res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert {"setup_s", "step_ms"} <= set(res["metrics"])
    assert res["attempted"] == cells.tiny(workload).traffic["segment_blocks"]


def _unchanged(advance):
    def fault(pos, vel, mass, accel_fn, dt, steps, integrator="euler",
              env=None):
        return pos, vel
    return fault


def _half_batch(advance):
    """Half the sources left out of each force, the rest counted double."""
    def fault(pos, vel, mass, accel_fn, dt, steps, integrator="euler",
              env=None):
        keep = (torch.arange(mass.shape[0]) % 2 == 0).to(mass)

        def half(p, m, **kw):
            return 2.0 * accel_fn(p, m * keep, **kw)
        return advance(pos, vel, mass, half, dt, steps, integrator, env)
    return fault


FAULTS = {"state unchanged": ("advance", _unchanged),
          "half the batch": ("advance", _half_batch),
          "energy altered": ("kinetic_energy",
                             lambda ke: lambda s: ke(s) * (1 + 1e-3))}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    from nbody_tpu_torch.models import integrators

    attr, make = FAULTS[fault]
    monkeypatch.setattr(integrators, attr, make(getattr(integrators, attr)))
    assert outcome(workload)["correct"] is False
