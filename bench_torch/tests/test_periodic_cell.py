"""The periodic P3M cell, ``p3m-periodic-n1048576``: it loads with its
metrics, whose spans name functions the program has; its readers on a
synthetic profiler trace; and one window of the cell cut to a CPU size
comes out correct, where the control does not."""

from __future__ import annotations

import importlib
import types

import pytest
import torch

import cells
import control  # noqa: E402  (bench_torch/control.py)
from harness import ics, periodic_neighbours, spec, trace, yardstick  # noqa: E402

WORKLOAD = "p3m-periodic-n1048576"
METRICS = ("ghosts_ms", "periodic_mesh_ms", "sr_periodic_roofline")


def tiny() -> spec.Cell:
    """The cell's blocks and segment at N=4096 on a grid of 16, r_c a
    quarter of the box (a reach of 2 cells), dt scaled with N as the open
    uniform cell's CPU size scales it."""
    cell = spec.load(WORKLOAD)
    cell.traffic = dict(cell.traffic, n=4096, trace_segments=1,
                        dt=0.001 * 1048576 / 4096)
    cell.config = dict(cell.config, grid=16, program=dict(
        cell.config["program"], pm_grid=16))
    return cell


def test_cell_loads_with_its_metrics():
    cell = spec.load(WORKLOAD)
    assert cell.config["program"]["pm_boundary"] == "periodic"
    assert cell.config["program"]["pm_box"] == cell.config["box"]
    assert {m.name for m in cell.end_to_end} == {"setup_s", "step_ms"}
    names = {m.name for m in cell.per_layer}
    assert set(METRICS) <= names
    assert not {"mesh_ms", "sr_roofline", "health_ms"} & names
    targets = spec.spans(cell.per_layer)
    assert {"mesh.ghosts", "mesh.deposit_periodic", "mesh.fft",
            "mesh.ifft_periodic", "mesh.gather_periodic", "sr"} <= set(
                targets)
    for target in targets.values():
        where, attr = target.split(":")
        assert callable(getattr(importlib.import_module(where), attr))


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def synthetic(spans: bool = True):
    """Two steps: the ghost images, the deposit, the forward transform, the
    inverse transforms, the gather and the sweep each launch a kernel
    inside their range's device interval; the health check's ghost build
    launches one more."""
    events = [ev("user_annotation", "bench:stretch", 0, 200),
              ev("kernel", "ghosts", 2, 4), ev("kernel", "scatter", 10, 6),
              ev("kernel", "r2c", 20, 2), ev("kernel", "c2r", 25, 3),
              ev("kernel", "gather", 30, 5), ev("kernel", "sr", 40, 20),
              ev("kernel", "health ghosts", 150, 8)]
    if spans:
        events += [
            ev("gpu_user_annotation", "bench:mesh.ghosts", 2, 4, tid=7),
            ev("gpu_user_annotation", "bench:mesh.deposit_periodic", 10, 6,
               tid=7),
            ev("gpu_user_annotation", "bench:mesh.fft", 20, 2, tid=7),
            ev("gpu_user_annotation", "bench:mesh.ifft_periodic", 25, 3,
               tid=7),
            ev("gpu_user_annotation", "bench:mesh.gather_periodic", 30, 5,
               tid=7),
            ev("gpu_user_annotation", "bench:sr", 40, 20, tid=7),
            ev("gpu_user_annotation", "bench:mesh.ghosts", 150, 8, tid=7)]
    return events


def ctx(events, steps: int = 2):
    pos, _, mass = (torch.from_numpy(a) for a in ics.make("reference", 512,
                                                          2 ** 31 + 5))
    cell = types.SimpleNamespace(config={"grid": 16, "cutoff_cells": 4,
                                         "box": 1.0})
    return types.SimpleNamespace(
        trace=trace.Trace(events), run=types.SimpleNamespace(steps=steps),
        cell=cell, stretch_states=((pos, mass), (pos + 1e-3, mass)))


def test_readers_on_a_synthetic_trace():
    c = ctx(synthetic())
    assert spec.reader("ghosts_ms")(c) == pytest.approx(12e-3 / 2)
    assert spec.reader("periodic_mesh_ms")(c) == pytest.approx(16e-3 / 2)
    counts = [periodic_neighbours.sr_pairs(p, m, 16, 4, 1.0)
              for p, m in c.stretch_states]
    assert counts[0][0] > 0 and counts[0][1] == 512
    least = yardstick.sr_step_seconds(sum(k[0] for k in counts) / 2, 512)
    assert spec.reader("sr_periodic_roofline")(c) == pytest.approx(
        100 * least * 1e6 / (20 / 2))


@pytest.mark.parametrize("metric", METRICS)
def test_readers_without_the_spans(metric):
    assert spec.reader(metric)(ctx(synthetic(spans=False))) is None
    none = types.SimpleNamespace(trace=None, run=types.SimpleNamespace(
        steps=2), cell=types.SimpleNamespace(config={}))
    assert spec.reader(metric)(none) is None


def test_tiny_window_is_correct_and_the_control_is_not(monkeypatch):
    """One window of the cell at a CPU size, against the float64 periodic
    reference under the cell's own limits; the control fails one."""
    cells.one_segment(monkeypatch)
    cell = tiny()
    r = control.readings(cell, 2 ** 31 + 3, 1.0, platform="cpu")
    limits = cell.check["limits"]
    assert all(r["program"][k] <= v["limit"] for k, v in limits.items()), r
    assert any(not r["control"][k] <= v["limit"]
               for k, v in limits.items()), r
