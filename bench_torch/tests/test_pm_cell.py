"""The plain PM cell, ``pm-uniform-n1048576``: it loads with its metrics,
whose spans name functions the program has and agree with every other
metric's; its readers on a synthetic profiler trace; and one window of the
cell cut to a CPU size comes out correct, where the control does not."""

from __future__ import annotations

import importlib
import types

import pytest

import cells
import control  # noqa: E402  (bench_torch/control.py)
from harness import spec, trace  # noqa: E402

WORKLOAD = "pm-uniform-n1048576"
METRICS = ("pm_mesh_ms", "far_field_ms", "deposit_roofline")


def tiny() -> spec.Cell:
    """The cell's blocks and segment at N=4096 on a grid of 16, dt scaled
    with N as the P3M twin's CPU size scales it."""
    cell = spec.load(WORKLOAD)
    cell.traffic = dict(cell.traffic, n=4096, trace_segments=1,
                        dt=0.001 * 1048576 / 4096)
    cell.config = dict(cell.config, grid=16, program=dict(
        cell.config["program"], pm_grid=16))
    return cell


def test_cell_loads_with_its_metrics():
    cell = spec.load(WORKLOAD)
    assert cell.config["program"]["kernel"] == "pm"
    assert "pm_cutoff" not in cell.config["program"]
    assert {m.name for m in cell.end_to_end} == {"setup_s", "step_ms"}
    names = {m.name for m in cell.per_layer}
    assert set(METRICS) <= names
    assert not {"mesh_ms", "sr_roofline", "health_ms"} & names
    targets = spec.spans(cell.per_layer)
    assert {"mesh.env", "mesh.deposit", "mesh.fft", "mesh.grids",
            "mesh.ifft", "mesh.gather", "mesh.inside", "mesh.moments",
            "mesh.monopole"} == set(targets)
    for target in targets.values():
        where, attr = target.split(":")
        assert callable(getattr(importlib.import_module(where), attr))
    # One label, one target, across every metric of the benchmark.
    every = [spec.Metric(n, "", None) for n in (
        "mesh_ms", "periodic_mesh_ms", "ghosts_ms", "sr_roofline",
        "sr_vjp_roofline", "direct_roofline") + METRICS]
    assert spec.spans(every)["mesh.deposit"] == targets["mesh.deposit"]


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def synthetic(spans: bool = True):
    """Two steps: the env, the deposit, the forward transform, the
    products, the inverse transforms (their range nested in the
    products', as the parent tree calls them), the gather; the far field's
    mask, moments and monopoles; and the integrator's update in no
    range."""
    events = [ev("user_annotation", "bench:stretch", 0, 300),
              ev("kernel", "spectra", 0, 10), ev("kernel", "deposit", 12, 4),
              ev("kernel", "r2c", 20, 2), ev("kernel", "mul", 24, 3),
              ev("kernel", "c2r", 28, 6), ev("kernel", "gather", 40, 9),
              ev("kernel", "inside", 50, 1), ev("kernel", "moments", 52, 5),
              ev("kernel", "monopole", 60, 4), ev("kernel", "where", 65, 1),
              ev("kernel", "update", 70, 2)]
    if spans:
        events += [
            ev("gpu_user_annotation", "bench:mesh.env", 0, 10, tid=7),
            ev("gpu_user_annotation", "bench:mesh.deposit", 12, 4, tid=7),
            ev("gpu_user_annotation", "bench:mesh.fft", 20, 2, tid=7),
            ev("gpu_user_annotation", "bench:mesh.grids", 24, 10, tid=7),
            ev("gpu_user_annotation", "bench:mesh.ifft", 28, 6, tid=7),
            ev("gpu_user_annotation", "bench:mesh.gather", 40, 9, tid=7),
            ev("gpu_user_annotation", "bench:mesh.inside", 50, 1, tid=7),
            ev("gpu_user_annotation", "bench:mesh.moments", 52, 5, tid=7),
            ev("gpu_user_annotation", "bench:mesh.monopole", 60, 4, tid=7)]
    return events


def ctx(events, steps: int = 2):
    cell = types.SimpleNamespace(config={"grid": 128},
                                 traffic={"n": 1048576})
    return types.SimpleNamespace(trace=trace.Trace(events),
                                 run=types.SimpleNamespace(steps=steps),
                                 cell=cell)


def test_readers_on_a_synthetic_trace():
    c = ctx(synthetic())
    # 10 + 4 + 2 + 3 + 6 + 9 us, the nested ranges counted once.
    assert spec.reader("pm_mesh_ms")(c) == pytest.approx(34e-3 / 2)
    assert spec.reader("far_field_ms")(c) == pytest.approx(10e-3 / 2)
    least_us = (16 * 1048576 + 4 * 128 ** 3) / 3.35e12 * 1e6
    assert spec.reader("deposit_roofline")(c) == pytest.approx(
        100 * least_us / (4 / 2))


@pytest.mark.parametrize("metric", METRICS)
def test_readers_without_the_spans(metric):
    assert spec.reader(metric)(ctx(synthetic(spans=False))) is None
    none = types.SimpleNamespace(trace=None, run=types.SimpleNamespace(
        steps=2), cell=types.SimpleNamespace(config={}, traffic={}))
    assert spec.reader(metric)(none) is None


def test_tiny_window_is_correct_and_the_control_is_not(monkeypatch):
    """One window of the cell at a CPU size, against the float64 PM
    reference under the cell's own limits; the control fails one."""
    cells.one_segment(monkeypatch)
    cell = tiny()
    r = control.readings(cell, 2 ** 31 + 3, 1.0, platform="cpu")
    limits = cell.check["limits"]
    assert all(r["program"][k] <= v["limit"] for k, v in limits.items()), r
    assert any(not r["control"][k] <= v["limit"]
               for k, v in limits.items()), r
