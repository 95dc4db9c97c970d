"""The fused direct cell, ``direct-n16384-fused``: it loads with its
metrics, whose span names a function the program has and agrees with every
other metric's; ``fused_roofline`` on a synthetic profiler trace; and one
window of the cell cut to a CPU size comes out correct, where the control
(the unfused bf16 distance mode) does not."""

from __future__ import annotations

import importlib
import json
import os
import types

import pytest

import cells
import control  # noqa: E402  (bench_torch/control.py)
from harness import spec, trace, yardstick  # noqa: E402

WORKLOAD = "direct-n16384-fused"


def tiny() -> spec.Cell:
    """The cell at N=2048 with dt scaled with N (the upstream's masses grow
    with N, so the cube's free-fall time goes as 1/N), and a segment of the
    3 blocks the reference follows."""
    cell = spec.load(WORKLOAD)
    n = 2048
    cell.traffic = dict(cell.traffic, n=n, trace_segments=1,
                        segment_blocks=cell.check["reference_blocks"],
                        dt=cell.traffic["dt"] * 16384 / n)
    return cell


def test_cell_loads_with_its_metrics():
    cell = spec.load(WORKLOAD)
    twin = spec.load("direct-n16384")
    assert cell.config["program"]["fused"] is True
    assert cell.config["control"] == {"program": {"fused": False,
                                                  "precision": "bf16"}}
    assert cell.traffic == twin.traffic
    assert {m.name for m in cell.end_to_end} == {"setup_s", "step_ms"}
    assert {m.name for m in cell.per_layer} == {
        "device_idle", "host_syncs_per_step", "sync_idle_ms",
        "fused_roofline"}
    targets = spec.spans(cell.per_layer)
    assert targets == {"fused": "nbody_tpu_torch.ops.fused_block:fused_block"}
    where, attr = targets["fused"].split(":")
    assert callable(getattr(importlib.import_module(where), attr))
    # One label, one target, across every metric of the benchmark.
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        every = [spec.Metric(m["name"], m["unit"], None)
                 for m in json.load(f)["per_layer"]]
    assert spec.spans(every)["fused"] == targets["fused"]


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def synthetic(spans: bool = True):
    """Two blocks: the clones and the counter's zero, the fused launch, then
    the kinetic energy's kernels outside the range."""
    events = [ev("user_annotation", "bench:stretch", 0, 400)]
    for t0 in (0, 200):
        events += [ev("gpu_memcpy", "clone", t0, 2),
                   ev("kernel", "fill", t0 + 3, 1),
                   ev("kernel", "fused_rows_kernel", t0 + 5, 145),
                   ev("kernel", "mul", t0 + 160, 2),
                   ev("kernel", "sum", t0 + 163, 3)]
        if spans:
            events.append(ev("gpu_user_annotation", "bench:fused", t0, 150,
                             tid=7))
    return events


def ctx(events, fused: bool = True, steps: int = 100,
        integrator: str = "euler"):
    cell = types.SimpleNamespace(config={"program": {
        "fused": fused, "integrator": integrator}}, traffic={"n": 16384})
    return types.SimpleNamespace(trace=trace.Trace(events),
                                 run=types.SimpleNamespace(
                                     steps=steps, blocks=steps // 50),
                                 cell=cell)


@pytest.mark.parametrize("integrator,sweeps", [("euler", 100),
                                               ("leapfrog", 102)])
def test_reader_on_a_synthetic_trace(integrator, sweeps):
    read = spec.reader("fused_roofline")
    # 2 + 1 + 145 us a block inside the range; 50 sweeps a block under
    # Euler, 51 under leapfrog.
    least_us = sweeps * yardstick.direct_step_seconds(16384) * 1e6
    assert read(ctx(synthetic(), integrator=integrator)) == pytest.approx(
        100 * least_us / 296)
    # N^2/2 pairs at 27 flop at 67 TFLOP/s: 54.09 us a sweep.
    assert yardstick.direct_step_seconds(16384) == pytest.approx(
        27 * 16384 ** 2 / 2 / 67e12)


def test_reader_without_the_span_or_the_fused_block():
    read = spec.reader("fused_roofline")
    assert read(ctx(synthetic(spans=False))) is None
    assert read(ctx(synthetic(), fused=False)) is None
    assert read(ctx(synthetic(), steps=0)) is None
    none = types.SimpleNamespace(trace=None, run=types.SimpleNamespace(
        steps=2, blocks=1), cell=types.SimpleNamespace(config={"program": {}},
                                             traffic={}))
    assert read(none) is None


def test_tiny_window_is_correct_and_the_control_is_not(monkeypatch):
    """One window of the cell at a CPU size through the fused engine,
    against the float64 direct reference under the cell's own limits; the
    control fails one."""
    cells.one_segment(monkeypatch)
    cell = tiny()
    r = control.readings(cell, 2 ** 31 + 3, 1.0, platform="cpu")
    limits = cell.check["limits"]
    assert all(r["program"][k] <= v["limit"] for k, v in limits.items()), r
    assert any(not r["control"][k] <= v["limit"]
               for k, v in limits.items()), r


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_sweeps_agree_with_the_programs_counter(integrator):
    """The sweeps the reader counts over a stretch are those the program's
    ``spans.counts["fused_sweeps"]`` counts over it, under either
    integrator."""
    from harness import program, window
    from nbody_tpu_torch.utils import spans

    metric = importlib.import_module("metrics.fused_roofline")
    cell = tiny()
    cell.traffic = dict(cell.traffic, n=256, block_steps=4, segment_blocks=2)
    config = dict(cell.config, program=dict(cell.config["program"],
                                            integrator=integrator))
    prog = program.make(config, cell.traffic, 7, platform="cpu")
    before = spans.counts["fused_sweeps"]
    run = window.stretch(prog, cell.traffic, ())
    prog.close()
    assert run.blocks == 2
    assert metric.sweeps(run, config["program"]) == (
        spans.counts["fused_sweeps"] - before)
