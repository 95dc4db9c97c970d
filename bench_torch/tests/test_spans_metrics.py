"""The readers of the program's own spans (``host_syncs_per_step``,
``sync_idle_ms``, ``health_ms``) on a synthetic profiler trace, and on a
traced run of a small P3M cell on the CPU; and the rollout gradient's
(``backward_ms``, ``sr_vjp_roofline``) on a synthetic trace in which
autograd's thread launches the backward."""

from __future__ import annotations

import argparse
import os
import sys
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spec, trace  # noqa: E402

METRICS = ("host_syncs_per_step", "sync_idle_ms", "health_ms")


def ev(cat, name, ts, dur, tid=1, corr=None):
    out = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
           "tid": tid}
    if corr is not None:
        out["args"] = {"correlation": corr}
    return out


def synthetic(spans: bool = True):
    events = [
        ev("user_annotation", "bench:stretch", 0, 100),
        ev("kernel", "a", 0, 22),
        ev("gpu_memcpy", "Memcpy DtoH", 24, 1),
        ev("kernel", "b", 35, 5),
        ev("kernel", "c", 45, 15),
        ev("kernel", "d", 63, 17),
        ev("kernel", "e", 96, 3),
    ]
    if spans:
        events += [
            ev("user_annotation", "nbt.block", 0, 31),
            # Gaps 22-24 and 25-35 begin inside it: 12 us.
            ev("user_annotation", "nbt.sync.ke", 20, 10),
            # Gap 40-45 begins at its start: 5 us.
            ev("user_annotation", "nbt.sync.p3m_overflow", 40, 1),
            ev("user_annotation", "nbt.health", 60, 10),
            # Gap 60-63 begins before it: not counted.
            ev("user_annotation", "nbt.sync.cell_overflow", 62, 2),
            ev("user_annotation", "nbt.health", 90, 5),
            # Outside the stretch, and on another thread: not counted.
            ev("user_annotation", "nbt.sync.ke", 150, 1),
            ev("user_annotation", "nbt.health", 150, 10),
            ev("user_annotation", "nbt.sync.ke", 80, 10, tid=2),
            ev("user_annotation", "nbt.health", 80, 10, tid=2),
        ]
    return events


def ctx(events, steps: int = 4):
    return types.SimpleNamespace(trace=trace.Trace(events),
                                 run=types.SimpleNamespace(steps=steps))


def test_readers_on_a_synthetic_trace():
    c = ctx(synthetic())
    assert c.trace.busy == [(0, 22), (24, 25), (35, 40), (45, 60), (63, 80),
                            (96, 99)]
    assert spec.reader("host_syncs_per_step")(c) == 3 / 4
    assert spec.reader("sync_idle_ms")(c) == pytest.approx(17e-3 / 4)
    assert spec.reader("health_ms")(c) == pytest.approx(15e-3 / 4)


@pytest.mark.parametrize("metric", METRICS)
def test_readers_without_the_spans(metric):
    assert spec.reader(metric)(ctx(synthetic(spans=False))) is None
    assert spec.reader(metric)(types.SimpleNamespace(trace=None)) is None


def test_traced_run_reports_them_on_the_cpu():
    """The harness's traced stretch of a small P3M cell: the program's
    spans reach the trace's host events, and the readers find them."""
    import cells
    import run

    cell = cells.tiny("p3m-plummer-n262144")
    args = argparse.Namespace(workload=cell.name, seed=2 ** 31 + 9,
                              seconds=1.0, trace=1)
    _, values, _, breakdown = run.measure(cell, args, platform="cpu")
    assert set(METRICS) <= set(values)
    steps = cell.traffic["block_steps"] * cell.traffic["segment_blocks"]
    # A step: the overflow read and the worklist's offsets; a block: the
    # box's quantiles, the KE read and the health check's two reads, its
    # two boxes' quantiles and four worklists' offsets.
    blocks = cell.traffic["segment_blocks"]
    want = (2 * steps + (1 + 1 + 2 + 2 + 4) * blocks) / steps
    assert values["host_syncs_per_step"]["value"] == pytest.approx(want)
    assert values["health_ms"]["value"] > 0
    assert values["sync_idle_ms"]["value"] >= 0


GRAD_METRICS = ("backward_ms", "sr_vjp_roofline")


def grad_synthetic(spans: bool = True):
    """A gradient: the forward launched from the stretch's thread (1), the
    backward from autograd's (2) while thread 1 waits in bench:backward,
    then the loss read."""
    events = [
        ev("user_annotation", "bench:stretch", 0, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        ev("kernel", "forward", 10, 20, tid=7, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 45, 1, tid=2, corr=2),
        ev("kernel", "recompute", 46, 14, tid=7, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, tid=2, corr=3),
        ev("kernel", "sr_vjp", 58, 17, tid=7, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 92, 3, corr=4),
        ev("gpu_memcpy", "Memcpy DtoH", 93, 1, tid=7, corr=4),
    ]
    if spans:
        events += [
            ev("user_annotation", "bench:backward", 40, 50),
            ev("gpu_user_annotation", "bench:sr.vjp", 58, 17, tid=7),
        ]
    return events


def grad_ctx(events, steps: int = 8):
    from harness import ics

    pos, _, mass = (torch.from_numpy(a) for a in ics.make("plummer", 400, 5))
    cell = types.SimpleNamespace(config={"grid": 16, "cutoff_cells": 4})
    return types.SimpleNamespace(
        trace=trace.Trace(events), run=types.SimpleNamespace(steps=steps),
        cell=cell, stretch_states=((pos, mass), (pos * 1.01, mass)))


def test_gradient_readers_on_a_synthetic_trace():
    from harness import yardstick

    c = grad_ctx(grad_synthetic())
    # Launched inside bench:backward, from thread 2: 46-60 and 58-75.
    assert c.trace.launched_us("backward") == 29
    assert c.trace.launched_us("stretch") == 20 + 29 + 1
    assert spec.reader("backward_ms")(c) == pytest.approx(29e-3 / 8)
    counts = [yardstick.sr_pairs(p, m, 16, 4) for p, m in c.stretch_states]
    least = yardstick.sr_vjp_step_seconds(
        sum(k[0] for k in counts) / 2, sum(k[1] for k in counts) / 2)
    assert counts[0][0] > 0
    assert spec.reader("sr_vjp_roofline")(c) == pytest.approx(
        100 * least * 1e6 / (17 / 8))


@pytest.mark.parametrize("metric", GRAD_METRICS)
def test_gradient_readers_without_the_spans(metric):
    assert spec.reader(metric)(grad_ctx(grad_synthetic(spans=False))) is None
    assert spec.reader(metric)(types.SimpleNamespace(
        trace=None, cell=types.SimpleNamespace(config={}),
        run=types.SimpleNamespace(steps=8))) is None
