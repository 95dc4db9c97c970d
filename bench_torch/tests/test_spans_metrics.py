"""The readers of the program's own spans (``host_syncs_per_step``,
``sync_idle_ms``, ``health_ms``) on a synthetic profiler trace, and on a
traced run of a small P3M cell on the CPU."""

from __future__ import annotations

import argparse
import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spec, trace  # noqa: E402

METRICS = ("host_syncs_per_step", "sync_idle_ms", "health_ms")


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


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
