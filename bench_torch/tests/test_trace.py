"""The trace reader: interval union, gaps, spans and the idle gaps' host
activity, on a synthetic profiler trace."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import trace  # noqa: E402


def test_union_clip_total_gaps():
    u = trace.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 11)])
    assert u == [(0, 3), (5, 9), (10, 11)]
    assert trace.total(u) == 8
    assert trace.clip(u, 2, 10.5) == [(2, 3), (5, 9), (10, 10.5)]
    assert trace.gaps(u, -1, 12) == [(-1, 0), (3, 5), (9, 10), (11, 12)]
    assert trace.gaps(u, 0, 3) == []


def test_innermost_nested_events():
    events = [(0, 100, "block"), (10, 20, "a"), (12, 14, "b"), (30, 40, "c")]
    assert trace.innermost(events, [13, 15, 35, 50, 150, 5]) == [
        "b", "a", "c", "block", "none", "block"]


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def synthetic():
    return [
        ev("user_annotation", "bench:stretch", 0, 100),
        ev("user_annotation", "bench:block", 0, 90),
        ev("user_annotation", "bench:accel", 10, 30),
        ev("cpu_op", "aten::add", 50, 10),
        ev("cpu_op", "other thread", 0, 100, tid=2),
        ev("gpu_user_annotation", "bench:accel", 20, 40),
        ev("kernel", "pairs", 20, 25),
        ev("kernel", "reduce", 45, 15),
        ev("kernel", "axpy", 70, 10),
        ev("gpu_memcpy", "Memcpy DtoH", 75, 10),
        ev("kernel", "outside", 150, 10),
    ]


def test_trace_busy_spans_and_breakdown():
    t = trace.Trace(synthetic())
    assert (t.lo, t.hi) == (0, 100)
    assert t.busy == [(20, 60), (70, 85)]
    assert t.busy_us == 55
    assert t.window_us == 100
    assert t.device_us("accel") == 40
    assert t.device_us("nothing") == 0
    assert t.top_ops(2) == [["pairs", pytest.approx(25e-6)],
                            ["reduce", pytest.approx(15e-6)]]
    # Gaps: 0-20 (midpoint 10: bench:accel starts there), 60-70 (aten::add
    # ends at 60: bench:block), 85-100 (bench:stretch).
    idle = dict(t.idle_by_host())
    assert idle == {"bench:accel": pytest.approx(20e-6),
                    "bench:stretch": pytest.approx(15e-6),
                    "bench:block": pytest.approx(10e-6)}


def test_trace_needs_the_stretch():
    with pytest.raises(RuntimeError):
        trace.Trace([ev("kernel", "k", 0, 1)])
