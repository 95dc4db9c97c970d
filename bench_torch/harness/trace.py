"""The traced run: one profiled stretch, read from ``torch.profiler``'s
trace, on one timeline.

* Device activities: kernels, copies and sets.  ``busy`` is the length of
  their union inside the stretch, so overlapping work counts once; the
  stretch is the host-side ``bench:stretch`` range of the same trace.
* Spans: the harness's ``bench:*`` ranges.  Each has a host-side interval
  and, where it launched work, a device-side one; an activity belongs to a
  span when its device interval lies inside the span's device interval.
* Idle gaps: the stretch minus the busy union, each named by what the host
  was doing at its midpoint (the innermost host event there).
* Launches: each device activity's launching runtime call, on any host
  thread, found by the trace's correlation id.  Work that autograd's own
  thread launches while the stretch's thread waits in a ``bench:*`` range
  belongs to that range (``launched_us``), whether or not the range's
  device interval holds it.

The span and interval logic follows ``scripts/torch_profile.py``
(``_stage_hooks``, ``_ranged``), copied so that the yardstick stays.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN = "bench:"


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def gaps(busy, lo: float, hi: float) -> list:
    """The parts of [lo, hi] that no interval of the merged ``busy``
    covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def innermost(events, points) -> list:
    """For each time in ``points``, the name of the shortest of the nested
    (start, end, name) ``events`` (one thread's) that holds it, or "none":
    one sweep with a stack of the open events."""
    evs = sorted(events, key=lambda e: (e[0], -e[1]))
    order = sorted(range(len(points)), key=lambda k: points[k])
    out = ["none"] * len(points)
    stack, k = [], 0
    for q in order:
        t = points[q]
        while k < len(evs) and evs[k][0] <= t:
            while stack and stack[-1][1] < evs[k][0]:
                stack.pop()
            stack.append(evs[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[q] = stack[-1][2]
    return out


class Trace:
    """The stretch's activities and spans, in microseconds."""

    def __init__(self, events: list):
        self.activities = []  # (start, end, name)
        self.correlations = []  # each activity's correlation id, or None
        self.launches = {}  # correlation id -> start of its runtime call
        self.host = []  # (start, end, name), the stretch's thread
        tid = next((ev.get("tid") for ev in events
                    if ev.get("name") == SPAN + "stretch"
                    and ev.get("cat") in HOST_CATS), None)
        self.device_spans = {}  # name -> [(start, end)]
        self.host_spans = {}
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            name = ev.get("name", "")
            corr = ev.get("args", {}).get("correlation")
            if cat in DEVICE_CATS:
                self.activities.append((s, e, name))
                self.correlations.append(corr)
                continue
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                self.launches[corr] = s
            if cat == "gpu_user_annotation" and name.startswith(SPAN):
                self.device_spans.setdefault(name[len(SPAN):], []).append(
                    (s, e))
            elif cat in HOST_CATS and ev.get("tid") == tid:
                self.host.append((s, e, name))
                if name.startswith(SPAN):
                    self.host_spans.setdefault(name[len(SPAN):], []).append(
                        (s, e))
        stretch = self.host_spans.get("stretch")
        if not stretch:
            raise RuntimeError("the trace holds no bench:stretch range")
        self.lo, self.hi = stretch[0]
        self.busy = union(clip([(s, e) for s, e, _ in self.activities],
                               self.lo, self.hi))

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    @property
    def busy_us(self) -> float:
        return total(self.busy)

    def inside(self, span: str) -> list:
        """The activities inside the device intervals of ``span``."""
        ivs = union(self.device_spans.get(span, ()))
        starts = [s for s, _ in ivs]
        out = []
        for a in self.activities:
            k = bisect.bisect_right(starts, a[0]) - 1
            if k >= 0 and a[1] <= ivs[k][1]:
                out.append(a)
        return out

    def device_us(self, *spans: str) -> float:
        """Device time of the activities inside any of ``spans``, each
        counted once."""
        seen = set()
        for span in spans:
            seen.update(self.inside(span))
        return total(union([(s, e) for s, e, _ in seen]))

    def launched_us(self, span: str) -> float:
        """Device time of the activities launched, from any host thread,
        while the stretch's thread was inside a range of ``span``, each
        counted once."""
        ivs = union(self.host_spans.get(span, ()))
        starts = [s for s, _ in ivs]
        out = []
        for a, corr in zip(self.activities, self.correlations):
            t = self.launches.get(corr)
            k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if k >= 0 and t <= ivs[k][1]:
                out.append(a[:2])
        return total(union(out))

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for s, e, name in self.activities:
            if e > self.lo and s < self.hi:
                by[name] = by.get(name, 0.0) + (min(e, self.hi)
                                                - max(s, self.lo))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, us * 1e-6] for name, us in top]

    def idle_by_host(self, k: int = 10) -> list:
        idle = gaps(self.busy, self.lo, self.hi)
        names = innermost(self.host, [0.5 * (s + e) for s, e in idle])
        by = {}
        for (s, e), name in zip(idle, names):
            by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, us * 1e-6] for name, us in top]


def record(fn):
    """Run ``fn()`` under the profiler (host and CUDA activity); returns
    (fn's result, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return result, Trace(events)
