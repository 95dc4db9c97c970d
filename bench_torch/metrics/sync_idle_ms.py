"""sync_idle_ms: the device-idle milliseconds a step that the program's
host syncs leave.  The stretch's idle gaps (no kernel, copy or set on the
card) that begin inside one of the program's ``nbt.sync.<site>`` host ranges
count whole, up to the next device activity: the card ran dry while the
host waited on it, and stays dry until the host has launched again.  None
where the program has no such ranges."""

import bisect

from harness import trace

PREFIX = "nbt.sync."


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    syncs = trace.union(trace.clip([(s, e) for s, e, name in t.host
                                    if name.startswith(PREFIX)], t.lo, t.hi))
    if not syncs:
        return None
    starts = [s for s, _ in syncs]
    idle = []
    for g0, g1 in trace.gaps(t.busy, t.lo, t.hi):
        k = bisect.bisect_right(starts, g0) - 1
        if k >= 0 and g0 <= syncs[k][1]:
            idle.append((g0, g1))
    return trace.total(idle) * 1e-3 / ctx.run.steps
