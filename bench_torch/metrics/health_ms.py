"""health_ms: the host milliseconds a step inside the program's P3M plan
health check, its ``nbt.health`` range (``nbody_tpu_torch/utils/spans.py``)
on the stretch's thread, clipped to the stretch: host work after each
sample block, which re-measures the overflow on the current state.  None
where the program has no such range."""

from harness import trace

NAME = "nbt.health"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    spans = trace.union(trace.clip([(s, e) for s, e, name in t.host
                                    if name == NAME], t.lo, t.hi))
    return trace.total(spans) * 1e-3 / ctx.run.steps if spans else None
