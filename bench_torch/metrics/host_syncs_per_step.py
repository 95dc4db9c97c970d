"""host_syncs_per_step: the program's host syncs a step in the traced
stretch.  The program (``nbody_tpu_torch/utils/spans.py``) puts a
``nbt.sync.<site>`` range around each host read of a device value and each
copy from pageable host memory that waits for the stream; this counts those
ranges that start inside the stretch, on its thread, over its steps.  None
where the program has no such ranges."""

PREFIX = "nbt.sync."


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    syncs = sum(1 for s, _, name in t.host
                if name.startswith(PREFIX) and t.lo <= s < t.hi)
    return syncs / ctx.run.steps if syncs else None
