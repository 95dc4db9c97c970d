"""ghosts_ms: the device milliseconds a step inside the span around the
periodic ghost images (``pm._ghost_images``: the boundary bodies' prefix
sum, then the decode of each image slot).  It covers the solver's call in
every force evaluation and the health check's after each block: its ghost
count (``ghost_overflow_count``) and the ghost-extended binning behind its
cell and worklist reads.  None where no periodic call ran."""

SPANS = {"mesh.ghosts": "nbody_tpu_torch.ops.pm:_ghost_images"}


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    us = t.device_us(*SPANS)
    return us * 1e-3 / ctx.run.steps if us > 0 else None
