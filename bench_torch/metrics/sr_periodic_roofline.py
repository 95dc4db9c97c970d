"""sr_periodic_roofline: the periodic short-range sum's least time a step
over its measured time.  Least: the unordered minimum-image pairs inside
the cutoff radius (counted here in plain torch by a cell search that wraps
round the box, ``harness/periodic_neighbours.py``, on the stretch's first
and last states, the mean) at 38 flop (31 a pair and 7 for the reaction)
at the fp32 peak, or 28 bytes a body at the memory peak if larger;
measured: the device time a step inside the span around the short-range
kernel's entry (``sr_kernel.sweep``), which runs on the sources and their
ghost images."""

from harness import periodic_neighbours, yardstick

SPANS = {"sr": "nbody_tpu_torch.ops.sr_kernel:sweep"}


def read(ctx):
    t = ctx.trace
    cfg = ctx.cell.config
    if t is None or "box" not in cfg or not ctx.run.steps:
        return None
    us = t.device_us(*SPANS) / ctx.run.steps
    if us <= 0:
        return None
    pairs, bodies = periodic_neighbours.mean_sr_pairs(
        ctx.stretch_states, cfg["grid"], cfg["cutoff_cells"], cfg["box"])
    return 100.0 * yardstick.sr_step_seconds(pairs, bodies) * 1e6 / us
