"""fused_roofline: the fused sample block's least time over its measured
time.  Least: each of the block's force sweeps at
``yardstick.direct_step_seconds``, the N^2/2 pairs at 27 flop that
``direct_roofline`` counts, whatever implements them, N unpadded; a block
sweeps once a step, and once more under leapfrog (its re-seed), the rule
of the program's own ``spans.counts["fused_sweeps"]``; measured: the device
time inside the harness's span around the fused block's entry
(``fused_block``: one launch a block on the card).  No reading where the
configuration does not run the fused block."""

from harness import yardstick

SPANS = {"fused": "nbody_tpu_torch.ops.fused_block:fused_block"}


def sweeps(run, program: dict) -> int:
    """The force sweeps of the run's fused blocks."""
    return run.steps + run.blocks * (program.get("integrator") == "leapfrog")


def read(ctx):
    t = ctx.trace
    program = ctx.cell.config["program"]
    if t is None or not program.get("fused") or not ctx.run.steps:
        return None
    us = t.device_us(*SPANS)
    if us <= 0:
        return None
    n = int(ctx.cell.traffic["n"])
    least_us = sweeps(ctx.run, program) * yardstick.direct_step_seconds(n)
    return 100.0 * least_us * 1e6 / us
