"""direct_roofline: a step's least time over its measured time.  Least:
the larger of N^2/2 pairs at 27 flop at the fp32 peak and 28 N bytes at the
memory peak, N unpadded; measured: the device time a step inside the
harness's span around the force function the block calls."""

from harness import yardstick

# ``runner:`` names an attribute of the program's runner: the force
# function its blocks are built around.
SPANS = {"accel": "runner:accel_fn"}


def read(ctx):
    t = ctx.trace
    if t is None or ctx.cell.config["solver"] != "direct":
        return None
    us = t.device_us(*SPANS) / ctx.run.steps
    if us <= 0:
        return None
    n = int(ctx.cell.traffic["n"])
    return 100.0 * yardstick.direct_step_seconds(n) * 1e6 / us
