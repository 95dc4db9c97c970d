"""deposit_roofline: the CIC deposit's least time a step over its measured
time.  Least: each body's position and mass read (16 bytes) and the ng^3
float32 grid written (4 bytes a point), once, at the memory peak
(``harness/yardstick.py``); one deposit a step, as semi-implicit Euler
evaluates the force once a step.  Measured: the device time a step inside
the span around the deposit (``pm._deposit``: the hand kernel of
``csrc/deposit.cu`` on the card)."""

from harness import yardstick

SPANS = {"mesh.deposit": "nbody_tpu_torch.ops.pm:_deposit"}

# Bytes of one deposit: a body's float32 position and mass read, a grid
# point's float32 written.
BYTES_PER_BODY = 16
BYTES_PER_POINT = 4


def least_seconds(n: int, grid: int) -> float:
    """The least time of one deposit of ``n`` bodies on a ``grid``^3 mesh:
    no arithmetic to speak of, so the bytes bound it."""
    return yardstick.least_seconds(
        0.0, BYTES_PER_BODY * n + BYTES_PER_POINT * grid ** 3)


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    us = t.device_us(*SPANS) / ctx.run.steps
    if us <= 0:
        return None
    least = least_seconds(int(ctx.cell.traffic["n"]), ctx.cell.config["grid"])
    return 100.0 * least * 1e6 / us
