"""gflops: the upstream's FLOP model, (29 N^2 + 19 N) a step with N
unpadded, times the steps of the window's whole blocks, over its wall time.
Direct cells only: the model counts all pairs."""

from harness import yardstick


def read(ctx):
    run = ctx.run
    if ctx.cell.config["solver"] != "direct" or not run.steps:
        return None
    n = int(ctx.cell.traffic["n"])
    return yardstick.step_flops(n) * run.steps / run.seconds * 1e-9
