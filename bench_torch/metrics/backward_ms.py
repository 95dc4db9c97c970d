"""backward_ms: the device milliseconds a rollout step of the gradient's
backward: the work launched while the driver's ``torch.autograd.grad``
call ran (its ``bench:backward`` range), from whichever host thread
launched it (autograd's own, on the card).  That is the forward's
recomputation under rematerialisation, the mesh's adjoint (the cuFFT
backward, the deposit's and gather's transposes) and the short-range VJP.
None where the stretch ran no backward."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    us = t.launched_us("backward")
    return us * 1e-3 / ctx.run.steps if us > 0 else None
