"""sr_vjp_roofline: the short-range sum's VJP, its least time a step over
its measured time.  Least: the unordered pairs inside the cutoff radius
(counted here in plain torch, on the first and last states the force saw
in the stretch's last gradient, the mean) at 66 flop (both sides'
position cotangents and r_c^2's) at the fp32 peak, or 40 bytes a body at
the memory peak if larger; measured: the device time a rollout step
inside the span around the VJP kernel's entry (``sr_kernel.sweep_vjp``,
which the sweep's backward looks up as a module global)."""

from harness import yardstick

SPANS = {"sr.vjp": "nbody_tpu_torch.ops.sr_kernel:sweep_vjp"}


def read(ctx):
    t = ctx.trace
    cfg = ctx.cell.config
    if t is None or "cutoff_cells" not in cfg or not ctx.run.steps:
        return None
    us = t.device_us(*SPANS) / ctx.run.steps
    if us <= 0:
        return None
    pairs, bodies = yardstick.mean_sr_pairs(ctx.stretch_states, cfg["grid"],
                                            cfg["cutoff_cells"])
    return 100.0 * yardstick.sr_vjp_step_seconds(pairs, bodies) * 1e6 / us
