"""device_idle: the share of the profiled stretch in which no kernel, copy
or set runs on the card (the union of device intervals), both read from one
trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
