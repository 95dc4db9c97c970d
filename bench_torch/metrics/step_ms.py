"""step_ms: the window's wall time over the steps of its whole blocks,
host clock; every block ends in the program's own sync."""


def read(ctx):
    run = ctx.run
    return 1e3 * run.seconds / run.steps if run.steps else None
