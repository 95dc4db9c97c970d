"""setup_s: process start to the window's start (imports, the kernel build
or load, the initial state, the P3M plan, the warm block), host clock."""


def read(ctx):
    return ctx.setup_s
