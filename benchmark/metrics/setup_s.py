"""setup_s: process start to the window's first timed request (host clock)."""


def read(ctx):
    return ctx.setup_s
