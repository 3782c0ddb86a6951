"""From the start of the process to the window's start (host clock)."""


def read(ctx):
    return ctx.setup_s
