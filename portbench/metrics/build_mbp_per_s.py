"""Genome bases built (counted, merged and laid out) in the window, over
the window's whole time (host clock, Mbp/s)."""


def read(ctx):
    if ctx.kind != "build":
        return None
    return ctx.window.bases / 1e6 / ctx.window.seconds
