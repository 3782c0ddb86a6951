"""k-mer positions the anchor stream yielded in the window, over the
window's whole time (host clock)."""


def read(ctx):
    if ctx.kind != "anchor":
        return None
    return ctx.window.positions / ctx.window.seconds
