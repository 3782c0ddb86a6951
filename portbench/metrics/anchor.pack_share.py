"""The stream's own `pack` timer (host clock around the host's packing of
each chunk into its staging buffer), summed over the window, as a share of
the window (%)."""


def read(ctx):
    if ctx.kind != "anchor" or "pack" not in ctx.window.phase:
        return None
    return 100.0 * ctx.window.phase["pack"] / ctx.window.seconds
