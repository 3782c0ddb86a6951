"""The stream's own `copy` timer (CUDA events around the copies of the
results back to the host, on the chunk's stream), summed over the window,
as a share of the window (%).  Only on the card: on the CPU the timer reads
the host."""


def read(ctx):
    if ctx.kind != "anchor" or not ctx.cuda or "copy" not in ctx.window.phase:
        return None
    return 100.0 * ctx.window.phase["copy"] / ctx.window.seconds
