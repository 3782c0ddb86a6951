"""The harness's host-clock span around each build's layout step (ended by
torch.cuda.synchronize), summed over the window, as a share of the window
(%)."""


def read(ctx):
    s = ctx.window.spans.get("build.layout")
    if ctx.kind != "build" or s is None:
        return None
    return 100.0 * s / ctx.window.seconds
