"""1 - the union of the device's busy intervals (kernels, copies, memsets)
over the traced window, in an anchor cell (%)."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "anchor" or t is None or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
