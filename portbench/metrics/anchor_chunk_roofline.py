"""The anchor chunks' least bytes over the card's memory rate, as a share of
the device time of all their kernels (library sorts, gathers and scatters
with the hand-written ones; copies to and from the host apart), from the
profiler's trace of the window (%).  The least bytes: roofline.py."""

from portbench.roofline import PEAK_BYTES_PER_S


def read(ctx):
    t = ctx.trace
    if ctx.kind != "anchor" or t is None or not t.kernel_s or not ctx.least_bytes:
        return None
    return 100.0 * ctx.least_bytes / PEAK_BYTES_PER_S / t.kernel_s
