"""95th percentile of one pass's wall over every pass of the traced
window, from the pass's first packing to its last yielded chunk (host
clock, ms)."""

import numpy as np


def read(ctx):
    if ctx.kind != "anchor" or not ctx.window.pass_walls:
        return None
    return float(np.percentile(ctx.window.pass_walls, 95)) * 1e3
