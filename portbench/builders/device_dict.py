"""The `index --device-dict` build on the device: every genome's
chromosomes streamed through ops.devdict.DeviceDictBuilder
(pipeline.build_dict_device's calls), the dictionary brought to the host,
then laid out from it as pipeline.layout_stage lays out a mixed
dictionary (ops.lookup.BucketedDict.build_device, sorted input).

The build runs inside a recording of the program's spans and counters
(panagram_tpu_torch.spans); `LAST` keeps its totals and the key count,
numbers only, for the cell's `setup.devdict.*` metrics.
"""

from __future__ import annotations

import contextlib
import sys
import time

# the last build's {"totals": spans.Recording.totals(), "keys": D}, or None
LAST = None


def build(genomes, cfg: dict, device, span=None):
    """The table of `genomes` (each a chromosome list or one array);
    `span(name)` (a context manager) wraps each step, which ends with the
    device idle."""
    global LAST
    import torch
    from panagram_tpu_torch import spans
    from panagram_tpu_torch.ops import devdict, lookup

    from portbench.kinds.anchor import chromosomes

    span = span or (lambda _name: contextlib.nullcontext())
    k, n = cfg["k"], len(genomes)
    chrs = [chromosomes(g) for g in genomes]
    LAST = None

    def idle():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    with spans.recording() as rec:
        with span("build.dict"):
            # pipeline.build_dict_device's hint: the largest genome, x 1.5
            hint = int(1.5 * max(sum(len(c) for c in cs) for cs in chrs))
            b = devdict.DeviceDictBuilder(k, n, capacity_hint=hint,
                                          device=device)
            for gid, cs in enumerate(chrs):
                for c in cs:
                    b.add_sequence(gid, c)
                b.synced_count()
            pan = b.to_host()
            walls = dict(b.walls)
            del b
            idle()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        t1 = time.perf_counter()
        with span("build.layout"):
            bd = lookup.BucketedDict.build_device(
                pan.keys, pan.masks, n, k, mixed=True, sorted_input=True,
                device=device)
            (table,) = bd.device_arrays(device=device)
            idle()
    t2 = time.perf_counter()
    LAST = {"totals": rec.totals(), "keys": len(pan)}
    print(f"portbench: setup: build.dict {t1 - t0:.3f} s ({len(pan)} keys x "
          f"{pan.nwords} words; {walls['flushes']} merges; walls "
          + ", ".join(f"{key} {v:.3f}" for key, v in walls.items()
                      if key != "flushes")
          + f"), build.layout {t2 - t1:.3f} s", file=sys.stderr, flush=True)
    return bd, table, pan
