"""The `index` build's default route on the device: each genome's k-mer
set counted (ops.count.distinct_kmers_chunked), the sets merged
(ops.dictionary.build_dictionary), the dictionary laid out
(ops.lookup.BucketedDict.build_device)."""

from __future__ import annotations

import contextlib


def build(genomes, cfg: dict, device, span=None):
    """The table of `genomes`; `span(name)` (a context manager) wraps each
    step, which ends with the device idle."""
    import torch
    from panagram_tpu_torch.ops import count, dictionary, lookup

    span = span or (lambda _name: contextlib.nullcontext())
    k, n = cfg["k"], len(genomes)

    def idle():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with span("build.count"):
        sets = [count.distinct_kmers_chunked([g], k, device=device)
                for g in genomes]
        idle()
    with span("build.dict"):
        pan = dictionary.build_dictionary(sets, k, n, device=device)
        idle()
    with span("build.layout"):
        bd = lookup.BucketedDict.build_device(pan.keys, pan.masks, n, k,
                                              device=device)
        (table,) = bd.device_arrays(device=device)
        idle()
    return bd, table, pan
