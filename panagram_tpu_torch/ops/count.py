"""Per-genome distinct canonical k-mer sets (sort-based counting).

The counting stage of the index build: each sequence's canonical k-mers
are reduced to a sorted distinct set on the device (``torch.unique``, a
sort plus neighbour compare), chunk by chunk.  Invalid windows are dropped
before the sort, so no sentinel has to sort anywhere.

Device memory stays bounded by the chunk size, not the genome's: every
SPILL_CHUNKS chunk sets are merged on the device by one more unique and
the result moves to the host, where the spilled groups are merged as
panagram_tpu.ops.count merges its chunk sets.
"""

from __future__ import annotations

import numpy as np
import torch

from .codec import check_k, pack_kmers, u64_np

DEFAULT_CHUNK = 1 << 22  # positions per device chunk
SPILL_CHUNKS = 4         # chunk sets held on the device before a spill


def distinct_kmers_chunked(code_arrays, k: int, device="cpu",
                           chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """Sorted distinct canonical k-mers (numpy uint64) over many sequences
    (a genome); the result of panagram_tpu.ops.count.distinct_kmers_chunked.
    Each sequence is cut into (k-1)-overlapping windows of `chunk`
    positions, each uploaded on its own."""
    check_k(k)
    group: list[torch.Tensor] = []
    spilled: list[np.ndarray] = []

    def spill():
        merged = group[0] if len(group) == 1 else torch.unique(
            torch.cat(group), sorted=True)
        group.clear()
        spilled.append(u64_np(merged))

    for codes in code_arrays:
        codes = np.asarray(codes, np.uint8)
        n = len(codes) - k + 1
        for start in range(0, max(n, 0), chunk):
            m = min(chunk, n - start)
            window = torch.from_numpy(codes[start:start + m + k - 1]).to(device)
            canon, valid = pack_kmers(window, k)
            group.append(torch.unique(canon[valid], sorted=True))
            if len(group) == SPILL_CHUNKS:
                spill()
    if group:
        spill()
    if not spilled:
        return np.zeros(0, np.uint64)
    if len(spilled) == 1:
        return spilled[0]
    return np.unique(np.concatenate(spilled))
