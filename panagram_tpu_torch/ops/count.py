"""Per-genome distinct canonical k-mer sets (sort-based counting).

The counting stage of the index build: each sequence's canonical k-mers
are reduced to a sorted distinct set on the device (``torch.unique``, a
sort plus neighbour compare), chunk by chunk, and the chunk sets are merged
by one more unique.  Invalid windows are dropped before the sort, so no
sentinel has to sort anywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from .codec import check_k, pack_kmers, u64_np

DEFAULT_CHUNK = 1 << 22  # positions per device chunk


def distinct_kmers_chunked(code_arrays, k: int, device="cpu",
                           chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """Sorted distinct canonical k-mers (numpy uint64) over many sequences
    (a genome); the result of panagram_tpu.ops.count.distinct_kmers_chunked.
    Each sequence is uploaded once and cut into (k-1)-overlapping windows
    of `chunk` positions."""
    check_k(k)
    parts: list[torch.Tensor] = []
    for codes in code_arrays:
        codes = np.asarray(codes, np.uint8)
        n = len(codes) - k + 1
        if n <= 0:
            continue
        dev_codes = torch.from_numpy(codes).to(device)
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            canon, valid = pack_kmers(dev_codes[start:start + m + k - 1], k)
            parts.append(torch.unique(canon[valid], sorted=True))
    if not parts:
        return np.zeros(0, np.uint64)
    out = parts[0] if len(parts) == 1 else torch.unique(torch.cat(parts),
                                                        sorted=True)
    return u64_np(out)
