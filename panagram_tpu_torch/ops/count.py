"""Per-genome canonical k-mer sets (sort-based counting).

The counting stage of the index build: each sequence's canonical k-mers
are reduced to a sorted distinct set on the device (``torch.unique``, a
sort plus neighbour compare), chunk by chunk.  Invalid windows are dropped
before the sort, so no sentinel has to sort anywhere.  A FASTQ read set is
counted with multiplicities instead (``counted_kmers_chunked``), and only
k-mers seen at least ``min_count`` times across all reads are kept.

Device memory stays bounded by the chunk size, not the genome's: every
SPILL_CHUNKS chunk sets are merged on the device by one more unique and
the result moves to the host, where the spilled groups are merged as
panagram_tpu.ops.count merges its chunk sets.

Spans (panagram_tpu_torch.spans), timed on the card: count.upload,
count.unique (packing and unique) and count.readback (a spill's copy to
the host).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spans
from .codec import check_k, pack_kmers, u64_np

DEFAULT_CHUNK = 1 << 22  # positions per device chunk
SPILL_CHUNKS = 4         # chunk sets held on the device before a spill


def distinct_kmers_chunked(code_arrays, k: int, chunk: int = DEFAULT_CHUNK,
                           *, device="cuda") -> np.ndarray:
    """Sorted distinct canonical k-mers (numpy uint64) over many sequences
    (a genome); the result of panagram_tpu.ops.count.distinct_kmers_chunked.
    Each sequence is cut into (k-1)-overlapping windows of `chunk`
    positions, each uploaded on its own."""
    check_k(k)
    cuda = torch.device(device).type == "cuda"
    group: list[torch.Tensor] = []
    spilled: list[np.ndarray] = []

    def spill():
        with spans.span("count.unique", device=cuda):
            merged = group[0] if len(group) == 1 else torch.unique(
                torch.cat(group), sorted=True)
        group.clear()
        with spans.span("count.readback", device=cuda):
            spilled.append(u64_np(merged))

    for codes in code_arrays:
        codes = np.asarray(codes, np.uint8)
        n = len(codes) - k + 1
        for start in range(0, max(n, 0), chunk):
            m = min(chunk, n - start)
            with spans.span("count.upload", device=cuda):
                window = torch.from_numpy(
                    codes[start:start + m + k - 1]).to(device)
            with spans.span("count.unique", device=cuda):
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


def distinct_kmers(codes, k: int, *, device="cuda") -> np.ndarray:
    """Sorted distinct canonical k-mers (numpy uint64) of one sequence,
    empty when it is shorter than k: panagram_tpu.ops.count.distinct_kmers,
    through distinct_kmers_chunked."""
    return distinct_kmers_chunked([np.asarray(codes, np.uint8)], k,
                                  device=device)


def _counted_unique(keys: torch.Tensor, counts: torch.Tensor):
    """Sorted distinct keys and the summed counts of each."""
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    return uniq, torch.zeros_like(uniq).index_add_(0, inv, counts)


def _merge_counted(parts):
    """Merge sorted (keys uint64, counts int64) host pairs: one stable sort
    of the concatenation (timsort merges the sorted runs) and segment sums,
    as panagram_tpu.ops.count._merge_counted."""
    if len(parts) == 1:
        return parts[0]
    allk = np.concatenate([p[0] for p in parts])
    allc = np.concatenate([p[1] for p in parts])
    if allk.size == 0:
        return allk, allc
    order = np.argsort(allk, kind="stable")
    ks = allk[order]
    cs = allc[order]
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    return ks[starts], np.add.reduceat(cs, starts)


def counted_kmers_chunked(code_arrays, k: int, min_count: int = 2,
                          chunk: int = DEFAULT_CHUNK, *,
                          device="cuda") -> np.ndarray:
    """Sorted distinct canonical k-mers (numpy uint64) that occur at least
    min_count times over many sequences (a FASTQ read set): the result of
    panagram_tpu.ops.count.counted_kmers_chunked, KMC's `-ci` semantics.

    Reads are packed into a buffer of chunk + k - 1 bases back to back,
    each followed by one invalid separator byte (none after a read that
    fills the buffer exactly), so no window spans two reads; a read longer
    than the buffer is cut into (k-1)-overlapping pieces of its own.  Each
    full buffer is counted on the device (torch.unique with counts); every
    SPILL_CHUNKS counted chunks are merged there and moved to the host,
    where the spilled groups are merged every SPILL_CHUNKS groups.  The
    threshold applies to the global count across all chunks."""
    check_k(k)
    cuda = torch.device(device).type == "cuda"
    cap = chunk + k - 1
    buf = np.full(cap, 255, np.uint8)
    pos = 0
    group: list[tuple[torch.Tensor, torch.Tensor]] = []
    spilled: list[tuple[np.ndarray, np.ndarray]] = []

    def spill():
        with spans.span("count.unique", device=cuda):
            ks, cs = group[0] if len(group) == 1 else _counted_unique(
                torch.cat([g[0] for g in group]),
                torch.cat([g[1] for g in group]))
        group.clear()
        with spans.span("count.readback", device=cuda):
            spilled.append((u64_np(ks), cs.cpu().numpy()))
        if len(spilled) > SPILL_CHUNKS:
            spilled[:] = [_merge_counted(spilled)]

    def flush():
        nonlocal pos
        if pos == 0:
            return
        # the buffer's tail past pos holds only invalid windows: upload the
        # filled prefix alone
        with spans.span("count.upload", device=cuda):
            window = torch.from_numpy(buf[:min(pos, cap)]).to(device)
        pos = 0
        with spans.span("count.unique", device=cuda):
            canon, valid = pack_kmers(window, k)
            keys, counts = torch.unique(canon[valid], sorted=True,
                                        return_counts=True)
        group.append((keys, counts))
        if len(group) == SPILL_CHUNKS:
            spill()

    for codes in code_arrays:
        codes = np.asarray(codes, np.uint8)
        n = len(codes)
        if n < k:
            continue
        if n > cap:
            flush()
            for s0 in range(0, n - k + 1, chunk):
                piece = codes[s0:s0 + cap]
                buf[:len(piece)] = piece
                pos = len(piece)
                flush()
            continue
        if pos + n + 1 > cap:
            flush()
        buf[pos:pos + n] = codes
        if pos + n < cap:
            buf[pos + n] = 255
        pos += n + 1
    flush()
    if group:
        spill()
    if not spilled:
        return np.zeros(0, np.uint64)
    keys, counts = _merge_counted(spilled)
    return keys[counts >= min_count]
