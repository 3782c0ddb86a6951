"""Anchoring: every position of an anchor genome -> its presence mask.

The dense chunk (``anchor_chunk``) is the data path of panagram_tpu's
``anchor_chunk_fast``: pack_mix turns a 2-bit packed chunk into mixed
query pairs, the merge probe (lookup.bucket_query_sorted_pre, around the
probe_sorted kernel) finds each position's mask row, and one pass each
gives the popcounts with per-genome column sums and the bitmap bytes.
All four device steps are the kernels of ops/kernels.py.

panagram_tpu ships run-length forms of the same result (its v3/v4
protocols) because its TPU's device-to-host link was slow; this engine
copies the dense bytes back.

``stream_anchor_chunks`` drives a chromosome through fixed-size chunks:
host packing into a pinned staging buffer, the chunk's work on a side
CUDA stream, and a ring of PIPELINE_DEPTH chunks in flight, so the host
consumes one chunk (BGZF writes, histograms) while the card computes the
next.
"""

from __future__ import annotations

import contextlib
from collections import deque

import numpy as np
import torch

from . import kernels
from .codec import pack_bases_np
from .lookup import TILE_Q, bucket_query_sorted_pre

PIPELINE_DEPTH = 2


def anchor_chunk(packed: torch.Tensor, nmask: torch.Tensor, L: int, k: int,
                 table: torch.Tensor, nbits: int, cap: int, nwords: int,
                 nbytes: int):
    """One dense chunk: packed bases of L positions -> (bitmap bytes uint8
    [Ppad, nbytes], popc int32 [Ppad], colsums int32 [32W]) for the
    P = L-k+1 k-mer positions, padded to Ppad (a multiple of TILE_Q) with
    zero rows.  Column sums cover all 32W bit columns; the caller keeps the
    first N."""
    P = L - k + 1
    Ppad = -(-P // TILE_Q) * TILE_Q
    mhi, mlo = kernels.pack_mix(packed, nmask, L, k, Ppad)
    rows = bucket_query_sorted_pre(mhi, mlo, table, nbits, cap, nwords, Ppad)
    popc, colsums = kernels.fused_popcount_colsums(rows, 32 * nwords)
    by = kernels.masks_to_bytes(rows, nbytes)
    return by, popc, colsums


class _Slot:
    """Host buffers of one in-flight chunk (pinned on a CUDA device, so the
    copies are asynchronous), and the event that marks its results ready."""

    def __init__(self, nin: int, Ppad: int, nbytes: int, ncols: int,
                 cuda: bool):
        def buf(*shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=cuda)

        self.inbuf = buf(nin, dtype=torch.uint8)
        self.by = buf(Ppad, nbytes, dtype=torch.uint8)
        self.popc = buf(Ppad, dtype=torch.int32)
        self.colsums = buf(ncols, dtype=torch.int32)
        self.ready = torch.cuda.Event() if cuda else None


def stream_anchor_chunks(codes: np.ndarray, nkmers: int, chunk: int, bd,
                         nbytes: int, ngenomes: int, k: int):
    """Anchor one sequence's codes (uint8, >= 4 invalid) against the table
    of `bd` (a BucketedDict whose table is on the compute device).  Yields
    (start, m, bitmap bytes uint8 [m, nbytes], popc int32 [m], colsums
    int64 [ngenomes]) per chunk of `chunk` positions, in order.  The arrays
    are views of reused buffers, valid until the next item is requested."""
    table = bd.table
    device = table.device
    cuda = device.type == "cuda"
    L = chunk + k - 1
    n4 = (L + 3) // 4
    Ppad = -(-chunk // TILE_Q) * TILE_Q
    slots = [_Slot(n4 + (L + 7) // 8, Ppad, nbytes, 32 * bd.nwords, cuda)
             for _ in range(PIPELINE_DEPTH)]
    stream = torch.cuda.Stream(device) if cuda else None
    if cuda:
        stream.wait_stream(torch.cuda.current_stream(device))
    buf = np.empty(L, np.uint8)
    pending: deque = deque()

    def launch(slot: _Slot):
        ib = slot.inbuf.to(device, non_blocking=True)
        by, popc, colsums = anchor_chunk(ib[:n4], ib[n4:], L, k, table,
                                         bd.nbits, bd.cap, bd.nwords, nbytes)
        slot.by.copy_(by, non_blocking=True)
        slot.popc.copy_(popc, non_blocking=True)
        slot.colsums.copy_(colsums, non_blocking=True)
        if cuda:
            slot.ready.record(stream)

    def finish(start: int, m: int, slot: _Slot):
        if cuda:
            slot.ready.synchronize()
        return (start, m, slot.by.numpy()[:m], slot.popc.numpy()[:m],
                slot.colsums.numpy()[:ngenomes].astype(np.int64))

    try:
        for i, start in enumerate(range(0, nkmers, chunk)):
            m = min(chunk, nkmers - start)
            buf[:] = 255   # invalid bases: positions past m never hit
            buf[:m + k - 1] = codes[start:start + m + k - 1]
            packed, nmask, _ = pack_bases_np(buf)
            # slot i % DEPTH last held chunk i - DEPTH, which was yielded
            # and consumed before this request
            slot = slots[i % PIPELINE_DEPTH]
            inb = slot.inbuf.numpy()
            inb[:n4] = packed
            inb[n4:] = nmask
            ctx = torch.cuda.stream(stream) if cuda else contextlib.nullcontext()
            with ctx:
                launch(slot)
            pending.append((start, m, slot))
            if len(pending) >= PIPELINE_DEPTH:
                yield finish(*pending.popleft())
        while pending:
            yield finish(*pending.popleft())
    finally:
        if cuda:
            stream.synchronize()
