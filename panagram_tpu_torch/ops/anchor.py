"""Anchoring: every position of an anchor genome -> its presence mask.

The dense chunk (``anchor_chunk_fast``, panagram_tpu's name and order;
its padded body ``_anchor_chunk_padded`` serves the stream): pack_mix
turns a 2-bit packed chunk into mixed query pairs, the merge probe
(lookup.bucket_query_sorted_pre, around the probe_sorted kernel) finds
each position's mask row, and one pass each gives the popcounts with
per-genome column sums and the bitmap bytes.  All four device steps are
the kernels of ops/kernels.py.  ``anchor_chunk`` is panagram_tpu's other
chunk step, over a sorted dictionary (``anchor_lookup``).

panagram_tpu ships run-length forms of the same result (its v3/v4
protocols) because its TPU's device-to-host link was slow; this engine
copies the dense bytes back.

``stream_anchor_chunks`` drives a chromosome through fixed-size chunks:
host packing into a pinned staging buffer, the chunk's work on a side
CUDA stream, and a ring of PIPELINE_DEPTH chunks in flight, so the host
consumes one chunk (BGZF writes, histograms) while the card computes the
next.  Its steps are spans of ``panagram_tpu_torch.spans``; the packing's
and the copy-back's (the card's time between events around the three
copies, read once the chunk's results are waited for anyway) also go to
the caller's ``phase``.
"""

from __future__ import annotations

import contextlib
import sys
from collections import deque

import numpy as np
import torch

from .. import spans
from . import kernels
from .codec import SENTINEL, flip64, pack_bases_np, pack_kmers
from .kernels import masks_to_bytes  # noqa: F401  (panagram_tpu's ops.anchor name)
from .lookup import TILE_Q, bucket_query_sorted_pre, plain_table

PIPELINE_DEPTH = 2
# rows per fused_popcount_colsums launch in genome_column_sums: its int32
# column sums cannot wrap below 2^31 rows
COLSUM_ROWS = (1 << 31) - 1


def _anchor_chunk_padded(packed: torch.Tensor, nmask: torch.Tensor, L: int,
                         k: int, table: torch.Tensor, nbits: int, cap: int,
                         nwords: int, nbytes: int):
    """One dense chunk: packed bases of L positions -> (bitmap bytes uint8
    [Ppad, nbytes], popc int32 [Ppad], colsums int32 [32W]) for the
    P = L-k+1 k-mer positions, padded to Ppad (a multiple of TILE_Q) with
    zero rows.  Column sums cover all 32W bit columns; the caller keeps the
    first N."""
    P = L - k + 1
    Ppad = -(-P // TILE_Q) * TILE_Q
    mhi, mlo = kernels.pack_mix(packed, nmask, L, k, Ppad)
    rows = bucket_query_sorted_pre(mhi, mlo, None, table, nbits, cap, nwords,
                                   Ppad)
    popc, colsums = kernels.fused_popcount_colsums(rows, 32 * nwords)
    by = kernels.masks_to_bytes(rows, nbytes)
    return by, popc, colsums


def anchor_chunk_fast(packed: torch.Tensor, nmask: torch.Tensor, table,
                      L: int, k: int, nbits: int, cap: int, nwords: int,
                      nbytes: int):
    """panagram_tpu's dense chunk: packed bases of L positions (pack_bases_np
    layout, on the device) against the bucket table (plain or packed-row)
    -> (bitmap bytes uint8 [P, nbytes], popc int32 [P], colsums int64
    [32W]) for the P = L-k+1 positions.  The four kernels of
    _anchor_chunk_padded; the rows are views of its padded results, and
    nothing is read back to the host."""
    P = L - k + 1
    by, popc, colsums = _anchor_chunk_padded(
        packed, nmask, L, k, plain_table(table, nbits, packed.device), nbits,
        cap, nwords, nbytes)
    return by[:P], popc[:P], colsums.to(torch.int64)


def anchor_chunk(codes: torch.Tensor, keys: torch.Tensor, masks: torch.Tensor,
                 k: int):
    """panagram_tpu's sorted-dictionary chunk step: codes uint8 [CH + k - 1]
    -> (mask rows int32 [CH, W], popc int32 [CH]) against keys int64 [D]
    sorted in unsigned order (SENTINEL pads at the tail) and masks int32
    [D, W]: pack_kmers, anchor_lookup and mask_popcount (the
    fused_popcount_colsums kernel on a CUDA device)."""
    canon, _ = pack_kmers(codes, k)
    rows = anchor_lookup(canon, keys, masks)
    return rows, mask_popcount(rows)


def pack_bases_combined(codes: np.ndarray):
    """pack_bases_np's two arrays in one host buffer: (inbuf uint8
    [ceil(L/4) + ceil(L/8)], L), panagram_tpu's single-transfer layout."""
    packed, nmask, L = pack_bases_np(codes)
    return np.concatenate([packed, nmask]), L


def anchor_lookup(canon: torch.Tensor, keys: torch.Tensor,
                  masks: torch.Tensor) -> torch.Tensor:
    """The sorted-dictionary lookup of panagram_tpu.ops.anchor.anchor_lookup:
    canonical k-mers int64 [P] (u64 bits) against keys int64 [D] sorted in
    unsigned order (SENTINEL pads at the tail) with masks int32 [D, W] ->
    mask rows int32 [P, W], a row of 0 where the k-mer is not a key or is
    SENTINEL.  The search runs on flip64 of both sides, whose signed order
    is the keys' unsigned order."""
    P, W = canon.shape[0], masks.shape[1]
    if keys.shape[0] == 0:
        return masks.new_zeros(P, W)
    idx = torch.searchsorted(flip64(keys), flip64(canon))
    idx.clamp_(max=keys.shape[0] - 1)
    hit = (keys[idx] == canon) & (canon != SENTINEL)
    return torch.where(hit[:, None], masks[idx], 0)


def mask_popcount(rows: torch.Tensor) -> torch.Tensor:
    """Set bits of each mask row int32 [P, W] -> int32 [P], through the
    fused_popcount_colsums kernel (no column sums)."""
    return kernels.fused_popcount_colsums(rows, 0)[0]


def genome_column_sums(rows: torch.Tensor, ngenomes: int) -> torch.Tensor:
    """Rows with genome bit g set, for g < ngenomes: int64 [ngenomes],
    through the fused_popcount_colsums kernel.  Inputs of COLSUM_ROWS rows
    or more go in pieces whose int32 sums are added in int64."""
    sums = torch.zeros(ngenomes, dtype=torch.int64, device=rows.device)
    for s in range(0, rows.shape[0], COLSUM_ROWS):
        sums += kernels.fused_popcount_colsums(rows[s:s + COLSUM_ROWS],
                                               ngenomes)[1]
    return sums


def occupancy_histogram(popc: torch.Tensor, binlen: int, nbins: int,
                        ngenomes: int) -> torch.Tensor:
    """Per-bin occupancy histograms int32 [nbins, ngenomes + 1]: position p
    of popc int32 [P] counts in bin p // binlen at its popcount; negative
    entries (pads of -1) are ignored.  panagram_tpu's version drops or
    misbins positions past nbins * binlen and popcounts above ngenomes; here
    they raise ValueError."""
    P = popc.shape[0]
    if P > nbins * binlen:
        raise ValueError(f"occupancy_histogram: {P} positions do not fit "
                         f"{nbins} bins of {binlen}")
    if P and int(popc.max()) > ngenomes:
        raise ValueError(f"occupancy_histogram: a popcount of "
                         f"{int(popc.max())} with {ngenomes} genomes")
    cells = nbins * (ngenomes + 1)
    bins = torch.arange(P, device=popc.device) // binlen
    flat = torch.where(popc >= 0, bins * (ngenomes + 1) + popc, cells)
    hist = torch.bincount(flat, minlength=cells + 1)[:cells]
    return hist.to(torch.int32).reshape(nbins, ngenomes + 1)


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
        # marks the results complete
        self.ready = torch.cuda.Event() if cuda else None


def stream_anchor_chunks(codes: np.ndarray, nkmers: int, chunk: int,
                         buf: np.ndarray | None, table, bd, nbytes: int,
                         ngenomes: int, k: int, state: dict | None = None,
                         capacity: int | None = None, trace: bool = False, *,
                         phase: dict | None = None):
    """Anchor one sequence's codes (uint8, >= 4 invalid) against `table`
    (bd.device_arrays()'s table, on the compute device; None: bd.table) of
    the BucketedDict `bd`, with panagram_tpu's parameters.  `buf` is the
    host staging array of chunk + k - 1 bytes (None: one is made).  Yields
    (start, m, bitmap bytes uint8 [m, nbytes], popc int32 [m], colsums
    int64 [ngenomes]) per chunk of `chunk` positions, in order.  The arrays
    are views of reused buffers, valid until the next item is requested.

    `state` and `capacity` size panagram_tpu's run-length transfers (its
    hints across chromosomes, the run capacity); this engine copies the
    dense bytes back, so they change nothing here.  trace=True prints each
    chunk's wait for its results (its anchor.drain span) to stderr.
    `phase`, when given, gains seconds under "pack" (the host packing the
    chunks into their staging buffers: the anchor.pack spans) and "copy"
    (the copy-back of the results, anchor.copyback: on a CUDA device the
    card's time between events on the chunk's stream, on the CPU the
    host's).

    Spans: anchor.alloc (once a call), anchor.pack, anchor.dispatch (the
    host enqueueing the chunk's upload, kernels and copies), anchor.copyback
    and anchor.drain (the host waiting for the chunk's results).  Counters:
    anchor.positions_yielded and anchor.positions_computed (the padded
    positions the kernels ran)."""
    phase = {} if phase is None else phase
    phase.setdefault("pack", 0.0)
    phase.setdefault("copy", 0.0)
    with spans.span("anchor.alloc"):
        if table is None:
            table = bd.table
        table = plain_table(table, bd.nbits, getattr(table, "device", "cpu"))
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
        if buf is None or len(buf) < L:
            buf = np.empty(L, np.uint8)
        buf = buf[:L]
    pending: deque = deque()

    def launch(slot: _Slot):
        ib = slot.inbuf.to(device, non_blocking=True)
        by, popc, colsums = _anchor_chunk_padded(ib[:n4], ib[n4:], L, k,
                                                 table, bd.nbits, bd.cap,
                                                 bd.nwords, nbytes)
        with spans.span("anchor.copyback", device=cuda, phase=phase,
                        key="copy"):
            slot.by.copy_(by, non_blocking=True)
            slot.popc.copy_(popc, non_blocking=True)
            slot.colsums.copy_(colsums, non_blocking=True)
        if cuda:
            slot.ready.record(stream)

    def finish(start: int, m: int, slot: _Slot):
        wait = {"s": 0.0} if trace else None
        with spans.span("anchor.drain", phase=wait, key="s"):
            if cuda:
                slot.ready.synchronize()
                spans.settle()
        if trace:
            print(f"  drain: start={start} m={m} "
                  f"wait={1e3 * wait['s']:.0f}ms",
                  file=sys.stderr, flush=True)
        spans.count("anchor.positions_yielded", m)
        return (start, m, slot.by.numpy()[:m], slot.popc.numpy()[:m],
                slot.colsums.numpy()[:ngenomes].astype(np.int64))

    try:
        for i, start in enumerate(range(0, nkmers, chunk)):
            m = min(chunk, nkmers - start)
            with spans.span("anchor.pack", phase=phase, key="pack"):
                buf[:] = 255   # invalid bases: positions past m never hit
                buf[:m + k - 1] = codes[start:start + m + k - 1]
                packed, nmask, _ = pack_bases_np(buf)
                # slot i % DEPTH last held chunk i - DEPTH, which was
                # yielded and consumed before this request
                slot = slots[i % PIPELINE_DEPTH]
                inb = slot.inbuf.numpy()
                inb[:n4] = packed
                inb[n4:] = nmask
            with spans.span("anchor.dispatch"):
                with torch.cuda.stream(stream) if cuda else \
                        contextlib.nullcontext():
                    launch(slot)
            spans.count("anchor.positions_computed", Ppad)
            pending.append((start, m, slot))
            if len(pending) >= PIPELINE_DEPTH:
                yield finish(*pending.popleft())
        while pending:
            yield finish(*pending.popleft())
    finally:
        if cuda:
            stream.synchronize()
            spans.settle()
