"""Bucketed-hash dictionary lookup: table layout, gather probe, merge probe.

Keys pass through the invertible splitmix64 finalizer, so their high bits
are uniform.  The table is 2^nbits buckets, each a row of `stride` u32
holding `cap` slots of (key_hi, key_lo, W mask words); empty slots are all
ones.  There is no overflow structure: the layout retries with more
buckets until every bucket fits, so one row read resolves every query.

The table is stored as int32 [B, stride] (u32 bit patterns).  panagram_tpu
packs adjacent buckets into 128-lane rows for the TPU's tiling; that form
converts here with ``BucketedDict.from_jax_state``.

Two probes return the same rows:

* ``bucket_query`` gathers each query's bucket row (plain torch; the fixup
  and fallback of the merge probe);
* ``bucket_query_sorted_pre`` sorts the queries by their high word, so each
  tile of TILE_Q queries reads a narrow window of table rows, and runs the
  ``probe_sorted`` kernel (ops/kernels.py).  Queries whose bucket lies
  outside their tile's window (only with a window narrower than the
  default, see plan_probe) are fixed up by the gather probe, and when there
  are too many of those the whole batch takes the gather probe, so the
  result is exact under any key skew.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import kernels
from .codec import MIX_M1, MIX_M2, mix64, u32  # noqa: F401  (mix64 re-exported)

U64 = np.uint64
_SENTINEL32 = np.uint32(0xFFFFFFFF)

# queries per merge-probe tile (the unit that shares one window of rows)
TILE_Q = 1024
# device memory kept free beside the table for the anchor chunk's buffers
# (a 2^22-position chunk's sort, probe and the gather fallback's row copy)
ANCHOR_RESERVE_BYTES = 3 << 30


def mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (invertible on u64)."""
    x = x.astype(U64, copy=True)
    x ^= x >> U64(30)
    x *= U64(MIX_M1)
    x ^= x >> U64(27)
    x *= U64(MIX_M2)
    x ^= x >> U64(31)
    return x


def table_geometry(D: int, W: int, mean_load: int | None = None):
    """Bucket-table geometry for D keys x W mask words: (nbits, cap,
    stride), the sizing rule of panagram_tpu.ops.lookup.table_geometry."""
    if mean_load is None:
        mean_load = BucketedDict.MEAN_LOAD
    slot_w = 2 + W
    stride = 64
    while stride // slot_w < 3 * mean_load:
        stride += 64
    cap = stride // slot_w
    nbits = max(int(np.ceil(np.log2(max(D / mean_load, 1)))), 2)
    return nbits, cap, stride


def check_hbm_budget(table_bytes: int, device, what: str = "dictionary"):
    """Raise before allocating when a table of table_bytes plus
    ANCHOR_RESERVE_BYTES of chunk buffers exceeds the free memory of the
    CUDA `device` (torch.cuda.mem_get_info).  A CPU device is not checked."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    free, total = torch.cuda.mem_get_info(device)
    need = table_bytes + ANCHOR_RESERVE_BYTES
    if need > free:
        raise RuntimeError(
            f"{what}: needs ~{need / 1e9:.1f} GB of device memory (bucket "
            f"table {table_bytes / 1e9:.1f} GB + "
            f"{ANCHOR_RESERVE_BYTES / 1e9:.1f} GB of chunk buffers) but "
            f"{free / 1e9:.1f} of {total / 1e9:.1f} GB are free on {device}")


@dataclasses.dataclass
class BucketedDict:
    """Single-probe bucketed hash layout of a pan-kmer dictionary.

    `table` is numpy uint32 [2^nbits, stride] after build(), or an int32
    tensor of the same shape and bits after to(device)."""

    table: object
    nbits: int
    cap: int
    stride: int
    ngenomes: int
    k: int
    nwords: int

    MEAN_LOAD = 6

    @classmethod
    def build(cls, keys: np.ndarray, masks: np.ndarray, ngenomes: int,
              k: int, mixed: bool = False) -> "BucketedDict":
        """Host (numpy) layout.  keys: distinct u64 keys, canonical or, with
        mixed=True, already splitmix64-mixed; masks u32 [D, W]."""
        D = max(len(keys), 1)
        W = masks.shape[1] if masks.ndim == 2 else 1
        masks = masks.reshape(len(keys), W)
        m = keys.astype(U64) if mixed else mix64_np(keys.astype(U64))
        if np.any(m == U64(0xFFFFFFFFFFFFFFFF)):
            raise RuntimeError("key mixes to the reserved all-ones value")
        nbits, cap, stride = table_geometry(D, W)
        for _ in range(8):
            table, overflow = cls._layout(m, masks, nbits, cap, stride)
            if overflow == 0:
                return cls(table=table, nbits=nbits, cap=cap, stride=stride,
                           ngenomes=ngenomes, k=k, nwords=W)
            nbits += 1  # halve the mean load and retry
        raise RuntimeError("bucketed dict: bucket overflow persisted after "
                           "8 doublings — pathological key distribution")

    @staticmethod
    def _layout(mixed, masks, nbits, cap, stride):
        B = 1 << nbits
        W = masks.shape[1]
        slot_w = 2 + W
        bucket = (mixed >> U64(64 - nbits)).astype(np.int64)
        order = np.argsort(bucket, kind="stable")
        b_sorted = bucket[order]
        counts = np.bincount(b_sorted, minlength=B)
        overflow = int(np.maximum(counts - cap, 0).sum())
        if overflow:
            return None, overflow
        offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
        slot = np.arange(len(mixed)) - offsets[b_sorted]

        table = np.full((B, stride), _SENTINEL32, np.uint32)
        m_sorted = mixed[order]
        rows = np.empty((len(mixed), slot_w), np.uint32)
        rows[:, 0] = (m_sorted >> U64(32)).astype(np.uint32)
        rows[:, 1] = (m_sorted & U64(0xFFFFFFFF)).astype(np.uint32)
        rows[:, 2:] = masks[order]
        view = table[:, : cap * slot_w].reshape(B, cap, slot_w)
        view[b_sorted, slot] = rows
        return table, 0

    @classmethod
    def from_jax_state(cls, table_np: np.ndarray, nbits: int, cap: int,
                       stride: int, ngenomes: int, k: int,
                       nwords: int) -> "BucketedDict":
        """panagram_tpu's table as numpy, plain [B, stride] or packed-row
        [B/pack, stride*pack] (BucketedDict.device_arrays) -> this package's
        [B, stride] table.  A packed row holds `pack` adjacent buckets in
        order, so the row-major reshape is exactly the plain layout."""
        B = 1 << nbits
        t = np.asarray(table_np)
        if t.size != B * stride or t.ndim != 2 or t.shape[1] % stride:
            raise ValueError(f"table of shape {t.shape} is not a layout of "
                             f"{B} buckets x {stride} u32")
        return cls(table=np.ascontiguousarray(t, np.uint32).reshape(B, stride),
                   nbits=nbits, cap=cap, stride=stride, ngenomes=ngenomes,
                   k=k, nwords=nwords)

    def to(self, device) -> "BucketedDict":
        """The same layout with `table` as an int32 tensor on `device`."""
        t = self.table
        if isinstance(t, np.ndarray):
            check_hbm_budget(t.nbytes, device, what="bucketed dict")
            t = torch.from_numpy(np.array(t, np.uint32).view(np.int32))
        return dataclasses.replace(self, table=t.to(device))


def bucket_row(hi: torch.Tensor, nbits: int) -> torch.Tensor:
    """Bucket index (int64) of each query: the top nbits of its hi word."""
    if not 1 <= nbits <= 32:
        raise ValueError(f"nbits={nbits}: the probes take 1..32 bucket bits")
    return u32(hi) >> (32 - nbits)


def bucket_query(mhi: torch.Tensor, mlo: torch.Tensor, table: torch.Tensor,
                 nbits: int, cap: int, nwords: int) -> torch.Tensor:
    """Mixed query pairs (int32 [Q] each) -> mask rows int32 [Q, W] by one
    row gather per query.  Misses, all-ones pairs included, give 0."""
    rows = table[bucket_row(mhi, nbits)]
    return kernels.match_slots(rows, mhi, mlo, cap, nwords)


@dataclasses.dataclass
class ProbePlan:
    """Sorted queries and the window geometry of the merge probe."""

    qhi: torch.Tensor      # int32 [Qp] hi words, ascending as u32
    qlo: torch.Tensor      # int32 [Qp]
    perm: torch.Tensor     # int64 [Qp]: sorted slot -> input index
    blo: torch.Tensor      # int32 [Qp / tile_q]: first table row per tile
    span: int              # table rows per tile window
    tile_q: int
    out_span: torch.Tensor  # bool [Qp]: query outside its tile's window


def plan_probe(mhi0: torch.Tensor, mlo0: torch.Tensor, nbits: int,
               span: int | None = None, tile_q: int = TILE_Q) -> ProbePlan:
    """Sort the queries on their hi word (as u32; ties need no order, the
    probe compares the full pair) and place each tile's window.

    By default the window is as wide as the widest bucket range any tile
    covers, so every query is in its window.  The TPU kernel copied the
    window into its 4 MB VMEM and so had to cap it (1.5x the mean range,
    leaving a tail for the fixup); this kernel reads rows straight from
    device memory, where a wider window costs nothing.  That also keeps
    the fast path under skew, such as the many identical N-window queries
    of a gappy assembly, which widen the other tiles' ranges.  An explicit
    `span` narrows the window (the tests use it to reach the fixup)."""
    B = 1 << nbits
    Qp = mhi0.shape[0]
    if Qp % tile_q:
        raise ValueError(f"query count {Qp} is not a multiple of {tile_q}")
    # signed order of (hi ^ 0x80000000) is the unsigned order of hi
    _, perm = torch.sort(mhi0 ^ torch.iinfo(torch.int32).min)
    qhi = mhi0[perm]
    qlo = mlo0[perm]
    brow = bucket_row(qhi, nbits)
    first = brow[::tile_q]
    # all-ones pairs never match, so they are exempt from the window
    is_pad = (qhi == -1) & (qlo == -1)
    if span is None:
        last = torch.where(is_pad, first.repeat_interleave(tile_q), brow)
        span = int((last.view(-1, tile_q).amax(dim=1) - first).max()) + 1 \
            if Qp else 1
    span = min(max(span, 1), B)
    blo = torch.clamp(first, 0, B - span)
    out_span = ~(((brow - blo.repeat_interleave(tile_q)) < span) | is_pad)
    return ProbePlan(qhi, qlo, perm, blo.to(torch.int32), span, tile_q,
                     out_span)


def bucket_query_sorted_pre(mhi0: torch.Tensor, mlo0: torch.Tensor,
                            table: torch.Tensor, nbits: int, cap: int,
                            nwords: int, out_len: int,
                            span: int | None = None,
                            tile_q: int = TILE_Q) -> torch.Tensor:
    """Merge probe of mixed query pairs in any order: mhi0/mlo0 int32 [Qp]
    (all-ones pairs are padding; Qp % tile_q == 0) -> mask rows int32
    [out_len, W], row i answering query i."""
    Qp = mhi0.shape[0]
    plan = plan_probe(mhi0, mlo0, nbits, span, tile_q)
    fixup = max(Qp >> 6, tile_q)
    idx_out = torch.nonzero(plan.out_span).squeeze(1)
    if idx_out.shape[0] <= fixup:
        rows = kernels.probe_sorted(plan.qhi, plan.qlo, plan.blo, table,
                                    nbits, cap, nwords, plan.span,
                                    plan.tile_q)
        if idx_out.shape[0]:
            rows[idx_out] = bucket_query(plan.qhi[idx_out],
                                         plan.qlo[idx_out], table, nbits,
                                         cap, nwords)
        out = torch.empty_like(rows)
        out[plan.perm] = rows      # inverse permutation
    else:
        out = bucket_query(mhi0, mlo0, table, nbits, cap, nwords)
    return out[:out_len]
