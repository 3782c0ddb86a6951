"""Bucketed-hash dictionary lookup: table layout, gather probe, merge probe.

Keys pass through the invertible splitmix64 finalizer, so their high bits
are uniform.  The table is 2^nbits buckets, each a row of `stride` u32
holding `cap` slots of (key_hi, key_lo, W mask words); empty slots are all
ones.  There is no overflow structure: the layout retries with more
buckets until every bucket fits, so one row read resolves every query.

The table is stored as int32 [B, stride] (u32 bit patterns).  panagram_tpu
packs adjacent buckets into 128-lane rows for the TPU's tiling; that form
converts here with ``BucketedDict.from_jax_state``.

Three routes lay a dictionary out (``BucketedDict.build_device`` picks one
by the device's free memory, ``layout_route``):

* single: one pass on the device (``layout_rows``: sort, bincount, cumsum,
  one scatter per slot column);
* chunked: for keys already sorted in mixed space, bucket-range passes
  that write one preallocated table in place, so only one pass's
  transients are alive at a time (``_layout_device_chunked``);
* host: numpy (``BucketedDict.build``) and one upload, when the device
  layout's transients do not fit beside the table.

Two probes return the same rows, each under panagram_tpu's name and
contract over canonical (or, with pre_mixed, mixed) keys:

* ``bucket_query`` gathers each query's bucket row (plain torch; over split
  mixed pairs, ``bucket_query_pairs`` is the fixup and fallback of the
  merge probe);
* ``bucket_query_sorted`` and, over split mixed pairs in any order,
  ``bucket_query_sorted_pre`` sort the queries by their high word, so each
  tile of TILE_Q queries reads a narrow window of table rows, and runs the
  ``probe_sorted`` kernel (ops/kernels.py).  Queries whose bucket lies
  outside their tile's window (only with a window narrower than the
  default, see plan_probe) are fixed up by the gather probe, and when there
  are too many of those the whole batch takes the gather probe, so the
  result is exact under any key skew.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .. import spans
from . import kernels
from .codec import (  # noqa: F401  (mix64 re-exported)
    MIX_M1,
    MIX_M2,
    SENTINEL,
    as_signed64,
    flip64,
    from_u64_np,
    mix64,
    split64,
    srl,
    u32,
    u64_np,
)

logger = logging.getLogger(__name__)

U64 = np.uint64
_SENTINEL32 = np.uint32(0xFFFFFFFF)

# queries per merge-probe tile (the unit that shares one window of rows)
TILE_Q = 1024
# device memory kept free beside the table for the anchor chunk's buffers
# (a 2^22-position chunk's sort, probe and the gather fallback's row copy)
ANCHOR_RESERVE_BYTES = 3 << 30
# sorted rows per pass of the chunked device layout (its transients scale
# with this bound; panagram_tpu's PANAGRAM_TPU_LAYOUT_PIECE_ROWS default)
LAYOUT_PIECE_ROWS = 1 << 24


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


def _slot_peak(n: int, n_buckets: int) -> int:
    """Peak of the slot computation of layout_rows / _layout_piece over n
    rows and n_buckets buckets: bucket ids, slots and the gathered run
    starts (int64 [n] each) beside the bucket counts and run starts (int64
    [n_buckets + 1] each), or, while the starts are computed, two int64 [n]
    beside three bucket arrays (_layout_piece keeps a fourth int64 [n])."""
    b = 8 * (n_buckets + 1)
    return max(24 * n + 2 * b, 16 * n + 3 * b)


# a torch.sort of int64 [D] on the card holds six int64 [D]: its input, the
# sorted values, the indices, the iota it sorts beside the keys and the
# radix sort's alternate key and value buffers
_SORT_BYTES_PER_KEY = 48
# the scatter of _scatter_columns beside the table: the rows' flat offsets
# (int64) and the column being written (its int64 shift and the int32
# column)
_SCATTER_BYTES_PER_KEY = 20
# the small tensors beside the counted ones (pass bounds, the table's drop
# area, overflow sums) and the caching allocator's rounding of each block
# (up to 2 MiB a block)
_SMALL_BYTES = 16 << 20


def layout_bytes(D: int, W: int, mode: str,
                 piece_rows: int = LAYOUT_PIECE_ROWS,
                 n_buckets: int | None = None) -> int:
    """Device memory a layout of D keys x W mask words needs beside its
    table, counted from what layout_rows, _layout_piece and _piece_bounds
    allocate on that route: its inputs, then the larger of its two phases,
    which run one after the other (chip_smoke's layout phase checks the
    count on the card):

    * before the table is allocated: the grouping sorts and the slot
      computation (_slot_peak); only what exceeds the table, which is not
      there yet, counts beside it;
    * beside the table: the scatter (_SCATTER_BYTES_PER_KEY) and whatever
      sorted copies of the inputs are still alive.

    The modes, with (8 + 4W) B/key of keys and masks:

    * "sorted": input sorted in mixed space: no sort, no copies;
    * "sort": unsorted input: one sort, then sorted copies of keys and
      masks through the slot computation and the scatter;
    * "bucket": an explicit bucket per key (the range-sharded layout), an
      input too (8/key): two sorts, the second beside the masked bucket ids
      and the first sort's order (16/key), then the sorted copies and the
      bucket ids;
    * "chunked": sorted input laid out in passes: the flipped keys that
      place the passes (8/key) before the table, then one pass at a time
      beside it (_slot_peak over its rows and buckets and one int64 [n]
      more).  Mixed keys are uniform, so a pass holds its share of the
      rows within a fraction of a percent; 1/64 more is allowed for.

    n_buckets defaults to the table_geometry of D keys.  (The host layout
    needs nothing beside the table on the device.)"""
    nbits, _, stride = table_geometry(max(D, 1), W)
    if n_buckets is None:
        n_buckets = 1 << nbits
    table = (n_buckets * stride + 2 + W) * 4
    row = (8 + 4 * W) * D
    inputs = row + _SMALL_BYTES
    slots = _slot_peak(D, n_buckets)
    scatter = _SCATTER_BYTES_PER_KEY * D
    if mode == "sorted":
        before, beside = slots, scatter
    elif mode == "sort":
        before = max(_SORT_BYTES_PER_KEY * D, 8 * D + row, row + slots)
        beside = row + scatter
    elif mode == "bucket":
        inputs += 8 * D
        before = max((16 + _SORT_BYTES_PER_KEY) * D, 24 * D + row,
                     row + slots)
        beside = row + scatter
    elif mode == "chunked":
        P = chunked_layout_pieces(D, n_buckets.bit_length() - 1, piece_rows)
        n = min(D, -(-D // P) * 65 // 64)
        before, beside = 8 * D, 8 * n + _slot_peak(n, n_buckets // P)
    else:
        raise ValueError(f"layout mode {mode!r}")
    return inputs + max(before - table, beside)


def _free_bytes(device, free):
    """The free figure to check against: `free` when given, else what this
    process can allocate on a CUDA `device`: the card's free memory
    (torch.cuda.mem_get_info) and the segments torch's caching allocator
    holds that no tensor uses (an allocation that finds no room releases
    them first; after a run of growing merges they can be most of the
    card).  The free part of a segment that still holds a tensor (an
    inactive split block) cannot be released, so it is not counted.  A CPU
    device gives None (not checked)."""
    if free is not None:
        return int(free)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    st = torch.cuda.memory_stats(device)
    return (torch.cuda.mem_get_info(device)[0]
            + st.get("reserved_bytes.all.current", 0)
            - st.get("allocated_bytes.all.current", 0)
            - st.get("inactive_split_bytes.all.current", 0))


def check_device_budget(table_bytes: int, device, what: str = "dictionary",
                        layout: int = 0, free: int | None = None):
    """Raise before allocating when a table of table_bytes, `layout` bytes
    of layout transients (layout_bytes) and ANCHOR_RESERVE_BYTES of chunk
    buffers exceed the free memory of `device`: `free` bytes when given,
    else what this process can allocate on a CUDA device (_free_bytes).  A
    CPU device without a `free` figure is not checked.  Returns the bytes
    it counted."""
    avail = _free_bytes(device, free)
    need = table_bytes + layout + ANCHOR_RESERVE_BYTES
    if avail is not None and need > avail:
        raise RuntimeError(
            f"{what}: needs ~{need / 1e9:.1f} GB of device memory (bucket "
            f"table {table_bytes / 1e9:.1f} GB + layout {layout / 1e9:.1f} "
            f"GB + {ANCHOR_RESERVE_BYTES / 1e9:.1f} GB of chunk buffers) but "
            f"{avail / 1e9:.1f} GB are free on {device}")
    return need


def layout_route(D: int, W: int, device, sorted_input: bool,
                 free: int | None = None,
                 piece_rows: int = LAYOUT_PIECE_ROWS) -> str:
    """The route of BucketedDict.build_device for D keys x W words:
    "single" when the one-pass layout's transients fit beside the table,
    else "chunked" for sorted input whose bounded passes fit, else "host";
    raises when the table alone does not fit.  `free` as in
    check_device_budget.  (panagram_tpu also takes the chunked route for any
    table of 2^31 or more u32, because its scatter indices are int32;
    torch indexes with int64, so size alone decides nothing here.)"""
    nbits, _, stride = table_geometry(D, W)
    table = (1 << nbits) * stride * 4
    avail = _free_bytes(device, free)
    if avail is None:
        return "single"
    room = avail - table - ANCHOR_RESERVE_BYTES
    if layout_bytes(D, W, "sorted" if sorted_input else "sort") <= room:
        return "single"
    if sorted_input and layout_bytes(D, W, "chunked", piece_rows) <= room:
        return "chunked"
    check_device_budget(table, device, "bucketed dict (host layout)",
                        free=free)
    return "host"


def check_hbm_budget(D: int, W: int, n_shards: int = 1,
                     what: str = "dictionary",
                     device_layout: bool | str = True,
                     include_table: bool = True, *, device="cuda",
                     free: int | None = None):
    """panagram_tpu's capacity guard: raise before allocating when the
    bucket table of D keys x W mask words, split over n_shards, and its
    layout's transients do not fit one device.  device_layout True is the
    sorting device layout, "sorted", "chunked" and "bucket" (a range
    shard's low-bit buckets) those routes (layout_bytes counts each), False
    a host layout (nothing beside the table);
    include_table=False checks the transients alone.  The budget is the free
    memory of `device` (check_device_budget) where panagram_tpu takes 80%
    of a TPU chip's memory."""
    if D <= 0:
        return
    per_shard = -(-D // max(n_shards, 1))
    nbits, _, stride = table_geometry(per_shard, W)
    table = (1 << nbits) * stride * 4 if include_table else 0
    mode = {True: "sort", "sorted": "sorted", "chunked": "chunked",
            "bucket": "bucket"}.get(device_layout)
    layout = 0 if mode is None else layout_bytes(per_shard, W, mode)
    check_device_budget(table, device, what, layout, free)


def pad_pow2(keys: np.ndarray, masks: np.ndarray):
    """SENTINEL-pad numpy (keys uint64 [D], masks uint32 [D] or [D, W]) to
    the next power-of-two length (at least 2): panagram_tpu's
    ops.lookup.pad_pow2.  The layouts drop SENTINEL rows."""
    D = len(keys)
    P = 1 << max(int(np.ceil(np.log2(max(D, 2)))), 1)
    if P == D:
        return keys, masks
    W = masks.shape[1] if masks.ndim == 2 else 1
    pk = np.full(P, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    pk[:D] = keys
    pm = np.zeros((P, W), np.uint32)
    pm[:D] = masks.reshape(D, W)
    return pk, pm


@dataclasses.dataclass
class BucketedDict:
    """Single-probe bucketed hash layout of a pan-kmer dictionary.

    `table` is numpy uint32 [2^nbits, stride] after build(), or an int32
    tensor of the same shape and bits after to(device) or
    build_device()."""

    table: object
    nbits: int
    cap: int
    stride: int
    ngenomes: int
    k: int
    nwords: int
    # the route that laid the table out: "single" or "chunked" on the
    # device (build_device), else "host"
    route: str = dataclasses.field(default="host", kw_only=True)

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

    def device_arrays(self, *, device="cuda"):
        """(table,): the bucket table as an int32 tensor on the device,
        panagram_tpu's device_arrays.  A host table (build()) goes up to
        `device` once and stays there; panagram_tpu's packed-row form is
        its TPU's tiling, so the table keeps its [B, stride] shape (the
        probes take either form)."""
        if isinstance(self.table, np.ndarray):
            self.table = self.to(device).table
        return (self.table,)

    @classmethod
    def build_device(cls, keys, masks, ngenomes: int, k: int,
                     mixed: bool = False, count: int | None = None,
                     min_nbits: int = 2, sorted_input: bool = False, *,
                     device="cuda", free: int | None = None,
                     piece_rows: int = LAYOUT_PIECE_ROWS,
                     host_layout: bool = True) -> "BucketedDict":
        """Device layout with the result of panagram_tpu's build_device:
        the table is laid out on `device` and stays there.

        keys: int64 tensor of u64 patterns or numpy uint64, canonical or,
        with mixed=True, splitmix64-mixed; SENTINEL rows are padding and
        dropped.  masks int32 tensor / numpy uint32 [len(keys), W].
        `count` is the number of real keys (for sizing; default all).
        The table has at least 2^min_nbits buckets.  sorted_input=True
        says the keys are sorted in unsigned mixed order (requires
        mixed=True), so their padding is the tail: only the first `count`
        rows are laid out, the layout skips its grouping sort and may take
        the chunked route.  `free` and `piece_rows` as in
        layout_route.  Where no device route fits beside the table, the
        layout runs on the host and is uploaded, or, with
        host_layout=False, raises naming the budget.  The result's `route`
        says which route ran.  An overflowing bucket retries with one more
        bucket bit, up to 8 times."""
        if sorted_input and not mixed:
            raise ValueError("sorted_input requires mixed-space keys")
        device = torch.device(device)
        with spans.span("layout.upload", device=device.type == "cuda"):
            if isinstance(keys, np.ndarray):
                keys = from_u64_np(keys, device)
            if isinstance(masks, np.ndarray):
                masks = torch.from_numpy(
                    np.ascontiguousarray(masks, np.uint32).view(np.int32))
            keys = keys.to(device)
            W = masks.shape[1] if masks.dim() == 2 else 1
            masks = masks.reshape(keys.shape[0], W).to(device)
        D = max(int(count) if count is not None else keys.shape[0], 1)
        if sorted_input:
            # the SENTINEL padding of sorted input is its tail: lay out
            # the live rows alone, which layout_bytes counts (the device
            # builder's arrays hold up to 2x count rows)
            keys, masks = keys[:D], masks[:D]

        route = layout_route(D, W, device, sorted_input, free, piece_rows)
        if route == "host" and not host_layout:
            nbits, _, stride = table_geometry(D, W)
            mode = "chunked" if sorted_input else "sort"
            raise RuntimeError(
                f"bucketed dict: the device layout of {D:,} keys x {W} "
                f"words needs ~{((1 << nbits) * stride * 4) / 1e9:.1f} GB "
                f"(bucket table) + "
                f"{layout_bytes(D, W, mode, piece_rows) / 1e9:.1f} GB "
                f"({mode} layout) + {ANCHOR_RESERVE_BYTES / 1e9:.1f} GB (chunk "
                f"buffers) but {_free_bytes(device, free) / 1e9:.1f} GB are "
                f"free on {device}, and the host layout was not allowed")
        if route == "host":
            logger.warning("device layout of %s keys does not fit beside "
                           "the table; laying it out on the host", f"{D:,}")
            n = keys.shape[0] if count is None else int(count)
            return cls.build(u64_np(keys[:n]),
                             masks[:n].cpu().numpy().view(np.uint32),
                             ngenomes, k, mixed=mixed).to(device)
        nbits, cap, stride = table_geometry(D, W)
        nbits = max(nbits, min_nbits)
        for _ in range(8):
            if route == "chunked":
                table, overflow = _layout_device_chunked(
                    keys, masks, nbits, cap, stride, piece_rows)
            else:
                table, overflow = _layout_device(keys, masks, nbits, cap,
                                                 stride, mixed, sorted_input)
            if int(overflow) == 0:
                return cls(table=table.view(1 << nbits, stride), nbits=nbits,
                           cap=cap, stride=stride, ngenomes=ngenomes, k=k,
                           nwords=W, route=route)
            del table
            nbits += 1  # halve the mean load and retry
        raise RuntimeError("bucketed dict: bucket overflow persisted after "
                           "8 doublings — pathological key distribution")

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
            check_device_budget(t.nbytes, device, what="bucketed dict")
            t = torch.from_numpy(np.array(t, np.uint32).view(np.int32))
        return dataclasses.replace(self, table=t.to(device))


def _new_table(n_buckets: int, stride: int, slot_w: int, device):
    """A flat int32 table of n_buckets * stride all-ones words, plus slot_w
    words of drop area at the end for the rows a scatter does not store."""
    return torch.full((n_buckets * stride + slot_w,), -1, dtype=torch.int32,
                      device=device)


def _slot_base(bs: torch.Tensor, slot: torch.Tensor, ok: torch.Tensor,
               stride: int, slot_w: int, drop: int) -> torch.Tensor:
    """Flat table offset of each row's slot, bs * stride + slot * slot_w,
    or `drop` where not ok.  Computed in place in bs and slot, which are
    consumed: at 1e8 keys every int64 [D] transient is 0.8 GB."""
    base = bs.mul_(stride).add_(slot.mul_(slot_w))
    return base.masked_fill_(~ok, drop)


def _scatter_columns(table: torch.Tensor, base: torch.Tensor,
                     ms: torch.Tensor, mk: torch.Tensor):
    """Write each row's slot, (hi, lo) of its mixed key ms and its mask
    words mk, at flat offset base of `table`; rows to drop point at the
    drop area.  One index_put_ per slot column, into a view of the table
    shifted by the column, so no [D] index is built per column.

    torch indexes with int64, so this one flat path covers tables of 2^31
    u32 and more; panagram_tpu scatters those through a [rows, 128] view
    (lookup.py's _FLAT_SCATTER_MAX) because its indices are int32 and its
    TPU tiles arrays at (8, 128)."""
    for c in range(2 + mk.shape[1]):
        if c == 0:
            col = (ms >> 32).to(torch.int32)
        elif c == 1:
            col = ms.to(torch.int32)   # int64 -> int32 keeps the low word
        else:
            col = mk[:, c - 2]
        table[c:].index_put_((base,), col)


def layout_rows(m: torch.Tensor, masks: torch.Tensor, bucket, n_buckets: int,
                cap: int, stride: int, bucket_in_key: bool = False,
                pre_sorted: bool = False):
    """Core of the device bucket layout (panagram_tpu.ops.lookup.layout_rows).

    m int64 [D] mixed keys (SENTINEL rows are padding and dropped); masks
    int32 [D, W]; bucket int [D], the destination bucket of each row.
    bucket_in_key=True says the bucket is the top bits of m (`bucket` is
    then unused): sorting by m alone gives (bucket, key) order, and
    pre_sorted=True says m is already sorted in unsigned order, which
    skips that sort.  Rows are grouped by (bucket, key) in unsigned order;
    keys are distinct, so every row's slot is fixed.

    Returns (table int32 flat [n_buckets * stride], overflow: 0-d tensor
    counting the rows past a bucket's capacity, which are dropped)."""
    D, W = masks.shape
    if bucket_in_key:
        nbits = (n_buckets - 1).bit_length()
        if pre_sorted:
            ms, mk = m, masks
        else:
            order = torch.sort(flip64(m)).indices
            ms, mk = m[order], masks[order]
            del order
        bs = torch.where(ms != SENTINEL, srl(ms, 64 - nbits), n_buckets)
    else:
        b = torch.where(m != SENTINEL, bucket.to(torch.int64), n_buckets)
        order = torch.sort(flip64(m)).indices
        order = order[torch.sort(b[order], stable=True).indices]
        ms, mk, bs = m[order], masks[order], b[order]
        del order, b
    counts = torch.bincount(bs, minlength=n_buckets + 1)
    overflow = torch.clamp(counts[:n_buckets] - cap, min=0).sum()
    slot = torch.arange(D, device=m.device)
    slot -= (torch.cumsum(counts, 0) - counts)[bs]
    del counts
    ok = (bs < n_buckets) & (slot < cap)
    table = _new_table(n_buckets, stride, 2 + W, m.device)
    base = _slot_base(bs, slot, ok, stride, 2 + W, n_buckets * stride)
    del bs, slot, ok
    _scatter_columns(table, base, ms, mk)
    return table[:n_buckets * stride], overflow


def _layout_device(keys: torch.Tensor, masks: torch.Tensor, nbits: int,
                   cap: int, stride: int, mixed: bool = True,
                   pre_sorted: bool = False):
    """Single-pass device layout; canonical keys (mixed=False) are mixed
    here, SENTINELs kept."""
    m = keys if mixed else torch.where(keys == SENTINEL, keys, mix64(keys))
    return layout_rows(m, masks, None, 1 << nbits, cap, stride,
                       bucket_in_key=True, pre_sorted=pre_sorted)


def chunked_layout_pieces(N: int, nbits: int,
                          piece_rows: int = LAYOUT_PIECE_ROWS) -> int:
    """Pass count of the chunked device layout: the smallest power of two
    (at least 2) keeping each pass under piece_rows of N rows (padding
    included, as panagram_tpu counts), clamped so that every pass covers
    at least one bucket."""
    P = 2
    while -(-N // P) > piece_rows:
        P *= 2
    return min(P, 1 << nbits)


def _piece_bounds(keys: torch.Tensor, P: int) -> list[int]:
    """Row bounds of the P passes over keys sorted in unsigned mixed order
    (SENTINEL padding at the tail): pass p covers mixed values
    [p, p+1) * 2^64/P, i.e. buckets [p, p+1) * B/P for any nbits >=
    log2(P), and the last bound is the first SENTINEL row."""
    log2p = P.bit_length() - 1
    vals = [as_signed64(p << (64 - log2p)) for p in range(1, P)] + [SENTINEL]
    vals = torch.tensor(vals, dtype=torch.int64, device=keys.device)
    return [0] + torch.searchsorted(flip64(keys), flip64(vals)).tolist()


def _layout_piece(table: torch.Tensor, keys: torch.Tensor,
                  masks: torch.Tensor, lo: int, hi: int, base_bucket: int,
                  n_piece: int, nbits: int, cap: int, stride: int):
    """One pass of the chunked layout: the sorted rows [lo, hi), which are
    all the rows of buckets [base_bucket, base_bucket + n_piece), go into
    the flat `table` in place.  Returns the pass's overflow (0-d)."""
    m, mk = keys[lo:hi], masks[lo:hi]
    bs = srl(m, 64 - nbits)
    local = bs - base_bucket
    counts = torch.bincount(local, minlength=n_piece)
    slot = torch.arange(hi - lo, device=m.device)
    slot -= (torch.cumsum(counts, 0) - counts)[local]
    del local
    slot_w = 2 + mk.shape[1]
    base = _slot_base(bs, slot, slot < cap, stride, slot_w,
                      table.shape[0] - slot_w)
    del slot
    _scatter_columns(table, base, m, mk)
    return torch.clamp(counts - cap, min=0).sum()


def _layout_device_chunked(keys: torch.Tensor, masks: torch.Tensor,
                           nbits: int, cap: int, stride: int,
                           piece_rows: int = LAYOUT_PIECE_ROWS):
    """Chunked device layout of keys sorted in unsigned mixed order with
    SENTINEL padding at the tail: the table is allocated once and each of
    P bucket-range passes writes its rows into it in place (panagram_tpu
    donated the table to each pass for the same effect).  The device is
    synchronised after every pass, so only one pass's transients are ever
    alive.  Returns (table int32 flat [B * stride], overflow int)."""
    B = 1 << nbits
    P = chunked_layout_pieces(keys.shape[0], nbits, piece_rows)
    bounds = _piece_bounds(keys, P)
    table = _new_table(B, stride, 2 + masks.shape[1], keys.device)
    overflow = 0
    for p in range(P):
        ov = _layout_piece(table, keys, masks, bounds[p], bounds[p + 1],
                           p * (B // P), B // P, nbits, cap, stride)
        if keys.device.type == "cuda":
            torch.cuda.synchronize(keys.device)
        overflow += int(ov)
    return table[:B * stride], overflow


def bucket_row(hi: torch.Tensor, nbits: int) -> torch.Tensor:
    """Bucket index (int64) of each query: the top nbits of its hi word."""
    if not 1 <= nbits <= 32:
        raise ValueError(f"nbits={nbits}: the probes take 1..32 bucket bits")
    return u32(hi) >> (32 - nbits)


def bucket_query_pairs(mhi: torch.Tensor, mlo: torch.Tensor,
                       table: torch.Tensor, nbits: int, cap: int,
                       nwords: int) -> torch.Tensor:
    """Mixed query pairs (int32 [Q] each) -> mask rows int32 [Q, W] by one
    row gather per query.  Misses, all-ones pairs included, give 0."""
    rows = table[bucket_row(mhi, nbits)]
    return kernels.match_slots(rows, mhi, mlo, cap, nwords)


def plain_table(table, nbits: int, device) -> torch.Tensor:
    """A bucket table as int32 [B, stride] on `device`, from a tensor or
    numpy uint32, plain [B, stride] or panagram_tpu's packed-row
    [B/pack, stride*pack] (whose row-major reshape is the plain layout: a
    packed row holds its `pack` buckets in order)."""
    if isinstance(table, np.ndarray):
        table = np.ascontiguousarray(table, np.uint32)
        if not table.flags.writeable:       # e.g. a jax array's view
            table = table.copy()
        table = torch.from_numpy(table.view(np.int32))
    B = 1 << nbits
    return table.to(device).reshape(B, table.numel() // B)


def _mixed_pairs(canon, pre_mixed: bool, table):
    """Keys int64 [Q] (u64 bits; numpy uint64 goes to the device of a
    tensor table) -> the (hi, lo) int32 halves of their splitmix64 mix (of
    the keys themselves when pre_mixed)."""
    if isinstance(canon, np.ndarray):
        canon = from_u64_np(canon, getattr(table, "device", "cpu"))
    return split64(canon if pre_mixed else mix64(canon))


def bucket_query(canon: torch.Tensor, table, nbits: int, cap: int,
                 nwords: int, pre_mixed: bool = False) -> torch.Tensor:
    """panagram_tpu's gather probe: keys int64 [Q] (u64 bits, canonical or,
    with pre_mixed, mixed) -> mask rows int32 [Q, W], one bucket row
    gathered per query.  Misses, SENTINEL windows and the reserved
    all-ones mixed value give 0.  `table` is plain [B, stride] or
    packed-row; the probe runs on the keys' device."""
    mhi, mlo = _mixed_pairs(canon, pre_mixed, table)
    return bucket_query_pairs(mhi, mlo, plain_table(table, nbits, mhi.device),
                              nbits, cap, nwords)


def bucket_query_sorted(canon: torch.Tensor, table, nbits: int, cap: int,
                        nwords: int, pre_mixed: bool = False, *,
                        span: int | None = None,
                        tile_q: int = TILE_Q) -> torch.Tensor:
    """panagram_tpu's merge probe, the rows of bucket_query: mix the keys,
    pad them to a multiple of tile_q with all-ones pairs (which never
    match), then bucket_query_sorted_pre, whose probe is the probe_sorted
    kernel on a CUDA device."""
    mhi, mlo = _mixed_pairs(canon, pre_mixed, table)
    Q0 = mhi.shape[0]
    pad = -Q0 % tile_q
    if pad:
        ones = mhi.new_full((pad,), -1)
        mhi, mlo = torch.cat([mhi, ones]), torch.cat([mlo, ones])
    return bucket_query_sorted_pre(mhi, mlo, None,
                                   plain_table(table, nbits, mhi.device),
                                   nbits, cap, nwords, Q0, span=span,
                                   tile_q=tile_q)


@dataclasses.dataclass
class ProbePlan:
    """Sorted queries and the window geometry of the merge probe."""

    qhi: torch.Tensor      # int32 [Qp] hi words, ascending as u32
    qlo: torch.Tensor      # int32 [Qp]
    perm: torch.Tensor     # int64 [Qp]: sorted slot -> input index
    blo: torch.Tensor      # int32 [Qp / tile_q]: first table row per tile
    span: int              # table rows per tile window
    tile_q: int
    nbits: int

    @property
    def out_span(self) -> torch.Tensor:
        """bool [Qp]: query outside its tile's window.  All-ones pairs
        never match, so they are exempt from the window."""
        brow = bucket_row(self.qhi, self.nbits)
        is_pad = (self.qhi == -1) & (self.qlo == -1)
        first = self.blo.to(torch.int64).repeat_interleave(self.tile_q)
        return ~(((brow - first) < self.span) | is_pad)


def plan_probe(mhi0: torch.Tensor, mlo0: torch.Tensor, nbits: int,
               span: int | None = None, tile_q: int = TILE_Q) -> ProbePlan:
    """Sort the queries on their hi word (as u32; ties need no order, the
    probe compares the full pair) and place each tile's window.

    By default the window is the whole table, so every query reads its own
    bucket row and none is out of span.  The TPU kernel copied the window
    into its 4 MB VMEM and so had to cap it (1.5x the mean range, leaving a
    tail for the fixup); this kernel reads rows straight from device
    memory, where a wider window costs nothing.  That also keeps the fast
    path under skew, such as the many identical N-window queries of a gappy
    assembly, and it needs no look at the data: the default route queues
    its work without waiting for the device.  An explicit `span` narrows
    the window around each tile's first bucket (the tests use it to reach
    the fixup)."""
    B = 1 << nbits
    Qp = mhi0.shape[0]
    if Qp % tile_q:
        raise ValueError(f"query count {Qp} is not a multiple of {tile_q}")
    # signed order of (hi ^ 0x80000000) is the unsigned order of hi
    _, perm = torch.sort(mhi0 ^ torch.iinfo(torch.int32).min)
    qhi = mhi0[perm]
    qlo = mlo0[perm]
    if span is None:
        blo = torch.zeros(Qp // tile_q, dtype=torch.int32, device=qhi.device)
        return ProbePlan(qhi, qlo, perm, blo, B, tile_q, nbits)
    span = min(max(span, 1), B)
    blo = torch.clamp(bucket_row(qhi[::tile_q], nbits), 0, B - span)
    return ProbePlan(qhi, qlo, perm, blo.to(torch.int32), span, tile_q, nbits)


def bucket_query_sorted_pre(mhi0: torch.Tensor, mlo0: torch.Tensor,
                            pos, table: torch.Tensor, nbits: int, cap: int,
                            nwords: int, out_len: int, *,
                            span: int | None = None,
                            tile_q: int = TILE_Q) -> torch.Tensor:
    """Merge probe of mixed query pairs in any order: mhi0/mlo0 int32 [Qp]
    (all-ones pairs are padding; Qp % tile_q == 0) -> mask rows int32
    [out_len, W].  pos, as in panagram_tpu, is each element's output row:
    an integer tensor [Qp] holding each row of [0, out_len) once, and pad
    elements at rows >= out_len, which are dropped.  pos=None is the
    positional order (element i answers row i) without building it: the
    inverse permutation is then one scatter.  With the default window no
    value comes back to the host; an explicit `span` counts the queries
    out of their windows and fixes them up, or falls back."""
    Qp = mhi0.shape[0]
    plan = plan_probe(mhi0, mlo0, nbits, span, tile_q)
    idx_out = None
    if span is not None:
        idx_out = torch.nonzero(plan.out_span).squeeze(1)
        if idx_out.shape[0] > max(Qp >> 6, tile_q):
            rows = bucket_query_pairs(mhi0, mlo0, table, nbits, cap, nwords)
            return _to_rows(rows, None, pos, out_len)
    rows = kernels.probe_sorted(plan.qhi, plan.qlo, plan.blo, table, nbits,
                                cap, nwords, plan.span, plan.tile_q)
    if idx_out is not None and idx_out.shape[0]:
        rows[idx_out] = bucket_query_pairs(plan.qhi[idx_out],
                                           plan.qlo[idx_out], table, nbits,
                                           cap, nwords)
    return _to_rows(rows, plan.perm, pos, out_len)


def _to_rows(rows: torch.Tensor, perm, pos, out_len: int) -> torch.Tensor:
    """Scatter rows [Qp, W] to their output rows: element j of `rows` is
    input element perm[j] (perm None: element j), whose row is pos[that]
    (pos None: the element's own index).  One scatter; rows >= out_len go
    to a dropped row."""
    if pos is None:
        if perm is None:
            return rows[:out_len]
        out = torch.empty_like(rows)
        out[perm] = rows      # inverse permutation
        return out[:out_len]
    tgt = pos.to(torch.int64) if perm is None else pos.to(torch.int64)[perm]
    tgt = torch.clamp(tgt, max=out_len)
    out = rows.new_empty(out_len + 1, rows.shape[1])
    out[tgt] = rows
    return out[:out_len]
