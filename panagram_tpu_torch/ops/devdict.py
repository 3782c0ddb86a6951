"""Device-resident pan-kmer dictionary builder (``index --device-dict``).

The counterpart of panagram_tpu.ops.devdict.  Sequence chunks go to the
device one base a byte and the pack_bases kernel packs them there (the
JAX package packs them on the host); the pack_mix kernel turns each into
mixed k-mer pairs, which are sorted and deduplicated there and merged
straight into the growing (keys, masks) dictionary with the genome's
presence bit.
Nothing but a count per flush comes back until the finished dictionary
does.

Keys are splitmix64-mixed and kept in unsigned order (sorted on
``codec.flip64``), SENTINEL-padded at the tail, so the finished arrays
feed BucketedDict.build_device(sorted_input=True) as they are.  A merge is
concat + sort with the mask words as payload + neighbour OR (runs have
length <= 2: both sides hold distinct keys) + a second sort that moves the
emptied rows to the tail: a fixed reduction order, so the output is the
same whatever the chunking.

panagram_tpu padded every array to fixed, power-of-two shapes so that XLA
compiled each program once; torch runs eagerly, so here a chunk is as long
as its sequence needs (up to `chunk` positions), and a merge sorts only the
live prefix of the capacity-sized arrays.

Its steps are spans of ``panagram_tpu_torch.spans``: devdict.pack (a
chunk's staging, upload and packing, host clock), devdict.chunk,
devdict.union and devdict.merge (with a CUDA event pair on the card),
devdict.sync (the host waiting for the count) and devdict.grow (the
arrays growing); counters devdict.positions (k-mer positions a chunk),
devdict.flushes and devdict.merged_rows (the rows each merge sorts).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spans
from . import kernels
from .codec import (
    SENTINEL,
    as_signed64,
    flip64,
    sort_u64,
    to_i32,
    u64_np,
)
from .lookup import BucketedDict, check_device_budget, mix64_np

# mix64 of the all-ones key: the pair pack_mix emits for a window with an N
_SENT_MIX = as_signed64(int(mix64_np(np.array([2**64 - 1], np.uint64))[0]))


def _sort_dedup(s: torch.Tensor) -> torch.Tensor:
    """Sorted distinct keys of s (int64 u64 patterns, SENTINELs allowed),
    SENTINEL-padded to len(s), in unsigned order."""
    s = sort_u64(s)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[1:] = s[1:] == s[:-1]
    return sort_u64(torch.where(dup, SENTINEL, s))


def _chunk_mixed_distinct(packed: torch.Tensor, nmask: torch.Tensor, L: int,
                          k: int) -> torch.Tensor:
    """packed/nmask (codec.pack_bases_np's layout, on the device) of L
    bases -> the sorted distinct mixed keys of its L - k + 1 windows,
    SENTINEL-padded to that length.  The pack_mix kernel gives each
    window's mixed pair; a window with an N gives mix64(SENTINEL), which no
    canonical key (< 2^62) mixes to, as mix64 is a bijection, so it maps
    back to SENTINEL."""
    P = L - k + 1
    hi, lo = kernels.pack_mix(packed, nmask, L, k, P)
    m = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    return _sort_dedup(torch.where(m == _SENT_MIX, SENTINEL, m))


def _union_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union of two sorted SENTINEL-padded distinct key arrays -> sorted
    distinct [len(a) + len(b)], SENTINEL-padded."""
    return _sort_dedup(torch.cat([a, b]))


def merge_bytes(rows: int, nwords: int) -> int:
    """Device bytes _merge_into holds at its peak, the second sort, for
    `rows` concatenated rows (live rows plus new keys) of nwords mask
    words: the concatenated keys, their first order and the merged keys
    (int64 each), four boolean run flags, the sort of the flipped merged
    keys (lookup's 48 B per key: input, values, indices, iota and the
    radix sort's two buffers), and the sorted and the merged mask words
    (4W B each)."""
    return (3 * 8 + 4 + 48 + 2 * 4 * nwords) * rows


def _merge_into(keys: torch.Tensor, masks: torch.Tensor,
                new_keys: torch.Tensor, nwords: int, gid: int):
    """Merge a genome's sorted distinct keys into the dictionary.

    keys int64 [C] sorted, SENTINEL-padded; masks int32 [C, W]; new_keys
    int64 [M] sorted, SENTINEL-padded; gid the genome id.  Returns ([C]
    keys, [C, W] masks, count 0-d tensor) with SENTINELs at the tail: the
    output is truncated back to C, so the caller makes sure that count + M
    <= C."""
    C = keys.shape[0]
    new_masks = torch.zeros(new_keys.shape[0], nwords, dtype=torch.int32,
                            device=keys.device)
    bit = int(to_i32(torch.tensor(1 << (gid % 32))))
    new_masks[:, gid // 32] = torch.where(new_keys != SENTINEL, bit, 0)

    allk = torch.cat([keys, new_keys])
    order = torch.sort(flip64(allk)).indices
    ks, ms = allk[order], torch.cat([masks, new_masks])[order]

    # runs of equal keys have length <= 2: OR the pair into the first row,
    # empty the second
    same = ks[1:] == ks[:-1]
    dup_next = torch.zeros_like(ks, dtype=torch.bool)
    dup_prev = torch.zeros_like(ks, dtype=torch.bool)
    dup_next[:-1] = same
    dup_prev[1:] = same
    real = ks != SENTINEL
    merged = torch.where((dup_next & real)[:, None],
                         ms | torch.roll(ms, -1, dims=0), ms)
    ks = torch.where(dup_prev & real, SENTINEL, ks)
    merged = torch.where((dup_prev & real)[:, None], 0, merged)

    order = torch.sort(flip64(ks)).indices[:C]
    ks2 = ks[order]
    return ks2, merged[order], (ks2 != SENTINEL).sum()


class DeviceDictBuilder:
    """Incremental dictionary construction on `device` over genome streams.

    Chunks do not merge into the dictionary one by one (each merge sorts
    the whole dictionary): up to FLUSH_CHUNKS chunk key sets of one genome
    are buffered and tree-unioned before one merge, and the only host
    synchronisation is one count read per flush.

    `walls` (s) gains each step's span: "pack" and "sync" on the host's
    clock; "chunk_dispatch", "union_dispatch" and "merge_dispatch" the
    card's seconds between the steps' events on a CUDA device (read once a
    sync has waited for them), the host's elsewhere; "first_sync" the
    first flush's wait; "flushes" the merges."""

    FLUSH_CHUNKS = 8

    def __init__(self, k: int, ngenomes: int, chunk: int = 1 << 22,
                 capacity_hint: int | None = None, *, device="cuda"):
        self.k = k
        self.ngenomes = ngenomes
        self.nwords = (ngenomes + 31) // 32
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.chunk = chunk
        self.keys = None        # int64 [capacity], sorted, SENTINEL-padded
        self.masks = None       # int32 [capacity, W]
        self.count = 0          # last synced key count
        self._cnt_dev = None    # 0-d count tensor of the latest merge
        self._pending = 0       # merges since the last sync
        self._buf = []          # buffered chunk key sets (one genome)
        self._buf_gid = None
        self._buf_real = 0      # upper bound on real keys in the buffer
        self.walls = {"pack": 0.0, "chunk_dispatch": 0.0,
                      "union_dispatch": 0.0, "merge_dispatch": 0.0,
                      "sync": 0.0, "first_sync": 0.0, "flushes": 0}
        if capacity_hint:
            self._ensure_capacity(capacity_hint)

    def _ensure_capacity(self, needed: int):
        """Grow the arrays to a power of two >= needed (at least 2^10),
        after the budget check: the arrays, a flush's buffered keys
        (FLUSH_CHUNKS chunks of int64) and the transients of the largest
        merge they allow (merge_bytes of capacity plus the buffered rows);
        no table is laid out beside them."""
        cap = 1 << max(int(np.ceil(np.log2(max(needed, 2)))), 10)
        have = 0 if self.keys is None else self.keys.shape[0]
        if cap <= have:
            return
        with spans.span("devdict.grow"):
            buffered = self.FLUSH_CHUNKS * self.chunk
            check_device_budget(0, self.device, "device dictionary builder",
                                (8 + 4 * self.nwords) * cap + 8 * buffered
                                + merge_bytes(cap + buffered, self.nwords))
            pad = cap - have
            keys = torch.full((pad,), SENTINEL, dtype=torch.int64,
                              device=self.device)
            masks = torch.zeros(pad, self.nwords, dtype=torch.int32,
                                device=self.device)
            if self.keys is not None:
                keys = torch.cat([self.keys, keys])
                masks = torch.cat([self.masks, masks])
            self.keys, self.masks = keys, masks

    def _upload(self, codes: np.ndarray) -> torch.Tensor:
        """codes (uint8) on the device: through a pinned staging block and
        a copy that does not wait for the card's queued work on a CUDA
        device (torch's host allocator reuses the block once the copy is
        done), as they are on the CPU."""
        if not self._cuda:
            return torch.from_numpy(codes)
        host = torch.empty(len(codes), dtype=torch.uint8, pin_memory=True)
        host.numpy()[:] = codes
        return host.to(self.device, non_blocking=True)

    def add_sequence(self, gid: int, codes: np.ndarray):
        """Stream one sequence of genome `gid` (uint8 codes) into the dict.
        Each chunk's codes go to the device as they are, and
        kernels.pack_bases packs them there into codec.pack_bases_np's
        layout of chunk + k - 1 bases (those past the chunk's own count as
        not ACGT, so their windows give SENTINEL)."""
        k = self.k
        n = len(codes) - k + 1
        if n <= 0:
            return
        if self._buf_gid is not None and self._buf_gid != gid:
            self._flush_buffer()
        self._buf_gid = gid
        codes = np.ascontiguousarray(codes, np.uint8)
        chunk = min(self.chunk, n)
        L = chunk + k - 1
        n4 = (L + 3) // 4
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            with spans.span("devdict.pack", phase=self.walls, key="pack"):
                nvalid = m + k - 1
                codes_d = self._upload(codes[start:start + nvalid])
                ib = torch.empty(n4 + (L + 7) // 8, dtype=torch.uint8,
                                 device=self.device)
                kernels.pack_bases(codes_d, nvalid, L, ib)
            with spans.span("devdict.chunk", device=self._cuda,
                            phase=self.walls, key="chunk_dispatch"):
                self._buf.append(_chunk_mixed_distinct(ib[:n4], ib[n4:], L,
                                                       k))
            spans.count("devdict.positions", m)
            self._buf_real += m
            if len(self._buf) >= self.FLUSH_CHUNKS:
                self._flush_buffer()

    def _flush_buffer(self):
        """Tree-union the buffered chunk key sets and merge them once.  The
        buffered gid stays: a long sequence flushes mid-stream and goes on
        buffering chunks of the same genome."""
        if not self._buf:
            return
        parts, self._buf = self._buf, []
        with spans.span("devdict.union", device=self._cuda, phase=self.walls,
                        key="union_dispatch"):
            while len(parts) > 1:
                nxt = [_union_sorted(parts[i], parts[i + 1])
                       for i in range(0, len(parts) - 1, 2)]
                parts = nxt + parts[len(nxt) * 2:]
            # every real key of the buffer lies in the first real_bound
            # rows (at most one per buffered position), the rest are
            # SENTINELs
            new_keys = parts[0][:self._buf_real]
        self._buf_real = 0
        sync0 = self.walls["sync"]
        self._sync_count()
        if self.walls["flushes"] == 0:
            self.walls["first_sync"] = self.walls["sync"] - sync0
        live = self.count + new_keys.shape[0]
        self._ensure_capacity(live)
        with spans.span("devdict.merge", device=self._cuda, phase=self.walls,
                        key="merge_dispatch"):
            keys, masks, cnt = _merge_into(self.keys[:live],
                                           self.masks[:live], new_keys,
                                           self.nwords, self._buf_gid)
            self.keys[:live] = keys
            self.masks[:live] = masks
        spans.count("devdict.flushes", 1)
        spans.count("devdict.merged_rows", live + new_keys.shape[0])
        self._cnt_dev = cnt
        self._pending += 1
        self.walls["flushes"] += 1

    def _sync_count(self):
        """Read the latest merge's count (the host waits for the card),
        then the event pairs of the steps it waited for."""
        if self._cnt_dev is not None and self._pending:
            with spans.span("devdict.sync", phase=self.walls, key="sync"):
                self.count = int(self._cnt_dev)
            self._pending = 0
            spans.settle()

    def synced_count(self) -> int:
        """The exact key count (one device round trip if merges are
        pending), after flushing the buffer."""
        self._flush_buffer()
        self._sync_count()
        return self.count

    def add_genome(self, gid: int, code_arrays):
        for codes in code_arrays:
            self.add_sequence(gid, np.asarray(codes, np.uint8))

    def to_host(self):
        """The dictionary on the host: (keys in unsigned mixed order,
        masks) as a PanKmerDict of key space "mixed"; only the live
        `count` rows are copied."""
        from .dictionary import PanKmerDict

        n = self.synced_count()
        if self.keys is None:
            return PanKmerDict(np.zeros(0, np.uint64),
                               np.zeros((0, self.nwords), np.uint32),
                               self.ngenomes, self.k, key_space="mixed")
        return PanKmerDict(u64_np(self.keys[:n]),
                           self.masks[:n].cpu().numpy().view(np.uint32),
                           self.ngenomes, self.k, key_space="mixed")

    def bucketed(self, *, host_layout: bool = True) -> BucketedDict:
        """The query table laid out on the device straight from the
        builder's arrays (sorted in mixed space, so the layout skips its
        grouping sort), with no host copy where a device route fits;
        host_layout as in BucketedDict.build_device."""
        n = self.synced_count()
        return BucketedDict.build_device(self.keys, self.masks,
                                         self.ngenomes, self.k, mixed=True,
                                         count=n, sorted_input=True,
                                         device=self.device,
                                         host_layout=host_layout)
