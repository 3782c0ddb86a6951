"""Sharded dictionary and distributed anchoring on torch.distributed
(panagram_tpu.parallel.shard, whose shard_map bodies become the SPMD
functions here, each called by every rank of a parallel.mesh.Mesh).

Two strategies:

* **range** (ShardedBucketedDict): rank s owns the mixed keys in
  [s, s+1) * 2^64/S.  Its table buckets a key by its LOW bits (splitmix64
  makes low and high bits independently uniform), laid out by
  ops/lookup.layout_rows on the rank's device.  The build routes (key,
  genome) pairs to their owners with an all_to_all and merges them there
  into presence masks; anchoring is sequence-sharded: each rank packs its
  halo'd slice of a chunk (pack_mix kernel), routes the queries to their
  owners, which probe their tables with one row gather each, routes the
  mask rows back and runs the popcount and byte kernels on its rows.
* **genomes** (GenomeShardedDict): every rank holds all keys but only its
  slice of the mask words, in the standard top-bits table; every rank
  anchors the whole chunk against its slice (pack_mix, probe_sorted) and
  the byte slices are concatenated in rank order.

The all_to_alls send the row counts first and then exactly the rows
(``mesh.all_to_all``), where panagram_tpu's fixed [S, C] buffers send S
times the rows: pack_mix gives every N window one mixed value, so the
queries of a gappy assembly all go to one rank, which fixed buffers would
have to size for.  Results are dense per-rank (bytes, popc, colsums), as the
single-device engine's are; panagram_tpu's run-length variants of these
bodies are not ported (the bytes on disk are the same).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import kernels
from ..ops.codec import (
    SENTINEL,
    flip64,
    from_u64_np,
    mix64,
    pack_bases_np,
    split64,
    u32,
    u64_np,
)
from ..ops.dictionary import PanKmerDict, _merge_sets
from ..ops.lookup import (
    TILE_Q,
    bucket_query_sorted_pre,
    check_device_budget,
    layout_bytes,
    layout_rows,
    mix64_np,
    table_geometry,
)
from .mesh import (
    Mesh,
    all_sum,
    all_to_all,
    gather_rows_to_writers,
    gather_to_writers,
)

U64 = np.uint64


@dataclasses.dataclass
class ShardedBucketedDict:
    """This rank's shard of a key-range sharded bucket table: int32
    [2^nbits, stride] on the rank's device, holding the keys whose mixed
    value falls in the rank's range, bucketed by their low nbits bits."""

    table: torch.Tensor
    nbits: int
    cap: int
    stride: int
    ngenomes: int
    k: int
    nwords: int
    n_shards: int

    @property
    def nbytes_row(self) -> int:
        return (self.ngenomes + 7) // 8


@dataclasses.dataclass
class GenomeShardedDict:
    """This rank's slice of a genome-sharded dictionary: a standard top-bits
    bucket table over all keys holding mask words [rank * nwords_local,
    (rank + 1) * nwords_local) (zero past the dictionary's words)."""

    table: torch.Tensor
    nbits: int
    cap: int
    stride: int
    ngenomes: int
    k: int
    nwords_local: int
    n_shards: int


def _uniform_bounds(n_shards: int) -> np.ndarray:
    """Lower bound of each rank's range of mixed keys: equal slices of the
    u64 range (any S; the modulo keeps S = 1 representable)."""
    return (np.arange(n_shards, dtype=U64)
            * U64(((1 << 64) // n_shards) % (1 << 64)))


def route(m: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owning rank (int64) of each mixed key: the last bound at or below it
    in unsigned order, compared through codec.flip64, so SENTINEL goes to
    the last rank as panagram_tpu's searchsorted sends it."""
    bounds = flip64(from_u64_np(_uniform_bounds(n_shards), m.device))
    tgt = torch.searchsorted(bounds, flip64(m), right=True) - 1
    return tgt.clamp_(0, n_shards - 1)


def _by_owner(m: torch.Tensor, n_shards: int):
    """(order grouping the keys by owning rank, stably; rows per rank)."""
    tgt = route(m, n_shards)
    order = torch.argsort(tgt, stable=True)
    return order, torch.bincount(tgt, minlength=n_shards)


def _local_probe(m: torch.Tensor, table: torch.Tensor, nbits: int, cap: int,
                 nwords: int) -> torch.Tensor:
    """Mask rows int32 [Q, W] of mixed keys m in a shard's table: one row
    gather per query at its low-bit bucket (panagram_tpu's _local_probe is
    an XLA gather too), then kernels.match_slots.  SENTINEL misses."""
    hi, lo = split64(m)
    rows = table[m & ((1 << nbits) - 1)]
    return kernels.match_slots(rows, hi, lo, cap, nwords)


# ---------------------------------------------------------------- build --


def _layout_params(total_keys: int, n_shards: int, nwords: int, extra: int,
                   device, mode: str):
    """Per-shard table geometry for total_keys keys over n_shards, with
    `extra` bucket bits; raises (check_device_budget) when a shard's table
    and its layout of `mode` (ops/lookup.layout_bytes) do not fit."""
    per_shard = max(-(-total_keys // max(n_shards, 1)), 1)
    nbits, cap, stride = table_geometry(per_shard, nwords)
    nbits += extra
    check_device_budget((1 << nbits) * stride * 4, device,
                        what=f"sharded dict ({n_shards} shards)",
                        layout=layout_bytes(per_shard, nwords, mode,
                                            n_buckets=1 << nbits))
    return nbits, cap, stride


def _shard_layout(mesh: Mesh, out_keys: torch.Tensor, out_masks: torch.Tensor,
                  total: int, nwords: int, what: str):
    """Lay out this rank's keys (low-bit buckets) with the geometry of
    total keys over the mesh, one more bucket bit while any rank's bucket
    overflows (decided from the summed overflow, so in lockstep)."""
    for extra in range(6):
        nbits, cap, stride = _layout_params(total, mesh.size, nwords, extra,
                                            mesh.device, "bucket")
        bucket = out_keys & ((1 << nbits) - 1)
        table, overflow = layout_rows(out_keys, out_masks, bucket, 1 << nbits,
                                      cap, stride)
        if int(all_sum(mesh, overflow.reshape(1).to(torch.int64))) == 0:
            return table.view(1 << nbits, stride), nbits, cap, stride
        del table
    raise RuntimeError(f"{what}: bucket overflow persisted")


def sharded_build_dictionary(genome_sets, mesh: Mesh, ngenomes: int, k: int,
                             return_host_dict: bool = False):
    """Distributed dictionary build, called by every rank with the same
    genome_sets[g] (numpy u64 distinct canonical keys of genome g; memory
    maps serve, as the rank reads only its slice).  Rank r takes the r-th
    slice of the concatenated (key, genome) pairs, routes them to their
    owners (all_to_all), which merge them and lay out their tables.
    Returns this rank's ShardedBucketedDict; with return_host_dict=True
    (the same on every rank) also the whole dictionary as a PanKmerDict in
    mixed key space on writer ranks, None on the others.  Each shard's
    keys and masks then go to the host and from there to the writers only
    (gather_rows_to_writers), so no device holds more than its own shard;
    their rank-order concatenation is sorted in unsigned order."""
    S, dev = mesh.size, mesh.device
    W = (ngenomes + 31) // 32
    total = int(sum(len(s) for s in genome_sets))
    per = -(-max(total, 1) // S)
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    keys, gids, off = [], [], 0
    for g, s in enumerate(genome_sets):
        a, b = max(lo, off), min(hi, off + len(s))
        if a < b:
            keys.append(s[a - off:b - off])
            gids.append(np.full(b - a, g, np.int32))
        off += len(s)
    keys = from_u64_np(np.concatenate(keys) if keys else np.zeros(0, U64), dev)
    gids = torch.from_numpy(np.concatenate(gids) if gids
                            else np.zeros(0, np.int32)).to(dev)
    m = mix64(keys)
    del keys
    order, counts = _by_owner(m, S)
    pairs = [all_to_all(mesh, m[order], counts)[0]]
    del m
    pairs.append(all_to_all(mesh, gids[order], counts)[0])
    del gids, order
    out_keys, out_masks = _merge_sets(pairs, W)
    table, nbits, cap, stride = _shard_layout(mesh, out_keys, out_masks, total,
                                              W, "sharded build")
    sbd = ShardedBucketedDict(table, nbits, cap, stride, ngenomes, k, W, S)
    if not return_host_dict:
        return sbd
    out_keys, out_masks = out_keys.cpu(), out_masks.cpu()
    keys = gather_rows_to_writers(mesh, out_keys)
    del out_keys
    masks = gather_rows_to_writers(mesh, out_masks)
    if not mesh.writer:
        return sbd, None
    return sbd, PanKmerDict(u64_np(keys), masks.numpy().view(np.uint32),
                            ngenomes, k, key_space="mixed")


_INV1 = U64(0x96DE1B173F119089)   # inverse of 0xBF58476D1CE4E5B9 mod 2^64
_INV2 = U64(0x319642B2D24D8EC3)   # inverse of 0x94D049BB133111EB mod 2^64


def _unmix64_np(x: np.ndarray) -> np.ndarray:
    """Inverse of the splitmix64 finalizer (ops.lookup.mix64_np)."""
    x = x.astype(U64, copy=True)
    x ^= (x >> U64(31)) ^ (x >> U64(62))
    x *= _INV2
    x ^= (x >> U64(27)) ^ (x >> U64(54))
    x *= _INV1
    x ^= (x >> U64(30)) ^ (x >> U64(60))
    return x


def shard_dictionary(pan_dict: PanKmerDict, mesh: Mesh) -> ShardedBucketedDict:
    """Shard an existing dictionary (canonical or mixed keys) over the mesh:
    rank r routes the r-th slice of its rows, with their masks, to their
    owners, which lay them out.  Mixed keys are unmixed first, so canonical
    keys are mixed exactly once either way.  A memory-mapped dictionary
    (PanKmerDict.load(mmap=True)) is read only where the rank's slice
    lies."""
    S, dev = mesh.size, mesh.device
    D = len(pan_dict.keys)
    W = pan_dict.masks.shape[1] if pan_dict.masks.ndim == 2 else 1
    per = -(-max(D, 1) // S)
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    keys = pan_dict.keys[sl].astype(U64)
    if pan_dict.key_space == "mixed":
        keys = _unmix64_np(keys)
    m = mix64(from_u64_np(keys, dev))
    masks = torch.from_numpy(np.array(
        pan_dict.masks.reshape(D, W)[sl], np.uint32).view(np.int32)).to(dev)
    order, counts = _by_owner(m, S)
    payload = torch.cat([m[order, None], masks[order].to(torch.int64)], 1)
    recv, _ = all_to_all(mesh, payload, counts)
    srt, idx = torch.sort(flip64(recv[:, 0]))
    out_keys = flip64(srt)
    out_masks = recv[idx, 1:].to(torch.int32)
    del recv, srt, idx
    table, nbits, cap, stride = _shard_layout(mesh, out_keys, out_masks, D, W,
                                              "shard_dictionary")
    return ShardedBucketedDict(table, nbits, cap, stride, pan_dict.ngenomes,
                               pan_dict.k, W, S)


# --------------------------------------------------------------- anchor --


def make_halo_chunks(codes: np.ndarray, n_shards: int, k: int,
                     chunk_per_dev: int | None = None):
    """Split a sequence's codes into per-rank halo'd slices: returns
    (u8 [S, C + k - 1], the sequence's positions nk), C = chunk_per_dev or
    ceil(nk / S).  Rank d covers positions [d*C, (d+1)*C); code 255 pads
    past the sequence (N windows: zero masks, stripped by the caller)."""
    nk = len(codes) - k + 1
    C = -(-nk // n_shards) if chunk_per_dev is None else chunk_per_dev
    out = np.full((n_shards, C + k - 1), 255, np.uint8)
    for d in range(n_shards):
        lo = d * C
        if lo >= nk:
            break
        m = min(C, nk - lo)
        out[d, :m + k - 1] = codes[lo:lo + m + k - 1]
    return out, nk


def _upload_packed(codes: np.ndarray, device):
    packed, nmask, L = pack_bases_np(codes)
    return (torch.from_numpy(packed).to(device),
            torch.from_numpy(nmask).to(device), L)


def sharded_anchor_chunk(mesh: Mesh, sbd: ShardedBucketedDict,
                         codes_slice: np.ndarray):
    """This rank's part of one range-sharded anchor chunk.  codes_slice u8
    [C + k - 1] is the rank's halo'd slice (make_halo_chunks).  Returns
    (bytes uint8 [C, nbytes], popc int32 [C], colsums int32 [32W]) of its C
    positions, on its device; every rank must call it for the chunk."""
    k, W = sbd.k, sbd.nwords
    p, n, L = _upload_packed(codes_slice, mesh.device)
    C = L - k + 1
    hi, lo = kernels.pack_mix(p, n, L, k, C)
    m = (u32(hi) << 32) | u32(lo)
    order, counts = _by_owner(m, mesh.size)
    q, recv = all_to_all(mesh, m[order], counts)
    rows = _local_probe(q, sbd.table, sbd.nbits, sbd.cap, W)
    back, _ = all_to_all(mesh, rows,
                         torch.tensor(recv, dtype=torch.int64, device=m.device))
    rows = torch.empty_like(back)
    rows[order] = back                      # position order
    popc, colsums = kernels.fused_popcount_colsums(rows, 32 * W)
    return kernels.masks_to_bytes(rows, sbd.nbytes_row), popc, colsums


def shard_dictionary_genomes(pan_dict: PanKmerDict,
                             mesh: Mesh) -> GenomeShardedDict:
    """This rank's mask-word slice of a dictionary, laid out on its device
    in the standard top-bits table over all keys.  Bucket loads depend only
    on the keys, so the geometry is common to all ranks.  The rank copies
    only its words of the masks (which may be memory-mapped)."""
    S, dev = mesh.size, mesh.device
    n = len(pan_dict.keys)
    D = max(n, 1)
    W = pan_dict.masks.shape[1] if pan_dict.masks.ndim == 2 else 1
    Wl = -(-W // S)
    w0, w1 = min(mesh.rank * Wl, W), min((mesh.rank + 1) * Wl, W)
    masks = np.zeros((D, Wl), np.uint32)
    masks[:n, :w1 - w0] = pan_dict.masks.reshape(n, W)[:, w0:w1]
    mixed = pan_dict.key_space == "mixed"
    keys = np.full(D, U64(SENTINEL % (1 << 64)), U64)   # padding if empty
    keys[:n] = pan_dict.keys if mixed else mix64_np(pan_dict.keys)
    m = from_u64_np(keys, dev)
    ml = torch.from_numpy(masks.view(np.int32)).to(dev)
    mode = "sorted" if mixed else "sort"
    for extra in range(8):
        nbits, cap, stride = _layout_params(D, 1, Wl, extra, dev, mode)
        table, overflow = layout_rows(m, ml, None, 1 << nbits, cap, stride,
                                      bucket_in_key=True, pre_sorted=mixed)
        if int(all_sum(mesh, overflow.reshape(1).to(torch.int64))) == 0:
            return GenomeShardedDict(table.view(1 << nbits, stride), nbits,
                                     cap, stride, pan_dict.ngenomes,
                                     pan_dict.k, Wl, S)
        del table
    raise RuntimeError("genome shard: bucket overflow persisted")


def genome_sharded_anchor_chunk(mesh: Mesh, gsd: GenomeShardedDict,
                                codes: np.ndarray):
    """This rank's part of one genome-sharded anchor chunk: codes u8 [C + k
    - 1] (the same on every rank) against the rank's mask-word slice.
    Returns (byte slice uint8 [C, 4 * nwords_local], popc int32 [C] summed
    over the ranks, colsums int32 [32 * nwords_local] of the slice's
    genomes), on its device; every rank must call it for the chunk."""
    k, Wl = gsd.k, gsd.nwords_local
    p, n, L = _upload_packed(codes, mesh.device)
    C = L - k + 1
    Ppad = -(-C // TILE_Q) * TILE_Q
    hi, lo = kernels.pack_mix(p, n, L, k, Ppad)
    rows = bucket_query_sorted_pre(hi, lo, None, gsd.table, gsd.nbits,
                                   gsd.cap, Wl, C)
    popc, colsums = kernels.fused_popcount_colsums(rows, 32 * Wl)
    return kernels.masks_to_bytes(rows, 4 * Wl), all_sum(mesh, popc), colsums


def assemble_genome_shards(by_shards: np.ndarray, nbytes: int) -> np.ndarray:
    """Per-rank byte slices [S, C, 4*Wl] -> bitmap rows [C, nbytes]."""
    return np.concatenate(list(by_shards), axis=1)[:, :nbytes]


def stream_mesh_chunks(mesh: Mesh, sharded, codes: np.ndarray, nkmers: int,
                       chunk: int, nbytes: int, ngenomes: int, k: int,
                       pieces: bool = False):
    """The mesh twin of ops/anchor.stream_anchor_chunks, called by every
    rank: yields (start, m, bytes uint8 [m, nbytes], popc int32 [m],
    colsums int64 [ngenomes]) per chunk of `chunk` positions, in order, on
    writer ranks, and (start, m, None, None, None) on the others.  The
    ranks' results are gathered to the writers only (gather_to_writers).

    `sharded` picks the engine: a ShardedBucketedDict sequence-shards each
    chunk (rank d anchors positions [d*C, (d+1)*C), C = ceil(chunk/S)); a
    GenomeShardedDict anchors the whole chunk on every rank.  With pieces
    (range only) the bytes are [(first row in the chunk, rows)] of the
    ranks of the writer's process, gathered within the process, for a
    piece writer."""
    S = mesh.size
    genomes = isinstance(sharded, GenomeShardedDict)
    C = chunk if genomes else -(-chunk // S)
    buf = np.full(chunk + k - 1, 255, np.uint8)
    for start in range(0, nkmers, chunk):
        m = min(chunk, nkmers - start)
        if genomes:
            buf[:] = 255
            buf[:m + k - 1] = codes[start:start + m + k - 1]
            by, popc, colsums = genome_sharded_anchor_chunk(mesh, sharded, buf)
            bys = gather_to_writers(mesh, by)
            colsums = gather_to_writers(mesh, colsums)
        else:
            halo, _ = make_halo_chunks(codes[start:start + m + k - 1], S, k,
                                       C)
            by, popc, colsums = sharded_anchor_chunk(mesh, sharded,
                                                     halo[mesh.rank])
            popc = gather_to_writers(mesh, popc)
            all_sum(mesh, colsums)
            bys = gather_to_writers(mesh, by, local=pieces)
        if not mesh.writer:
            yield start, m, None, None, None
            continue
        if genomes:
            by = assemble_genome_shards(
                np.stack([b.cpu().numpy() for b in bys]), nbytes)[:m]
            colsums = torch.cat(colsums)
        else:
            popc = torch.cat(popc)
            ranks = mesh.local_ranks() if pieces else range(S)
            parts = [(d * C, b[:min(C, m - d * C)].cpu().numpy())
                     for d, b in zip(ranks, bys) if d * C < m]
            by = parts if pieces else np.concatenate([p for _, p in parts])
        popc = popc.cpu().numpy()[:m]
        colsums = colsums.cpu().numpy()[:ngenomes].astype(np.int64)
        yield start, m, by, popc, colsums
