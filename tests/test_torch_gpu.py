"""The CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one.  This module
imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(--noconftest because tests/conftest.py imports jax.)  Inputs come from
numpy with a fixed seed; everything is integer, so every comparison is
exact (tolerance 0).
"""

import filecmp
import os
import threading

import numpy as np
import pytest
import torch

from panagram_tpu_torch import index as port_index
from panagram_tpu_torch import spans
from panagram_tpu_torch.io.fasta import seq_to_codes
from panagram_tpu_torch.ops import count, devdict, dictionary, kernels, lookup
from panagram_tpu_torch.ops import anchor as anchor_ops
from panagram_tpu_torch.ops.anchor import anchor_chunk_fast
from panagram_tpu_torch.ops.codec import (
    mix64,
    pack_bases_np,
    pack_kmers,
    split64,
    u64_np,
)
from panagram_tpu_torch.ops.lookup import (
    TILE_Q,
    BucketedDict,
    bucket_query_pairs,
    bucket_query_sorted_pre,
    plan_probe,
)
from panagram_tpu_torch.ops.ref_impl import anchor_np, masks_to_bytes_np
from panagram_tpu_torch.pipeline import build_index
from panagram_tpu_torch.tools import mosaic_probe

pytestmark = pytest.mark.gpu

K = 31


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py on the card")
    return torch.device("cuda")


def _chunk(rng, L):
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.choice(L, L // 50, replace=False)] = 255
    return codes


def _dict_for(rng, codes, ngenomes):
    """A dictionary holding about half of the chunk's k-mers, random masks
    over ngenomes bits, and as many absent keys."""
    canon, valid = pack_kmers(torch.from_numpy(codes), K)
    keys = np.unique(u64_np(canon[valid]))
    keys = keys[rng.random(len(keys)) < 0.5]
    extra = rng.integers(0, 1 << 62, len(keys), dtype=np.uint64)
    keys = np.unique(np.concatenate([keys, extra]))
    W = (ngenomes + 31) // 32
    masks = rng.integers(1, 1 << 32, (len(keys), W), dtype=np.uint64)
    masks[:, -1] &= np.uint64((1 << (ngenomes - 32 * (W - 1))) - 1)
    masks[:, -1] |= np.uint64(1)
    return keys, masks.astype(np.uint32)


@pytest.mark.parametrize("k", [5, 21, 31])
def test_pack_mix_kernel(cuda, k):
    rng = np.random.default_rng(k)
    L = (1 << 16) + 37
    packed, nmask, _ = pack_bases_np(_chunk(rng, L))
    Ppad = -(-(L - k + 1) // TILE_Q) * TILE_Q
    p, n = torch.from_numpy(packed), torch.from_numpy(nmask)
    before = kernels.launches["pack_mix"]
    hi, lo = kernels.pack_mix(p.to(cuda), n.to(cuda), L, k, Ppad)
    torch.cuda.synchronize()
    assert kernels.launches["pack_mix"] == before + 1
    whi, wlo = kernels.pack_mix_plain(p, n, L, k, Ppad)
    assert torch.equal(hi.cpu(), whi) and torch.equal(lo.cpu(), wlo)


def _sliced_streams(rng, L, cuda):
    """packed and nmask as stream_anchor_chunks passes them: neighbouring
    slices of one device buffer, here one byte past its start, so that
    neither pointer is 4-byte aligned for every L."""
    packed, nmask, _ = pack_bases_np(_chunk(rng, L))
    ib = torch.from_numpy(np.concatenate(
        [np.array([0xA5], np.uint8), packed, nmask])).to(cuda)
    n4 = len(packed)
    return ib[1:1 + n4], ib[1 + n4:]


PACK_LENGTHS = [31, 64, 1027, (1 << 16) + 37, (1 << 22) + 30]


@pytest.mark.parametrize("k", [1, 15, 21, 31])
@pytest.mark.parametrize("L", PACK_LENGTHS)
def test_pack_mix_kernel_grid(cuda, k, L):
    """Byte-aligned input slices; outputs inside larger buffers at a
    16-byte aligned offset (128-bit stores) and at a 4-byte one (word
    stores), whose guard words must stay; every output length the callers
    use.  The plain version at the longest Ppad gives all the others."""
    rng = np.random.default_rng(100 * k + L % 1000)
    p, n = _sliced_streams(rng, L, cuda)
    assert p.is_contiguous() and n.is_contiguous()
    P = L - k + 1
    top = -(-(P + 3) // TILE_Q) * TILE_Q
    whi, wlo = kernels.pack_mix_plain(p, n, L, k, top)
    for Ppad in (P, P + 1, P + 2, P + 3, top):
        for offset in (0, 4, 1):
            bufs = [torch.full((offset + Ppad + 8,), 0x5A5A5A5A,
                               dtype=torch.int32, device=cuda)
                    for _ in range(2)]
            hi, lo = (b[offset:offset + Ppad] for b in bufs)
            before = kernels.launches["pack_mix"]
            kernels._pack_mix_into(p, n, L, k, hi, lo)
            torch.cuda.synchronize()
            assert kernels.launches["pack_mix"] == before + 1
            assert torch.equal(hi, whi[:Ppad]), (Ppad, offset)
            assert torch.equal(lo, wlo[:Ppad]), (Ppad, offset)
            for b in bufs:
                assert bool((b[:offset] == 0x5A5A5A5A).all())
                assert bool((b[offset + Ppad:] == 0x5A5A5A5A).all()), Ppad


@pytest.mark.parametrize("k", [5, 31])
def test_pack_mix_kernel_short_and_long_streams(cuda, k):
    """Bytes past `packed` read as 0 and past `nmask` as 0xFF; a stream
    longer than the positions need is ignored past them; a grid of one
    block loops over the whole chunk."""
    rng = np.random.default_rng(k)
    L = 70_000
    packed, nmask, _ = pack_bases_np(_chunk(rng, L))
    Ppad = -(-(L - k + 1) // TILE_Q) * TILE_Q
    for npk, nnm in ((len(packed) // 2, len(nmask)),
                     (len(packed), len(nmask) // 2),
                     (len(packed) + 40, len(nmask) + 40), (0, 0)):
        p = torch.from_numpy(np.resize(packed, npk)).to(cuda)
        n = torch.from_numpy(np.resize(nmask, nnm)).to(cuda)
        whi, wlo = kernels.pack_mix_plain(p.cpu(), n.cpu(), L, k, Ppad)
        hi, lo = kernels.pack_mix(p, n, L, k, Ppad)
        torch.cuda.synchronize()
        assert torch.equal(hi.cpu(), whi) and torch.equal(lo.cpu(), wlo)
        kernels._pack_mix_into(p, n, L, k, hi.zero_(), lo.zero_(),
                               max_blocks=1)
        torch.cuda.synchronize()
        assert torch.equal(hi.cpu(), whi) and torch.equal(lo.cpu(), wlo)


def test_pack_mix_from_three_threads(cuda):
    """Three threads, each on a stream of its own, launch pack_mix at once
    on different inputs: every result is right and no launch is lost."""
    calls = 30
    rng = np.random.default_rng(8)
    jobs = []
    for k, L in ((31, (1 << 20) + 30), (21, (1 << 19) + 7), (15, 300_001)):
        p, n = _sliced_streams(rng, L, cuda)
        Ppad = -(-(L - k + 1) // TILE_Q) * TILE_Q
        jobs.append((p, n, L, k, Ppad, kernels.pack_mix_plain(p, n, L, k, Ppad)))
    torch.cuda.synchronize()
    before = kernels.launches["pack_mix"]
    wrong = []

    def run(p, n, L, k, Ppad, want):
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for _ in range(calls):
                hi, lo = kernels.pack_mix(p, n, L, k, Ppad)
                if not (torch.equal(hi, want[0]) and torch.equal(lo, want[1])):
                    wrong.append(k)

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert not wrong
    assert kernels.launches["pack_mix"] - before == len(jobs) * calls


@pytest.mark.parametrize("ngenomes", [30, 40, 70, 100])
def test_probe_popcount_bytes_kernels(cuda, ngenomes):
    rng = np.random.default_rng(ngenomes)
    L = (1 << 17) + K - 1
    codes = _chunk(rng, L)
    keys, masks = _dict_for(rng, codes, ngenomes)
    bd = BucketedDict.build(keys, masks, ngenomes, K).to(cuda)
    packed, nmask, _ = pack_bases_np(codes)
    Ppad = 1 << 17
    hi, lo = kernels.pack_mix(torch.from_numpy(packed).to(cuda),
                              torch.from_numpy(nmask).to(cuda), L, K, Ppad)
    plan = plan_probe(hi, lo, bd.nbits)
    args = (plan.qhi, plan.qlo, plan.blo, bd.table, bd.nbits, bd.cap,
            bd.nwords, plan.span, plan.tile_q)
    rows = kernels.probe_sorted(*args)
    torch.cuda.synchronize()
    assert torch.equal(rows, kernels.probe_sorted_plain(*args))
    assert rows.any()

    popc, cols = kernels.fused_popcount_colsums(rows, 32 * bd.nwords)
    wp, wc = kernels.fused_popcount_colsums_plain(rows, 32 * bd.nwords)
    torch.cuda.synchronize()
    assert torch.equal(popc, wp) and torch.equal(cols, wc)

    nbytes = (ngenomes + 7) // 8
    by = kernels.masks_to_bytes(rows, nbytes)
    torch.cuda.synchronize()
    assert torch.equal(by, kernels.masks_to_bytes_plain(rows, nbytes))


def _edge_dict(rng, W, nbits=6):
    """Mixed keys and masks for a 2^nbits-bucket table at the layout's
    geometry for W words: every fourth bucket full (cap keys), the others
    0..cap keys; bucket 0 holds keys whose lo word is all ones, the last
    bucket keys whose hi word is all ones.  Returns (keys uint64, masks
    uint32 [n, W], cap, stride)."""
    _, cap, stride = lookup.table_geometry(1, W)
    B, shift = 1 << nbits, 32 - nbits
    pairs = set()
    for b in range(B):
        n = cap if b % 4 == 0 else int(rng.integers(0, cap + 1))
        row = set()
        while len(row) < n:
            h = (b << shift) | int(rng.integers(0, 1 << shift))
            lo = int(rng.integers(0, 1 << 32))
            if b == 0 and rng.random() < 0.3:
                lo = 0xFFFFFFFF
            if b == B - 1 and rng.random() < 0.3:
                h = 0xFFFFFFFF
            if (h, lo) != (0xFFFFFFFF, 0xFFFFFFFF):
                row.add((h, lo))
        pairs |= row
    keys = np.array([(h << 32) | lo for h, lo in sorted(pairs)], np.uint64)
    masks = rng.integers(1, 1 << 32, (len(keys), W), dtype=np.uint64)
    return keys, masks.astype(np.uint32), cap, stride


def _edge_queries(rng, keys, nbits, tile_q):
    """Every key (hits at every slot, cap - 1 of the full rows among them),
    as many misses spread over the buckets (on full rows too, which have no
    empty slot to end the scan), misses with an all-ones hi or lo word and
    all-ones queries, shuffled and padded to a multiple of tile_q."""
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    n = len(keys)
    miss_hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    miss_lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    ones = np.uint32(0xFFFFFFFF)
    extra_hi = np.array([ones, ones, 5, ones, ones], np.uint32)
    extra_lo = np.array([3, 0x12345, ones, ones, ones], np.uint32)
    qh = np.concatenate([hi, miss_hi, extra_hi])
    ql = np.concatenate([lo, miss_lo, extra_lo])
    perm = rng.permutation(len(qh))
    pad = -len(qh) % tile_q
    qh = np.concatenate([qh[perm], np.full(pad, ones, np.uint32)])
    ql = np.concatenate([ql[perm], np.full(pad, ones, np.uint32)])
    return qh.view(np.int32), ql.view(np.int32)


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
def test_probe_sorted_kernel_edges(cuda, W):
    """The probe_sorted kernel against its plain version on a table built
    to its edges: hits at slot cap - 1 of full rows and misses on them (no
    empty slot ends the scan), keys whose hi or lo word alone is all ones, all-ones queries
    against rows with empty slots, the whole-table window and a window of
    2 rows that leaves queries outside it; then a table view at an odd word
    (the scalar path) and outputs at an odd word (no vector store).  W=1
    and W=2 load 64-byte pieces of an aligned row; W=3-5 take the scalar
    path."""
    rng = np.random.default_rng(100 + W)
    nbits, tile_q = 6, 64
    keys, masks, cap, stride = _edge_dict(rng, W, nbits)
    table, overflow = BucketedDict._layout(keys, masks, nbits, cap, stride)
    assert overflow == 0
    t = torch.from_numpy(table.view(np.int32)).to(cuda)
    qh, ql = _edge_queries(rng, keys, nbits, tile_q)
    hi, lo = torch.from_numpy(qh).to(cuda), torch.from_numpy(ql).to(cuda)
    Q = hi.shape[0]
    order = torch.argsort(hi.to(torch.int64) & 0xFFFFFFFF)
    qhi, qlo = hi[order], lo[order]
    brow = lookup.bucket_row(qhi, nbits)
    for span in (1 << nbits, 2):
        # each tile's window starts at its first query's bucket row
        blo = torch.clamp(brow[::tile_q], 0, (1 << nbits) - span)
        args = (qhi, qlo, blo.to(torch.int32), t, nbits, cap, W, span,
                tile_q)
        want = kernels.probe_sorted_plain(*args)
        assert want.any(dim=1).sum() > len(keys) // 2
        first = blo.repeat_interleave(tile_q)
        assert bool(((brow - first) >= span).any()) == (span == 2)
        before = kernels.launches["probe_sorted"]
        assert torch.equal(kernels.probe_sorted(*args), want)
        assert kernels.launches["probe_sorted"] == before + 1

        flat = torch.empty(t.numel() + 1, dtype=torch.int32, device=cuda)
        flat[1:] = t.reshape(-1)
        odd = flat[1:].view(t.shape)
        assert odd.data_ptr() % 16 == 4
        assert torch.equal(kernels.probe_sorted(*args[:3], odd, *args[4:]),
                           want)
        buf = torch.full((Q * W + 1,), -77, dtype=torch.int32, device=cuda)
        kernels._probe_sorted_into(*args, buf[1:].view(Q, W))
        torch.cuda.synchronize()
        assert int(buf[0]) == -77
        assert torch.equal(buf[1:].view(Q, W), want)


# the shapes at which the two redesigned kernels branch (the CPU tests pin
# their plain versions against panagram_tpu at the same ones): W with a
# vector instance (1, 2, 4) and without (3, 5); nbytes that cut nothing,
# one byte, three bytes, all but one; row counts around the 16-byte pieces,
# one staged tile and many
BYTES_GRID = [(W, nb) for W in (1, 2, 3, 4, 5)
              for nb in sorted({1, 4 * W - 3, 4 * W - 1, 4 * W})]
POPC_GRID = [(1, 30), (1, 32), (2, 40), (3, 70), (4, 100), (5, 130)]
ROW_COUNTS = [1, 15, 17, 2048, (1 << 17) + 3]
SKIPS = [0, 1, 3]    # rows[skip:]: 4 W skip bytes into its allocation


def _rows_on_card(rng, P, W, N, cuda):
    rows = rng.integers(0, 1 << 32, (P, W), dtype=np.uint64)
    rows[:, -1] &= np.uint64((1 << (N - 32 * (W - 1))) - 1)
    return torch.from_numpy(rows.astype(np.uint32).view(np.int32)).to(cuda)


@pytest.mark.parametrize("W,nbytes", BYTES_GRID)
def test_masks_to_bytes_kernel_grid(cuda, W, nbytes):
    """Every branch of the kernel, on whole tensors and on contiguous
    slices whose pointer is 4-byte but not 16-byte aligned."""
    rng = np.random.default_rng(100 * W + nbytes)
    for P in ROW_COUNTS:
        base = _rows_on_card(rng, P + max(SKIPS), W, 32 * W, cuda)
        for skip in SKIPS:
            rows = base[skip:skip + P]
            assert rows.is_contiguous()
            before = kernels.launches["masks_to_bytes"]
            got = kernels.masks_to_bytes(rows, nbytes)
            torch.cuda.synchronize()
            assert kernels.launches["masks_to_bytes"] == before + 1
            want = kernels.masks_to_bytes_plain(rows.cpu(), nbytes)
            assert torch.equal(got.cpu(), want), (P, skip)


@pytest.mark.parametrize("offset", [0, 16, 5])
@pytest.mark.parametrize("W,nbytes", [(1, 4), (1, 3), (2, 5), (5, 17)])
def test_masks_to_bytes_writes_nothing_past_its_output(cuda, W, nbytes, offset):
    """The output sits inside a larger buffer (at a 16-byte aligned offset
    and at an odd one); the bytes before and after it stay untouched."""
    rng = np.random.default_rng(W + nbytes + offset)
    for P in (1, 15, 17, 1027, (1 << 16) + 3):
        rows = _rows_on_card(rng, P, W, 32 * W, cuda)
        buf = torch.full((offset + P * nbytes + 64,), 0xAB, dtype=torch.uint8,
                         device=cuda)
        out = buf[offset:offset + P * nbytes].view(P, nbytes)
        kernels._masks_to_bytes_into(rows, out)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(),
                           kernels.masks_to_bytes_plain(rows.cpu(), nbytes))
        assert bool((buf[:offset] == 0xAB).all())
        assert bool((buf[offset + P * nbytes:] == 0xAB).all()), P


@pytest.mark.parametrize("W,N", POPC_GRID)
def test_fused_popcount_colsums_kernel_grid(cuda, W, N):
    """Every branch of the kernel on whole tensors and unaligned slices,
    with N below 32 W (columns at or past N are not written) and at it."""
    rng = np.random.default_rng(17 * W + N)
    for P in ROW_COUNTS:
        base = _rows_on_card(rng, P + max(SKIPS), W, N, cuda)
        for skip in SKIPS:
            rows = base[skip:skip + P]
            for n in (N, 32 * W):
                before = kernels.launches["fused_popcount_colsums"]
                popc, cols = kernels.fused_popcount_colsums(rows, n)
                torch.cuda.synchronize()
                assert kernels.launches["fused_popcount_colsums"] == before + 1
                wp, wc = kernels.fused_popcount_colsums_plain(rows.cpu(), n)
                assert torch.equal(popc.cpu(), wp), (P, skip, n)
                assert torch.equal(cols.cpu(), wc), (P, skip, n)


@pytest.mark.parametrize("W", [1, 2, 4, 5])
def test_fused_popcount_colsums_all_ones_past_a_flush(cuda, W):
    """Rows of all ones over 70,000 rows and over 2^22: every column
    counter of a thread fills between two flushes."""
    for P in (70_000, 1 << 22):
        rows = torch.full((P, W), -1, dtype=torch.int32, device=cuda)
        popc, cols = kernels.fused_popcount_colsums(rows, 32 * W)
        torch.cuda.synchronize()
        assert bool((popc == 32 * W).all()) and bool((cols == P).all())


@pytest.mark.parametrize("offset", [0, 4, 1])
@pytest.mark.parametrize("W,N", [(1, 30), (2, 40), (4, 100), (5, 130)])
def test_fused_popcount_colsums_writes_nothing_past_its_outputs(cuda, W, N,
                                                                offset):
    """popc and colsums sit inside larger buffers (popc at a 16-byte
    aligned offset and at a 4-byte one); the words around them stay."""
    rng = np.random.default_rng(W + N + offset)
    for P in (1, 15, 17, 1027, (1 << 16) + 3):
        rows = _rows_on_card(rng, P, W, N, cuda)
        pbuf = torch.full((offset + P + 16,), -77, dtype=torch.int32,
                          device=cuda)
        cbuf = torch.zeros(N + 16, dtype=torch.int32, device=cuda)
        kernels._popcount_colsums_into(rows, N, pbuf[offset:offset + P],
                                       cbuf[:N])
        torch.cuda.synchronize()
        wp, wc = kernels.fused_popcount_colsums_plain(rows.cpu(), N)
        assert torch.equal(pbuf[offset:offset + P].cpu(), wp)
        assert torch.equal(cbuf[:N].cpu(), wc)
        assert bool((pbuf[:offset] == -77).all())
        assert bool((pbuf[offset + P:] == -77).all()) and not bool(cbuf[N:].any())


def test_kernels_past_2_31_bytes(cuda):
    """Outputs of more than 2^31 bytes and inputs of more than 2^31 words:
    the kernels' indices are 64-bit and their grids loop."""
    P = (1 << 29) + 5
    rows = torch.full((P, 1), 0x04030201, dtype=torch.int32, device=cuda)
    got = kernels.masks_to_bytes(rows, 4)
    torch.cuda.synchronize()
    assert got.shape == (P, 4) and torch.equal(got.view(torch.int32), rows)
    del got, rows
    rows = torch.full((P, 2), 0x04030201, dtype=torch.int32, device=cuda)
    got = kernels.masks_to_bytes(rows, 5)
    torch.cuda.synchronize()
    want = torch.tensor([1, 2, 3, 4, 1], dtype=torch.uint8, device=cuda)
    assert P * 5 > 1 << 31
    assert bool((got[:1000] == want).all()) and bool((got[-1000:] == want).all())
    mid = (1 << 31) // 5      # the row that holds byte 2^31
    assert bool((got[mid - 100:mid + 100] == want).all())
    del got, rows
    torch.cuda.empty_cache()
    rows = torch.full((P, 4), -1, dtype=torch.int32, device=cuda)
    popc, cols = kernels.fused_popcount_colsums(rows, 128)
    torch.cuda.synchronize()
    assert bool((popc == 128).all()) and bool((cols == P).all())


def test_anchor_chunk_matches_oracle(cuda):
    """The dense chunk through all four kernels equals the numpy oracle,
    and its merge probe the gather probe."""
    rng = np.random.default_rng(5)
    L = (1 << 16) + K - 1
    codes = _chunk(rng, L)
    keys, masks = _dict_for(rng, codes, 30)
    bd = BucketedDict.build(keys, masks, 30, K).to(cuda)
    packed, nmask, _ = pack_bases_np(codes)
    by, popc, cols = anchor_chunk_fast(torch.from_numpy(packed).to(cuda),
                                       torch.from_numpy(nmask).to(cuda),
                                       bd.table, L, K, bd.nbits, bd.cap,
                                       bd.nwords, 4)
    torch.cuda.synchronize()
    rows = anchor_np(codes, K, keys, masks)
    P = L - K + 1
    assert np.array_equal(by.cpu().numpy(), masks_to_bytes_np(rows, 4))
    bits = np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")
    assert np.array_equal(popc.cpu().numpy()[:P], bits.sum(axis=1))
    assert np.array_equal(cols.cpu().numpy(), bits.sum(axis=0))

    hi, lo = kernels.pack_mix(torch.from_numpy(packed).to(cuda),
                              torch.from_numpy(nmask).to(cuda), L, K, 1 << 16)
    want = bucket_query_pairs(hi, lo, bd.table, bd.nbits, bd.cap, bd.nwords)
    got = bucket_query_sorted_pre(hi, lo, None, bd.table, bd.nbits, bd.cap,
                                  bd.nwords, 1 << 16)
    assert torch.equal(got, want)


def test_default_probe_route_makes_no_host_sync(cuda):
    """Neither the merge probe nor the whole dense chunk brings a value
    back to the host: torch's sync debug mode raises on any synchronising
    call, as it does on a value read back."""
    rng = np.random.default_rng(6)
    L = (1 << 17) + K - 1
    codes = _chunk(rng, L)
    codes[5000:40_000] = 255         # a gap: a run of identical N queries
    keys, masks = _dict_for(rng, codes, 30)
    bd = BucketedDict.build(keys, masks, 30, K).to(cuda)
    packed, nmask, _ = pack_bases_np(codes)
    p, n = torch.from_numpy(packed).to(cuda), torch.from_numpy(nmask).to(cuda)
    hi, lo = kernels.pack_mix(p, n, L, K, 1 << 17)
    want = bucket_query_pairs(hi, lo, bd.table, bd.nbits, bd.cap, bd.nwords)
    ref = anchor_chunk_fast(p, n, bd.table, L, K, bd.nbits, bd.cap,
                            bd.nwords, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bucket_query_sorted_pre(hi, lo, None, bd.table, bd.nbits,
                                      bd.cap, bd.nwords, 1 << 17)
        out = anchor_chunk_fast(p, n, bd.table, L, K, bd.nbits, bd.cap,
                                bd.nwords, 4)
        with pytest.raises(RuntimeError):
            int(hi[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("trace", [False, True])
def test_stream_times_the_copy_back_on_card(cuda, trace):
    """A two-chunk stream on the card adds the copy-back's card time to
    phase["copy"] whether or not it traces, and yields the CPU stream's
    items."""
    rng = np.random.default_rng(8)
    chunk = 1 << 16
    codes = _chunk(rng, 2 * chunk + K - 1)
    keys, masks = _dict_for(rng, codes, 100)
    bd = BucketedDict.build(keys, masks, 100, K)
    nk = len(codes) - K + 1

    def run(on, phase):
        return [(s, m, by.copy(), p.copy(), c.copy())
                for s, m, by, p, c in anchor_ops.stream_anchor_chunks(
                    codes, nk, chunk, None, None, on, 13, 100, K,
                    trace=trace, phase=phase)]

    phase = {}
    got = run(bd.to(cuda), phase)
    want = run(bd.to("cpu"), {})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert all(np.array_equal(a, b) for a, b in zip(g[2:], w[2:]))
    assert phase["copy"] > 0 and phase["pack"] > 0


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("L,cut", [((1 << 22) + 30, 0),
                                   ((1 << 22) + 30, (1 << 20) + 5),
                                   ((1 << 21) + 20, 0), ((1 << 21) + 20, 13),
                                   (37, 0), (37, 11)])
def test_pack_bases_kernel(cuda, L, cut, offset):
    """The CUDA pack_bases against pack_bases_plain on the card, at the two
    anchor cells' chunks (2^22 + 30 and 2^21 + 20 bases) and an odd small
    L, with nvalid = L - cut (cuts off byte and word boundaries: codes
    past nvalid are junk), codes with N and other values >= 4; at offset 3
    the codes and the output are unaligned (the byte-by-byte path).  One
    launch; nothing written past the two arrays."""
    rng = np.random.default_rng(L + cut + offset)
    codes = _chunk(rng, L)
    codes[rng.choice(L, L // 100, replace=False)] = 7
    nvalid = L - cut
    c = torch.from_numpy(np.concatenate(
        [np.zeros(offset, np.uint8), codes])).to(cuda)[offset:]
    n = -(-L // 4) + -(-L // 8)
    out = torch.full((offset + n + 9,), 0xAB, dtype=torch.uint8, device=cuda)
    want = out.clone()
    before = kernels.launches["pack_bases"]
    kernels.pack_bases(c, nvalid, L, out[offset:])
    kernels.pack_bases_plain(c, nvalid, L, want[offset:])
    torch.cuda.synchronize()
    assert kernels.launches["pack_bases"] == before + 1
    assert torch.equal(out, want)
    if L < 100:
        buf = np.full(L, 255, np.uint8)
        buf[:nvalid] = codes[:nvalid]
        packed, nmask, _ = pack_bases_np(buf)
        assert np.array_equal(out[offset:offset + n].cpu().numpy(),
                              np.concatenate([packed, nmask]))


def _stream_case(rng, chunk, nk, ngenomes=30):
    codes = _chunk(rng, nk + K - 1)
    keys, masks = _dict_for(rng, codes, ngenomes)
    return codes, BucketedDict.build(keys, masks, ngenomes, K)


def test_stream_packs_each_chunk_once_on_card(cuda):
    """A stream of c chunks (the last one short) launches pack_bases c
    times, as each anchor kernel, and yields the CPU stream's items."""
    rng = np.random.default_rng(19)
    chunk = 1 << 16
    nk = 3 * chunk - 999
    codes, bd = _stream_case(rng, chunk, nk)

    def run(on):
        return [(s, m, by.copy(), p.copy(), c.copy())
                for s, m, by, p, c in anchor_ops.stream_anchor_chunks(
                    codes, nk, chunk, None, None, on, 4, 30, K)]

    on_card = bd.to(cuda)
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    got = run(on_card)
    torch.cuda.synchronize()
    after = dict(kernels.launches)
    want = run(bd.to("cpu"))
    assert {n: after[n] - before[n] for n in after} == {
        n: 3 if n in ("pack_bases", "pack_mix", "probe_sorted",
                      "fused_popcount_colsums", "masks_to_bytes") else 0
        for n in after}
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert all(np.array_equal(a, b) for a, b in zip(g[2:], w[2:]))


def test_stream_peak_no_higher_than_host_packing(cuda):
    """One streamed 2^22-position chunk peaks at no more device memory than
    the same chunk packed on the host and uploaded packed, as the stream
    did before: the device codes are freed before the chunk's kernels."""
    rng = np.random.default_rng(20)
    chunk = 1 << 22
    codes, bd = _stream_case(rng, chunk, chunk)
    bd = bd.to(cuda)
    L = chunk + K - 1
    n4 = -(-L // 4)

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    def streamed():
        for _ in anchor_ops.stream_anchor_chunks(codes, chunk, chunk, None,
                                                 None, bd, 4, 30, K):
            pass

    def host_packed():
        packed, nmask, _ = pack_bases_np(codes)
        ib = torch.from_numpy(np.concatenate([packed, nmask])).to(cuda)
        out = anchor_ops._anchor_chunk_padded(ib[:n4], ib[n4:], L, K,
                                              bd.table, bd.nbits, bd.cap,
                                              bd.nwords, 4)
        for t in out:
            t.cpu()

    streamed()
    host_packed()
    assert peak(streamed) <= peak(host_packed)


@pytest.mark.parametrize("ngenomes", [30, 40, 100])
def test_merge_memory_bounded_per_pair(cuda, ngenomes):
    """The dictionary merge of T (key, genome) pairs peaks under 64 bytes
    per pair beside nothing else (its sort holds about 52), and equals the
    CPU's merge; bit 31 of a mask word and words past the first are
    covered by 40 and 100 genomes."""
    rng = np.random.default_rng(ngenomes)
    T = 20_000_000
    base = rng.integers(0, 1 << 62, T // 8, dtype=np.int64)
    base[:2] = [(1 << 62) - 1, 0]
    keys = np.concatenate([rng.permutation(base)[:T // ngenomes]
                           for _ in range(ngenomes)])
    gids = np.repeat(np.arange(ngenomes, dtype=np.int32), T // ngenomes)
    W = (ngenomes + 31) // 32
    # distinct (key, genome) pairs: each genome's keys are distinct
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    pairs = [torch.from_numpy(keys).to(cuda), torch.from_numpy(gids).to(cuda)]
    out_keys, out_masks = dictionary._merge_sets(pairs, W)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    assert not pairs
    assert peak <= 64 * len(keys), peak / len(keys)
    wk, wm = dictionary._merge_sets(
        [torch.from_numpy(keys), torch.from_numpy(gids)], W)
    assert out_masks.dtype == torch.int32 and out_masks.shape == (len(wk), W)
    assert torch.equal(out_keys.cpu(), wk) and torch.equal(out_masks.cpu(), wm)


@pytest.mark.parametrize("n", [1024, 777, 1 << 20])
def test_mosaic_probe_kernel(cuda, n):
    a, b = mosaic_probe.probe_inputs(n)
    ta = torch.from_numpy(a.view(np.int32))
    tb = torch.from_numpy(b.view(np.int32))
    before = kernels.launches["mosaic_probe"]
    got = kernels.mosaic_probe(ta.to(cuda), tb.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launches["mosaic_probe"] == before + 1
    assert torch.equal(got.cpu(), kernels.mosaic_probe_plain(ta, tb))


def test_mosaic_probe_tool(cuda, capsys):
    before = kernels.launches["mosaic_probe"]
    assert mosaic_probe.main([]) == 0
    assert kernels.launches["mosaic_probe"] == before + 1
    checks = [line for line in capsys.readouterr().out.splitlines()
              if "ok:" in line or "exact:" in line]
    assert len(checks) == 4 and all(c.endswith("True") for c in checks)


def test_count_memory_bounded_by_chunk(cuda):
    """Counting keeps at most SPILL_CHUNKS chunk sets on the card: the peak
    of a 32-chunk sequence is that of an 8-chunk one, and within a few
    times the peak of counting one chunk.  The result equals the CPU's."""
    chunk = 1 << 16
    rng = np.random.default_rng(16)

    def peak(nchunks):
        codes = rng.integers(0, 4, nchunks * chunk + K - 1).astype(np.uint8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = count.distinct_kmers_chunked([codes], K, chunk=chunk, device=cuda)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, codes, got

    one, _, _ = peak(1)
    short, _, _ = peak(8)
    long_, codes, got = peak(32)
    assert long_ <= 1.25 * short
    assert long_ < 8 * one
    want = count.distinct_kmers_chunked([codes], K, chunk=chunk, device="cpu")
    assert np.array_equal(got, want)


def _mixed_sorted(rng, n, ngenomes):
    keys = np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))
    W = (ngenomes + 31) // 32
    masks = rng.integers(1, 1 << 32, (len(keys), W), dtype=np.uint64)
    masks[:, -1] &= np.uint64((1 << (ngenomes - 32 * (W - 1))) - 1)
    masks[:, -1] |= np.uint64(1)
    m = lookup.mix64_np(keys)
    order = np.argsort(m)
    pad = np.full(1 << int(np.ceil(np.log2(len(keys) + 1))),
                  np.uint64(0xFFFFFFFFFFFFFFFF))
    pad[:len(keys)] = m[order]
    pm = np.zeros((len(pad), W), np.uint32)
    pm[:len(keys)] = masks[order]
    return keys, masks.astype(np.uint32), pad, pm


@pytest.mark.parametrize("ngenomes", [30, 100])
def test_build_device_routes_on_card(cuda, ngenomes):
    """The device layout on the card equals the CPU's (which equals
    panagram_tpu's, tests/test_torch_layout.py): canonical input, and sorted
    mixed input through the single, chunked and host routes."""
    rng = np.random.default_rng(ngenomes)
    keys, masks, mp, maskp = _mixed_sorted(rng, 200_000, ngenomes)
    want = BucketedDict.build_device(keys, masks, ngenomes, K, device="cpu")
    got = BucketedDict.build_device(keys, masks, ngenomes, K, device=cuda)
    assert torch.equal(got.table.cpu(), want.table)

    D, W = len(keys), maskp.shape[1]
    want = BucketedDict.build_device(mp, maskp, ngenomes, K, mixed=True,
                                     count=D, sorted_input=True, device="cpu")
    nbits, _, stride = lookup.table_geometry(D, W)
    fixed = (1 << nbits) * stride * 4 + lookup.ANCHOR_RESERVE_BYTES
    for free, route in (
            (None, "single"),
            (fixed + lookup.layout_bytes(D, W, "chunked", 1 << 14), "chunked"),
            (fixed, "host")):
        free = free if free is not None else torch.cuda.mem_get_info()[0]
        assert lookup.layout_route(D, W, cuda, True, free, 1 << 14) == route
        got = BucketedDict.build_device(mp, maskp, ngenomes, K, mixed=True,
                                        count=D, sorted_input=True,
                                        device=cuda, free=free,
                                        piece_rows=1 << 14)
        assert got.table.device.type == "cuda"
        assert torch.equal(got.table.cpu(), want.table), route


def test_device_dict_on_card(cuda):
    """The device dictionary builder on the card runs pack_mix and equals
    the CPU builder, through to_host and through its bucket table."""
    rng = np.random.default_rng(3)
    bases = np.array(list("ACGTN"))
    seqs = ["".join(rng.choice(bases, 20_000, p=[0.2475] * 4 + [0.01]))
            for _ in range(40)]
    builders = [devdict.DeviceDictBuilder(K, 40, chunk=4096, device=dev)
                for dev in ("cpu", cuda)]
    before = kernels.launches["pack_mix"]
    for b in builders:
        for gid, s in enumerate(seqs):
            b.add_sequence(gid, seq_to_codes(s))
    assert kernels.launches["pack_mix"] - before == 40 * 5
    want, got = (b.to_host() for b in builders)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.masks, want.masks)
    tw, tg = (b.bucketed().table for b in builders)
    assert tg.device.type == "cuda" and torch.equal(tg.cpu(), tw)


def test_fastq_count_on_card_bounded(cuda):
    """FASTQ counting on the card equals the CPU path, and keeps at most
    SPILL_CHUNKS counted chunks there: the peak of a 32-chunk read set is
    that of an 8-chunk one."""
    chunk = 1 << 16
    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, 1 << 20).astype(np.uint8)

    def reads(nchunks):
        # 150-bp reads at ~2x of a region, 0.5% substitutions
        n = nchunks * chunk // 151
        starts = rng.integers(0, len(genome) - 150, n)
        out = [genome[s:s + 150].copy() for s in starts]
        for r in out:
            bad = rng.random(150) < 0.005
            r[bad] = rng.integers(0, 4, int(bad.sum()))
        return out

    def peak(rs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = count.counted_kmers_chunked(rs, K, chunk=chunk, device=cuda)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, got

    short, _ = peak(reads(8))
    rs = reads(32)
    long_, got = peak(rs)
    assert long_ <= 1.25 * short
    want = count.counted_kmers_chunked(rs, K, chunk=chunk, device="cpu")
    assert len(got) > 0 and np.array_equal(got, want)


def _pinned(a):
    return torch.from_numpy(a.view(np.int64)).is_pinned()


@pytest.mark.parametrize("chunks", [3, 13])
def test_count_spills_land_page_locked(cuda, chunks):
    """Both counting functions on the card equal the CPU's bit for bit
    with one spill and with several, and every spill lands page-locked
    (count.readback.pinned = the count.readback spans); a one-spill set is
    the page-locked block itself."""
    chunk = 1 << 14
    rng = np.random.default_rng(chunks)
    codes = rng.integers(0, 4, chunks * chunk + K - 1).astype(np.uint8)
    codes[rng.choice(len(codes), len(codes) // 100, replace=False)] = 4
    reads = [codes[s:s + 150] for s in range(0, len(codes) - 150, 75)]
    with spans.recording() as rec:
        got = count.distinct_kmers_chunked([codes], K, chunk, device=cuda)
        got_c = count.counted_kmers_chunked(reads, K, 2, chunk, device=cuda)
    want = count.distinct_kmers_chunked([codes], K, chunk, device="cpu")
    want_c = count.counted_kmers_chunked(reads, K, 2, chunk, device="cpu")
    assert got.dtype == np.uint64 and got.flags.writeable
    assert np.array_equal(got, want) and len(want)
    assert np.array_equal(got_c, want_c) and len(want_c)
    tot = rec.totals()
    spills = tot["spans"]["count.readback"]["count"]
    assert spills >= -(-chunks // count.SPILL_CHUNKS) + 1
    assert tot["counters"]["count.readback.pinned"] == spills
    assert _pinned(got) == (chunks <= count.SPILL_CHUNKS)


def test_count_result_keeps_its_page_locked_block(cuda):
    """A first set kept alive is unchanged after a second count of the
    same size, which takes a block of its own; the next count after a set
    is dropped takes a cached block and allocates none."""
    chunk = 1 << 16
    rng = np.random.default_rng(23)
    a, b = (rng.integers(0, 4, 2 * chunk + K - 1).astype(np.uint8)
            for _ in range(2))
    first = count.distinct_kmers_chunked([a], K, chunk, device=cuda)
    keep = first.copy()
    second = count.distinct_kmers_chunked([b], K, chunk, device=cuda)
    assert _pinned(first) and _pinned(second)
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, keep)
    assert np.array_equal(
        second, count.distinct_kmers_chunked([b], K, chunk, device="cpu"))
    del second
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    third = count.distinct_kmers_chunked([b], K, chunk, device=cuda)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
    assert _pinned(third) and np.array_equal(first, keep)


def test_dictionary_over_page_locked_sets(cuda):
    """build_dictionary over the card's page-locked sets equals the one
    built from their pageable copies."""
    chunk = 1 << 16
    rng = np.random.default_rng(29)
    base = rng.integers(0, 4, 3 * chunk).astype(np.uint8)
    sets = []
    for _ in range(5):
        g = base.copy()
        at = rng.choice(len(g), len(g) // 100, replace=False)
        g[at] = rng.integers(0, 4, len(at)).astype(np.uint8)
        sets.append(count.distinct_kmers_chunked([g], K, chunk, device=cuda))
    assert all(_pinned(s) for s in sets)
    copies = [s.copy() for s in sets]
    assert not any(_pinned(c) for c in copies)
    got = dictionary.build_dictionary(sets, K, 5, device=cuda)
    want = dictionary.build_dictionary(copies, K, 5, device=cuda)
    assert np.array_equal(got.keys, want.keys) and len(want.keys)
    assert np.array_equal(got.masks, want.masks)


def _write_genomes(tmp, rng, n=4, bp=700_000):
    """n genomes of two chromosomes each (bp and bp // 2), one base with
    0.5% private substitutions per genome."""
    base = rng.integers(0, 4, bp + bp // 2).astype(np.uint8)
    rows = []
    for g in range(n):
        s = base.copy()
        pos = rng.choice(len(s), len(s) // 200, replace=False)
        s[pos] = rng.integers(0, 4, len(pos))
        seq = np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode()
        path = tmp / f"g{g}.fa"
        path.write_text(f">chr1\n{seq[:bp]}\n>chr2\n{seq[bp:]}\n")
        rows.append(f"g{g}\t{path}\n")
    samples = tmp / "samples.tsv"
    samples.write_text("name\tfasta\n" + "".join(rows))
    return samples


def test_threaded_anchoring_on_card(cuda, tmp_path, monkeypatch):
    """3 anchor threads on one card write what one thread writes, and
    launch each anchor kernel once per chunk, as the serial build does."""
    monkeypatch.setattr(port_index, "ANCHOR_CHUNK", 1 << 18)
    samples = _write_genomes(tmp_path, np.random.default_rng(9))
    anchors = ["g0", "g1", "g2"]
    launched = {}
    for cores in (1, 3):
        kernels.reset_launches()
        build_index(str(samples), prefix=str(tmp_path / f"c{cores}"), k=K,
                    device=cuda, cores=cores, anchor_genomes=anchors)
        torch.cuda.synchronize()
        launched[cores] = dict(kernels.launches)
    chunks = len(anchors) * (-(-(700_000 - K + 1) // (1 << 18))
                             + -(-(350_000 - K + 1) // (1 << 18)))
    for name in ("pack_mix", "probe_sorted", "fused_popcount_colsums",
                 "masks_to_bytes"):
        assert launched[1][name] == launched[3][name] == chunks, name
    n = 0
    for root, _, files in os.walk(tmp_path / "c3"):
        rel = os.path.relpath(root, tmp_path / "c3")
        if rel.split(os.sep)[0] == "logs":
            continue
        for fn in files:
            if fn != "config.yaml":
                assert filecmp.cmp(os.path.join(root, fn),
                                   tmp_path / "c1" / rel / fn,
                                   shallow=False), (rel, fn)
                n += 1
    assert n == 2 + 5 + 9 * len(anchors)


def test_kernel_counter_threads_on_card(cuda):
    """N threads that launch two kernels M times each, on a stream of their
    own, raise each counter by N x M (no update is lost), and every launch
    gives the right result: launches share no scratch on the card."""
    nthreads, calls = 6, 50
    rows = torch.from_numpy(np.arange(1 << 18, dtype=np.int32).reshape(-1, 2)
                            ).to(cuda)
    want_b = kernels.masks_to_bytes_plain(rows, 5)
    want_p, want_c = kernels.fused_popcount_colsums_plain(rows, 40)
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    wrong = []

    def run():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for _ in range(calls):
                by = kernels.masks_to_bytes(rows, 5)
                popc, cols = kernels.fused_popcount_colsums(rows, 40)
                if not (torch.equal(by, want_b) and torch.equal(popc, want_p)
                        and torch.equal(cols, want_c)):
                    wrong.append(1)

    threads = [threading.Thread(target=run) for _ in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert not wrong
    for name in ("masks_to_bytes", "fused_popcount_colsums"):
        assert kernels.launches[name] - before[name] == nthreads * calls


@pytest.mark.parametrize("ngenomes", [3, 32, 34, 100])
def test_annotate_occupancy_kernel(cuda, ngenomes):
    """The annotate popcount (bitmap bytes widened to u32 words, then
    fused_popcount_colsums) equals its plain version and numpy's."""
    rng = np.random.default_rng(ngenomes)
    nbytes = (ngenomes + 7) // 8
    bits = rng.random((100_003, ngenomes)) < 0.6
    rows = np.packbits(bits, axis=1, bitorder="little")
    assert rows.shape[1] == nbytes
    before = kernels.launches["fused_popcount_colsums"]
    got = port_index.bitmap_occupancy(rows, ngenomes, cuda)
    assert kernels.launches["fused_popcount_colsums"] == before + 1
    assert np.array_equal(got, port_index.bitmap_occupancy(rows, ngenomes,
                                                           "cpu"))
    assert np.array_equal(got, bits.sum(axis=1))


def test_anchor_lookup_matches_the_bucket_route(cuda):
    """The sorted-dictionary lookup (searchsorted on the card) against the
    bucket table's gather route on a 2^20-key table, SENTINEL-padded."""
    rng = np.random.default_rng(20)
    L = (1 << 20) + K - 1
    codes = _chunk(rng, L)
    keys, masks = _dict_for(rng, codes, 30)
    assert len(keys) > 1 << 19
    bd = BucketedDict.build(keys, masks, 30, K).to(cuda)
    pad = np.full(1000, np.uint64(0xFFFFFFFFFFFFFFFF))
    keys_t = torch.from_numpy(np.concatenate([keys, pad]).view(np.int64))
    masks_t = torch.from_numpy(np.concatenate(
        [masks, np.ones((1000, masks.shape[1]), np.uint32)]).view(np.int32))
    canon, _ = pack_kmers(torch.from_numpy(codes).to(cuda), K)
    got = anchor_ops.anchor_lookup(canon, keys_t.to(cuda), masks_t.to(cuda))
    hi, lo = split64(mix64(canon))
    want = bucket_query_pairs(hi, lo, bd.table, bd.nbits, bd.cap, bd.nwords)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy().view(np.uint32),
                          anchor_np(codes, K, keys, masks))


@pytest.mark.parametrize("W,N", [(1, 31), (2, 37), (4, 101)])
def test_popcount_ops_and_masks_to_bytes_launch_the_kernels(cuda, monkeypatch,
                                                            W, N):
    """ops.mask_popcount, ops.genome_column_sums and ops.masks_to_bytes of
    whole rows: one launch each on the card, equal to the plain versions;
    genome_column_sums in pieces above COLSUM_ROWS rows."""
    rng = np.random.default_rng(W)
    rows = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (300_001, W),
                                         dtype=np.int64).astype(np.int32))
    rows[:, -1] &= (1 << (N - 32 * (W - 1))) - 1
    dev_rows = rows.to(cuda)
    calls = (("fused_popcount_colsums", anchor_ops.mask_popcount, ()),
             ("fused_popcount_colsums", anchor_ops.genome_column_sums, (N,)),
             ("masks_to_bytes", kernels.masks_to_bytes, ()))
    for name, fn, args in calls:
        before = kernels.launches[name]
        got = fn(dev_rows, *args)
        torch.cuda.synchronize()
        assert kernels.launches[name] == before + 1, fn
        assert torch.equal(got.cpu(), fn(rows, *args)), fn
    assert kernels.masks_to_bytes(dev_rows).shape == (300_001, 4 * W)
    monkeypatch.setattr(anchor_ops, "COLSUM_ROWS", 100_000)
    before = kernels.launches["fused_popcount_colsums"]
    got = anchor_ops.genome_column_sums(dev_rows, N)
    assert kernels.launches["fused_popcount_colsums"] == before + 4
    assert torch.equal(got.cpu(), anchor_ops.genome_column_sums(rows, N))


def test_cpu_anchorer_matches_a_card_build(cuda, tmp_path):
    """The host anchorer, fed the build's canonical pandict.npz, writes the
    bitmap rows and popcounts the card wrote, at 1, 4 and all threads."""
    from panagram_tpu_torch.io.bgzf import decompress_file
    from panagram_tpu_torch.io.fasta import iter_fasta
    from panagram_tpu_torch.native.anchor_cpu import CpuAnchorer

    samples = _write_genomes(tmp_path, np.random.default_rng(4), bp=300_000)
    build_index(str(samples), prefix=str(tmp_path / "idx"), k=K, device=cuda,
                anchor_genomes=["g0"])
    pan = dictionary.PanKmerDict.load(str(tmp_path / "idx" / "kmc"
                                          / "pandict.npz"))
    assert pan.key_space == "canon"
    nbytes = (pan.ngenomes + 7) // 8
    want = np.frombuffer(decompress_file(str(
        tmp_path / "idx" / "anchor" / "g0" / "bitmap.1.gz")),
        np.uint8).reshape(-1, nbytes)
    ca = CpuAnchorer(pan.keys, pan.masks)
    codes = [seq_to_codes(s) for _, s in iter_fasta(str(tmp_path / "g0.fa"))]
    for threads in (1, 4, None):
        got = [ca.anchor(c, K, nbytes, threads=threads) for c in codes]
        by = np.concatenate([g[0] for g in got])
        assert np.array_equal(by, want), threads
        bits = np.unpackbits(want, axis=1, bitorder="little")
        assert np.array_equal(np.concatenate([g[1] for g in got]),
                              bits.sum(axis=1))


@pytest.mark.parametrize("ngenomes,mbp,chunk", [(4, 1.0, 1 << 20),
                                                (100, 0.02, 1 << 14)])
def test_bigdict_run_on_card_matches_cpu(cuda, monkeypatch, ngenomes, mbp,
                                         chunk):
    """tools/bigdict_run.run at a few Mbp on the card against the same run
    on the CPU (the kernels' plain versions), same genomes and seed: D, the
    table and every chunk's bytes, popcounts and column sums equal; the
    card run measures its peaks and its copy-back."""
    from panagram_tpu_torch.tools import bigdict_run

    monkeypatch.setattr(bigdict_run, "CHUNK", chunk)
    args = (ngenomes, mbp, 2.3 * mbp, 21)
    gpu = bigdict_run.run(*args, device="cuda")
    cpu = bigdict_run.run(*args, device="cpu")
    assert gpu.D == cpu.D > 0.99 * ngenomes * mbp * 1e6
    assert (gpu.nbits, gpu.cap, gpu.stride) == (cpu.nbits, cpu.cap, cpu.stride)
    assert torch.equal(gpu.bd.table.cpu(), cpu.bd.table)
    assert np.array_equal(gpu.bytes, cpu.bytes)
    assert np.array_equal(gpu.popc, cpu.popc)
    assert len(gpu.colsums) == len(cpu.colsums) == 3
    for (s, m, a), (t, n, b) in zip(gpu.colsums, cpu.colsums):
        assert (s, m) == (t, n) and np.array_equal(a, b)
    assert gpu.peaks["layout"] > gpu.peaks["layout_base"] + gpu.table_bytes
    assert gpu.peaks["builder"] > gpu.capacity * (8 + 4 * gpu.nwords)
    assert all(p["copy"] > 0 and p["pack"] > 0 for p in gpu.passes)
    assert gpu.route == gpu.bd.route == "single"


def test_free_bytes_is_what_the_card_can_release(cuda):
    """lookup._free_bytes counts the caching allocator's unused segments
    but not the free part of a segment that holds a tensor: with a 2-GiB
    segment split by a 256-MiB tensor (larger than any free block before,
    so it is carved from that segment) and an unused 4-GiB segment, it
    equals the card's free memory after torch.cuda.empty_cache() (within
    32 MiB), where counting every reserved byte not allocated would be
    1.75 GiB over."""
    split = "inactive_split_bytes.all.current"
    torch.cuda.empty_cache()
    split0 = torch.cuda.memory_stats(cuda)[split]
    assert split0 < (256 << 20)
    big = torch.empty(2 << 30, dtype=torch.uint8, device=cuda)
    del big
    small = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    spare = torch.empty(4 << 30, dtype=torch.uint8, device=cuda)
    del spare
    st = torch.cuda.memory_stats(cuda)
    assert st[split] - split0 > (3 << 29)
    free = lookup._free_bytes(cuda, None)
    assert free > torch.cuda.mem_get_info(cuda)[0] + (3 << 30)
    torch.cuda.empty_cache()
    released = torch.cuda.mem_get_info(cuda)[0]
    assert abs(released - free) < (1 << 25), (released, free)
    assert free + st[split] - released > (3 << 29)
    del small
