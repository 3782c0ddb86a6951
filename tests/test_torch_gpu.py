"""The CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one.  This module
imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(--noconftest because tests/conftest.py imports jax.)  Inputs come from
numpy with a fixed seed; everything is integer, so every comparison is
exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from panagram_tpu_torch.io.fasta import seq_to_codes
from panagram_tpu_torch.ops import count, devdict, kernels, lookup
from panagram_tpu_torch.ops.anchor import anchor_chunk
from panagram_tpu_torch.ops.codec import pack_bases_np, pack_kmers, u64_np
from panagram_tpu_torch.ops.lookup import (
    TILE_Q,
    BucketedDict,
    bucket_query,
    bucket_query_sorted_pre,
    plan_probe,
)
from panagram_tpu_torch.ops.ref_impl import anchor_np, masks_to_bytes_np
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


@pytest.mark.parametrize("ngenomes", [30, 40])
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


def test_anchor_chunk_matches_oracle(cuda):
    """The dense chunk through all four kernels equals the numpy oracle,
    with a tight window so the out-of-span fixup runs."""
    rng = np.random.default_rng(5)
    L = (1 << 16) + K - 1
    codes = _chunk(rng, L)
    keys, masks = _dict_for(rng, codes, 30)
    bd = BucketedDict.build(keys, masks, 30, K).to(cuda)
    packed, nmask, _ = pack_bases_np(codes)
    by, popc, cols = anchor_chunk(torch.from_numpy(packed).to(cuda),
                                  torch.from_numpy(nmask).to(cuda), L, K,
                                  bd.table, bd.nbits, bd.cap, bd.nwords, 4)
    torch.cuda.synchronize()
    rows = anchor_np(codes, K, keys, masks)
    P = L - K + 1
    assert np.array_equal(by.cpu().numpy()[:P], masks_to_bytes_np(rows, 4))
    bits = np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")
    assert np.array_equal(popc.cpu().numpy()[:P], bits.sum(axis=1))
    assert np.array_equal(cols.cpu().numpy(), bits.sum(axis=0))

    hi, lo = kernels.pack_mix(torch.from_numpy(packed).to(cuda),
                              torch.from_numpy(nmask).to(cuda), L, K, 1 << 16)
    want = bucket_query(hi, lo, bd.table, bd.nbits, bd.cap, bd.nwords)
    for span in (8, None):
        got = bucket_query_sorted_pre(hi, lo, bd.table, bd.nbits, bd.cap,
                                      bd.nwords, 1 << 16, span=span)
        assert torch.equal(got, want)


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
        got = count.distinct_kmers_chunked([codes], K, cuda, chunk=chunk)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, codes, got

    one, _, _ = peak(1)
    short, _, _ = peak(8)
    long_, codes, got = peak(32)
    assert long_ <= 1.25 * short
    assert long_ < 8 * one
    want = count.distinct_kmers_chunked([codes], K, "cpu", chunk=chunk)
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
    want = BucketedDict.build_device(keys, masks, ngenomes, K, "cpu")
    got = BucketedDict.build_device(keys, masks, ngenomes, K, cuda)
    assert torch.equal(got.table.cpu(), want.table)

    D, W = len(keys), maskp.shape[1]
    want = BucketedDict.build_device(mp, maskp, ngenomes, K, "cpu", mixed=True,
                                     count=D, sorted_input=True)
    nbits, _, stride = lookup.table_geometry(D, W)
    fixed = (1 << nbits) * stride * 4 + lookup.ANCHOR_RESERVE_BYTES
    for free, route in (
            (None, "single"),
            (fixed + lookup.layout_bytes(D, W, "chunked", 1 << 14), "chunked"),
            (fixed, "host")):
        free = free if free is not None else torch.cuda.mem_get_info()[0]
        assert lookup.layout_route(D, W, cuda, True, free, 1 << 14) == route
        got = BucketedDict.build_device(mp, maskp, ngenomes, K, cuda,
                                        mixed=True, count=D,
                                        sorted_input=True, free=free,
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
    builders = [devdict.DeviceDictBuilder(K, 40, dev, chunk=4096)
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
