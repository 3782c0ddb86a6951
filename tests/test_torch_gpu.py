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

from panagram_tpu_torch.ops import kernels
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
