"""The plain torch versions of the four kernels against the Pallas kernels.

Each Pallas kernel runs in interpret mode on the CPU, as tests/test_pallas.py
runs it; the port's wrappers, given CPU tensors, run their plain versions.
Inputs come from numpy with a fixed seed, and everything is integer, so
every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panagram_tpu.ops import pallas_kernels as pk
from panagram_tpu.ops.dictionary import build_dictionary as jax_build_dictionary
from panagram_tpu.ops.lookup import BucketedDict as JaxBucketedDict
from panagram_tpu.ops.lookup import row_pack
from panagram_tpu.ops.ref_impl import genome_kmer_set
from panagram_tpu_torch.ops import kernels
from panagram_tpu_torch.ops.codec import pack_bases_np
from panagram_tpu_torch.ops.lookup import BucketedDict, mix64_np

torch.set_num_threads(2)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("k", [5, 16, 21, 31])
@pytest.mark.parametrize("L", [3 * 16384, 4 * 16384 + 7])
def test_pack_mix_matches_pallas(k, L):
    rng = np.random.default_rng(1000 * k + L)
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.choice(L, L // 50, replace=False)] = 255
    packed, nmask, L2 = pack_bases_np(codes)
    P = L - k + 1
    Ppad = -(-P // (16 * 1024)) * (16 * 1024)

    mhi, mlo = pk.pack_mix_pallas(jnp.asarray(packed), jnp.asarray(nmask),
                                  L2, k, Ppad)
    pos = np.asarray(pk.pack_mix_positions(Ppad))
    want_hi = np.empty(Ppad, np.uint32)
    want_lo = np.empty(Ppad, np.uint32)
    want_hi[pos] = _u32(mhi).reshape(-1)
    want_lo[pos] = _u32(mlo).reshape(-1)

    hi, lo = kernels.pack_mix(torch.from_numpy(packed), torch.from_numpy(nmask),
                              L2, k, Ppad)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi)
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo)
    assert (want_hi[P:] == 0xFFFFFFFF).all()


def _probe_inputs(rng, ngenomes, ntiles, tile_q=1024):
    """Queries (mixed keys of the genomes' k-mers plus misses and all-ones
    padding) sorted by hi, and the JAX table from a `ngenomes` dictionary."""
    K = 13
    seqs = ["".join(rng.choice(list("ACGT"), 600)) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = jax_build_dictionary(sets, K)
    jbd = JaxBucketedDict.build(d.keys, d.masks, ngenomes, K)
    Q = ntiles * tile_q
    hits = rng.choice(d.keys, Q // 2)
    misses = rng.integers(0, 1 << 62, Q // 2 - 100, dtype=np.uint64)
    m = np.concatenate([mix64_np(hits), mix64_np(misses),
                        np.full(100, np.uint64(0xFFFFFFFFFFFFFFFF))])
    m = m[np.argsort((m >> np.uint64(32)).astype(np.uint32), kind="stable")]
    qhi = (m >> np.uint64(32)).astype(np.uint32)
    qlo = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return jbd, qhi, qlo


def _jax_blo_span(qhi, nbits, stride, tile_q):
    """blo (packed rows) and span as panagram_tpu's merge probe computes them
    (lookup.py bucket_query_sorted_pre)."""
    B = 1 << nbits
    pack = row_pack(stride, B)
    Bp = B // pack
    Qp = len(qhi)
    expect = max(tile_q * Bp // Qp, 1)
    span = min(Bp, max((1 << 19) // (stride * pack), 64),
               max((-(-3 * expect // 2) + 7) & ~7, 64))
    brow = (qhi >> np.uint32(32 - nbits)).astype(np.int64) >> (pack.bit_length() - 1)
    blo = np.clip(brow[::tile_q], 0, Bp - span).astype(np.int32)
    return blo, span, pack


@pytest.mark.parametrize("ngenomes,ntiles", [(3, 2), (40, 4)])
def test_probe_sorted_matches_pallas(ngenomes, ntiles):
    rng = np.random.default_rng(7 + ngenomes)
    tile_q = 1024
    jbd, qhi, qlo = _probe_inputs(rng, ngenomes, ntiles, tile_q)
    (jt,) = jbd.device_arrays()
    blo, span, pack = _jax_blo_span(qhi, jbd.nbits, jbd.stride, tile_q)
    want = _u32(pk.probe_sorted(jnp.asarray(qhi), jnp.asarray(qlo),
                                jnp.asarray(blo), jt, jbd.nbits, jbd.cap,
                                jbd.nwords, span=span, pack=pack,
                                tile_q=tile_q)).T          # [Q, W]
    assert want.any()

    bd = BucketedDict.from_jax_state(np.asarray(jt), jbd.nbits, jbd.cap,
                                     jbd.stride, ngenomes, 13, jbd.nwords)
    got = kernels.probe_sorted(_i32(qhi), _i32(qlo),
                               torch.from_numpy(blo * pack),
                               _i32(bd.table), bd.nbits, bd.cap, bd.nwords,
                               span * pack, tile_q)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_fused_popcount_colsums_matches_pallas():
    rng = np.random.default_rng(11)
    P, W, N = 4096, 2, 40
    rows = rng.integers(0, 1 << 31, (P, W)).astype(np.uint32)
    rows[:, 1] &= np.uint32((1 << (N - 32)) - 1)   # only bits < N are set
    want_p, want_c = pk.fused_popcount_colsums(jnp.asarray(rows), N)
    popc, colsums = kernels.fused_popcount_colsums(_i32(rows), N)
    assert popc.dtype == torch.int32 and colsums.dtype == torch.int32
    assert np.array_equal(popc.numpy(), np.asarray(want_p))
    assert np.array_equal(colsums.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("nbytes", [1, 4, 5])
def test_masks_to_bytes_matches_pallas(nbytes):
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 1 << 32, (pk.TILE, 2), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pk.masks_to_bytes_pallas(jnp.asarray(rows), nbytes))
    got = kernels.masks_to_bytes(_i32(rows), nbytes)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_cpu_tensors_take_plain_versions_without_counting():
    kernels.reset_launches()
    rows = torch.zeros(64, 1, dtype=torch.int32)
    kernels.masks_to_bytes(rows, 2)
    kernels.fused_popcount_colsums(rows, 30)
    assert all(v == 0 for v in kernels.launches.values())


def test_wrappers_refuse_bad_inputs():
    rows = torch.zeros(8, 1, dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.masks_to_bytes(rows, 2)                       # dtype
    with pytest.raises(ValueError):
        kernels.masks_to_bytes(torch.zeros(8, 1, dtype=torch.int32), 5)  # > 4W
    with pytest.raises(ValueError):
        kernels.fused_popcount_colsums(
            torch.zeros(8, 1, dtype=torch.int32, device="meta"), 4)
