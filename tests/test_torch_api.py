"""The public Python API of panagram_tpu_torch against panagram_tpu's, on
the CPU: the package exports, and the ops panagram_tpu.ops exports that the
build itself does not call (distinct_kmers, anchor_lookup, mask_popcount,
genome_column_sums, occupancy_histogram, masks_to_bytes of whole rows).

Inputs come from numpy with a fixed seed; the port runs on CPU tensors (its
kernels' plain versions).  Every result is an integer array, so every
comparison is exact (tolerance 0).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import panagram_tpu
import panagram_tpu.io
import panagram_tpu.ops
import panagram_tpu.parallel
import panagram_tpu_torch
import panagram_tpu_torch.io
import panagram_tpu_torch.ops
import panagram_tpu_torch.parallel
from panagram_tpu.ops import anchor as jax_anchor
from panagram_tpu.ops.count import distinct_kmers as jax_distinct_kmers
from panagram_tpu.ops.ref_impl import anchor_np, build_dict_np, genome_kmer_set
from panagram_tpu_torch.io.fasta import seq_to_codes
from panagram_tpu_torch.ops import anchor, count, kernels
from panagram_tpu_torch.ops.codec import from_u64_np, pack_kmers, u64_np
from tests.conftest import random_seq

torch.set_num_threads(2)

K = 15
SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# panagram_tpu.parallel's jax.sharding names and what the port has instead
PARALLEL_STAND_INS = {"make_mesh": "Mesh", "DICT_AXIS": "launch"}
EXPORTS = [(jax_pkg, port_pkg, name)
           for jax_pkg, port_pkg in (
               (panagram_tpu, panagram_tpu_torch),
               (panagram_tpu.ops, panagram_tpu_torch.ops),
               (panagram_tpu.io, panagram_tpu_torch.io),
               (panagram_tpu.parallel, panagram_tpu_torch.parallel))
           for name in jax_pkg.__all__]


@pytest.mark.parametrize("jax_pkg,port_pkg,name", EXPORTS,
                         ids=[f"{j.__name__}.{n}" for j, _, n in EXPORTS])
def test_port_exports_every_name_of_panagram_tpu(jax_pkg, port_pkg, name):
    """Each name of panagram_tpu's four __all__s is in the port's
    counterpart's __all__ and resolves (make_mesh / DICT_AXIS as Mesh /
    launch); a function or class keeps its name."""
    name = PARALLEL_STAND_INS.get(name, name)
    assert name in port_pkg.__all__
    obj = getattr(port_pkg, name)
    if inspect.isfunction(obj) or inspect.isclass(obj):
        assert obj.__name__ == name


def test_port_package_all_lists_are_panagram_tpus():
    """Same names in the same order, but the two mapped parallel names."""
    assert panagram_tpu_torch.__all__ == panagram_tpu.__all__
    assert panagram_tpu_torch.ops.__all__ == panagram_tpu.ops.__all__
    assert panagram_tpu_torch.io.__all__ == panagram_tpu.io.__all__
    assert panagram_tpu_torch.parallel.__all__ == [
        PARALLEL_STAND_INS.get(n, n) for n in panagram_tpu.parallel.__all__]
    assert panagram_tpu_torch.Index is panagram_tpu_torch.index.Index
    assert panagram_tpu_torch.__version__ == panagram_tpu.__version__


def _rows(rng, P, N):
    """Random mask rows over N genomes: numpy uint32 [P, W]."""
    W = (N + 31) // 32
    rows = rng.integers(0, 1 << 32, (P, W), dtype=np.uint64)
    rows[:, -1] &= np.uint64((1 << (N - 32 * (W - 1))) - 1)
    rows[rng.random(P) < 0.1] = 0
    return rows.astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 / uint64 numpy -> the int32 / int64 tensor of the same bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view({4: np.int32, 8: np.int64}[a.itemsize]))


NS = [5, 37]   # odd genome counts: W = 1 and W = 2


@pytest.mark.parametrize("N", NS)
def test_mask_popcount_matches_jax(rng, N):
    rows = _rows(rng, 3001, N)
    want = np.asarray(jax_anchor.mask_popcount(jnp.asarray(rows)))
    got = anchor.mask_popcount(_t(rows))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("N", NS)
def test_genome_column_sums_matches_jax(rng, N):
    rows = _rows(rng, 3001, N)
    want = np.asarray(jax_anchor.genome_column_sums(jnp.asarray(rows), N))
    got = anchor.genome_column_sums(_t(rows), N)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert anchor.genome_column_sums(_t(rows[:0]), N).tolist() == [0] * N


def test_genome_column_sums_splits_large_inputs(rng, monkeypatch):
    """Above COLSUM_ROWS rows the launches take pieces and the int64 sums
    add up; cut here to 100 rows a piece."""
    rows = _rows(rng, 1050, 37)
    want = np.asarray(jax_anchor.genome_column_sums(jnp.asarray(rows), 37))
    calls = []
    real = kernels.fused_popcount_colsums

    def counted(r, n):
        calls.append(r.shape[0])
        return real(r, n)

    monkeypatch.setattr(anchor, "COLSUM_ROWS", 100)
    monkeypatch.setattr(kernels, "fused_popcount_colsums", counted)
    assert np.array_equal(anchor.genome_column_sums(_t(rows), 37).numpy(),
                          want)
    assert calls == [100] * 10 + [50]


@pytest.mark.parametrize("N", NS)
def test_masks_to_bytes_of_whole_rows_matches_jax(rng, N):
    rows = _rows(rng, 3001, N)
    want = np.asarray(jax_anchor.masks_to_bytes(jnp.asarray(rows)))
    got = panagram_tpu_torch.ops.masks_to_bytes(_t(rows))
    assert got.dtype == torch.uint8 and want.shape == (3001, 4 * rows.shape[1])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("binlen", [1, 100, 1000])
def test_occupancy_histogram_matches_jax(rng, N, binlen):
    P, nbins = 2500, -(-2500 // binlen) + 1
    popc = rng.integers(0, N + 1, P).astype(np.int32)
    popc[rng.random(P) < 0.2] = -1              # pads
    popc[-37:] = -1
    want = np.asarray(jax_anchor.occupancy_histogram(
        jnp.asarray(popc), binlen, nbins, N))
    got = anchor.occupancy_histogram(torch.from_numpy(popc), binlen, nbins, N)
    assert got.dtype == torch.int32 and got.shape == (nbins, N + 1)
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == int((popc >= 0).sum())


def test_occupancy_histogram_refuses_what_jax_drops():
    """A popcount above ngenomes, or more positions than nbins * binlen:
    panagram_tpu misbins or drops them silently, the port raises."""
    popc = torch.tensor([0, 1, 2, 3, -1], dtype=torch.int32)
    with pytest.raises(ValueError, match="popcount of 3 with 2 genomes"):
        anchor.occupancy_histogram(popc, 10, 1, 2)
    with pytest.raises(ValueError, match="5 positions do not fit 2 bins of 2"):
        anchor.occupancy_histogram(popc, 2, 2, 3)
    assert anchor.occupancy_histogram(popc, 2, 3, 3).tolist() == [
        [1, 1, 0, 0], [0, 0, 1, 1], [0, 0, 0, 0]]


def _lookup_case(rng, N, case):
    """(canon uint64 [P], keys uint64 [D] sorted, SENTINEL-padded, masks
    uint32 [D, W]) over random sequences of N genomes."""
    seqs = [random_seq(rng, 1500, n_frac=0.01) for _ in range(N)]
    keys, masks = build_dict_np([genome_kmer_set([s], K) for s in seqs])
    query = seqs[0] + random_seq(rng, 400, n_frac=0.05)
    canon, _ = pack_kmers(torch.from_numpy(seq_to_codes(query)), K)
    canon = u64_np(canon)                       # SENTINEL at N windows
    if case == "all_hit":
        canon = rng.choice(keys, 2000)
    elif case == "all_miss":
        canon = canon[~np.isin(canon, keys)]
    pad = 7
    keys = np.concatenate([keys, np.full(pad, SENTINEL_U64)])
    masks = np.concatenate([masks, _rows(rng, pad, N)])
    return canon, keys, masks


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("case", ["mixed", "all_hit", "all_miss"])
def test_anchor_lookup_matches_jax(rng, N, case):
    """SENTINEL-padded keys (whose pad rows hold masks, so a SENTINEL query
    that matched them would show) and SENTINEL queries at the N windows."""
    canon, keys, masks = _lookup_case(rng, N, case)
    if case == "mixed":
        assert (canon == SENTINEL_U64).sum() > 10
    want = np.asarray(jax_anchor.anchor_lookup(
        jnp.asarray(canon), jnp.asarray(keys), jnp.asarray(masks)))
    got = anchor.anchor_lookup(_t(canon), _t(keys), _t(masks))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    hits = (want != 0).any(axis=1).mean()
    assert {"all_hit": hits == 1, "all_miss": hits == 0,
            "mixed": 0.3 < hits < 1}[case]


def test_anchor_lookup_is_the_oracle(rng):
    """The rows of a whole sequence equal ref_impl.anchor_np's."""
    seqs = [random_seq(rng, 2000, n_frac=0.01) for _ in range(3)]
    keys, masks = build_dict_np([genome_kmer_set([s], K) for s in seqs])
    codes = seq_to_codes(seqs[1])
    canon, _ = pack_kmers(torch.from_numpy(codes), K)
    got = anchor.anchor_lookup(canon, from_u64_np(keys, "cpu"), _t(masks))
    assert np.array_equal(got.numpy().view(np.uint32),
                          anchor_np(codes, K, keys, masks))
    empty = anchor.anchor_lookup(canon, torch.zeros(0, dtype=torch.int64),
                                 torch.zeros(0, 1, dtype=torch.int32))
    assert empty.shape == (len(canon), 1) and not empty.any()


@pytest.mark.parametrize("k", [5, 15, 31])
@pytest.mark.parametrize("length", [0, 4, 14, 3000])
def test_distinct_kmers_matches_jax(rng, k, length):
    codes = seq_to_codes(random_seq(rng, length, n_frac=0.02))
    want = jax_distinct_kmers(codes, k)
    got = count.distinct_kmers(codes, k, device="cpu")
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert (len(got) > 0) == (length >= k)


def test_distinct_kmers_refuses_bad_k():
    with pytest.raises(ValueError, match="k must be in"):
        count.distinct_kmers(seq_to_codes("ACGT" * 10), 32, device="cpu")
