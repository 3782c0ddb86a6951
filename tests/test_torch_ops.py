"""panagram_tpu_torch ops against panagram_tpu's, on the CPU.

Inputs come from numpy with a fixed seed; the port runs with
device="cpu" (plain torch versions of its kernels).  Everything is
integer or formatted text, so every comparison is exact (tolerance 0).
"""

import dataclasses
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from panagram_tpu.config import IndexConfig as JaxIndexConfig
from panagram_tpu.io.bgzf import BgzfWriter as JaxBgzfWriter
from panagram_tpu.ops import lookup as jl
from panagram_tpu.ops.codec import canonical_kmers as jax_canonical_kmers
from panagram_tpu.ops.count import distinct_kmers_chunked as jax_distinct
from panagram_tpu.ops.dictionary import PanKmerDict as JaxPanKmerDict
from panagram_tpu.ops.dictionary import build_dictionary as jax_build_dictionary
from panagram_tpu.ops.ref_impl import anchor_np, genome_kmer_set, masks_to_bytes_np
from panagram_tpu_torch.config import IndexConfig, dump_yaml, load_yaml
from panagram_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, build_gzi
from panagram_tpu_torch.io.fasta import seq_to_codes
from panagram_tpu_torch.ops import lookup
from panagram_tpu_torch.ops.anchor import _anchor_chunk_padded, anchor_chunk_fast
from panagram_tpu_torch.ops.codec import (
    canonical_kmers,
    from_u64_np,
    mix64,
    pack_bases_np,
    split64,
    u64_np,
)
from panagram_tpu_torch.ops.count import distinct_kmers_chunked
from panagram_tpu_torch.ops.dictionary import PanKmerDict, build_dictionary
from tests.conftest import random_seq

torch.set_num_threads(2)

K = 13


def _genomes(rng, n, length=900, n_frac=0.01):
    return [random_seq(rng, length, n_frac=n_frac) for _ in range(n)]


def test_mix64_matches_jax(rng):
    x = np.concatenate([rng.integers(0, 1 << 62, 2000, dtype=np.uint64),
                        rng.integers(0, 1 << 63, 2000, dtype=np.uint64) * 2 + 1,
                        np.array([0, 0xFFFFFFFFFFFFFFFF], np.uint64)])
    want = np.asarray(jl.mix64(jnp.asarray(x)))
    assert np.array_equal(want, jl.mix64_np(x))
    assert np.array_equal(u64_np(mix64(from_u64_np(x, "cpu"))), want)
    assert np.array_equal(lookup.mix64_np(x), want)


@pytest.mark.parametrize("k", [1, 5, 11, 16, 31])
def test_canonical_kmers_match_jax(rng, k):
    codes = seq_to_codes(random_seq(rng, 3000, n_frac=0.02))
    want_c, want_v = jax_canonical_kmers(codes, k)
    got_c, got_v = canonical_kmers(codes, k, device="cpu")
    assert got_c.dtype == np.uint64
    assert np.array_equal(got_v, want_v)
    assert np.array_equal(got_c, np.asarray(want_c))


def test_distinct_kmers_chunked_matches_jax(rng):
    seqs = [seq_to_codes(s) for s in _genomes(rng, 3, 5000, 0.005)]
    seqs.append(seq_to_codes("ACG"))          # shorter than k: no k-mers
    want = jax_distinct(iter(seqs), K, chunk=1024)
    got = distinct_kmers_chunked(iter(seqs), K, chunk=1024, device="cpu")
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert np.array_equal(distinct_kmers_chunked(iter(seqs), K, device="cpu"), want)


@pytest.mark.parametrize("ngenomes", [3, 40])
def test_build_dictionary_and_pairwise_match_jax(rng, ngenomes):
    sets = [genome_kmer_set([s], K) for s in _genomes(rng, ngenomes)]
    sets[1] = np.zeros(0, np.uint64)          # a genome without sequence
    want = jax_build_dictionary(sets, K, ngenomes=ngenomes)
    got = build_dictionary(sets, K, ngenomes=ngenomes, device="cpu")
    assert got.keys.dtype == np.uint64 and got.masks.dtype == np.uint32
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.masks, want.masks)
    assert np.array_equal(got.pairwise_shared(block=512, device="cpu"),
                          want.pairwise_shared())


def test_pandict_npz_reads_both_ways(rng, tmp_path):
    sets = [genome_kmer_set([s], K) for s in _genomes(rng, 5)]
    d = build_dictionary(sets, K, device="cpu")
    d.save(str(tmp_path / "port.npz"))
    j = JaxPanKmerDict.load(str(tmp_path / "port.npz"))
    assert np.array_equal(j.keys, d.keys) and np.array_equal(j.masks, d.masks)
    assert (j.ngenomes, j.k, j.key_space) == (5, K, "canon")

    jax_build_dictionary(sets, K).save(str(tmp_path / "jax.npz"))
    p = PanKmerDict.load(str(tmp_path / "jax.npz"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert a.files == b.files
    for f in a.files:
        assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f])
    assert (p.ngenomes, p.k, p.key_space) == (5, K, "canon")


@pytest.mark.parametrize("ngenomes", [3, 40])
def test_bucket_table_and_gather_probe_match_jax(rng, ngenomes):
    seqs = _genomes(rng, ngenomes)
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = jax_build_dictionary(sets, K)
    jbd = jl.BucketedDict.build(d.keys, d.masks, ngenomes, K)
    bd = lookup.BucketedDict.build(d.keys, d.masks, ngenomes, K)
    assert (bd.nbits, bd.cap, bd.stride, bd.nwords) == \
        (jbd.nbits, jbd.cap, jbd.stride, jbd.nwords)
    assert np.array_equal(bd.table, jbd.table)
    # the packed-row device form converts back to the same table
    (jt,) = jbd.device_arrays()
    assert jt.shape != bd.table.shape or ngenomes == 40
    conv = lookup.BucketedDict.from_jax_state(
        np.asarray(jt), jbd.nbits, jbd.cap, jbd.stride, ngenomes, K, jbd.nwords)
    assert np.array_equal(conv.table, bd.table)

    from panagram_tpu.ops.codec import pack_kmers

    codes = seq_to_codes(seqs[0] + random_seq(rng, 300, n_frac=0.1))
    canon, _ = pack_kmers(jnp.asarray(codes), K)
    want = np.asarray(jl.bucket_query(canon, jt, jbd.nbits, jbd.cap, jbd.nwords))
    tbd = conv.to("cpu")
    hi, lo = split64(mix64(from_u64_np(np.asarray(canon), "cpu")))
    got = lookup.bucket_query_pairs(hi, lo, tbd.table, tbd.nbits, tbd.cap,
                                    tbd.nwords)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(want, anchor_np(codes, K, d.keys, d.masks))


@pytest.fixture(scope="module")
def skew_table():
    """A 30-genome bucket table as panagram_tpu's device table and as the
    port's, with its keys."""
    rng = np.random.default_rng(8000)
    keys = np.unique(rng.integers(0, 1 << 62, 8000, dtype=np.uint64))
    masks = rng.integers(1, 1 << 31, (len(keys), 1)).astype(np.uint32)
    jbd = jl.BucketedDict.build(keys, masks, 30, 21)
    (jt,) = jbd.device_arrays()
    bd = lookup.BucketedDict.from_jax_state(
        np.asarray(jt), jbd.nbits, jbd.cap, jbd.stride, 30, 21, 1).to("cpu")
    return keys, jbd, jt, bd


def _skewed_batch(case, keys, nbits, rng):
    """Mixed u64 queries of one skewed batch, in no order."""
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    hits = lookup.mix64_np(keys)
    if case == "one_bucket":
        # every query in the bucket of one key: the same top nbits, that
        # bucket's own keys among them
        top = hits[0] >> np.uint64(64 - nbits) << np.uint64(64 - nbits)
        crowd = top | (rng.integers(0, 1 << 64, 3000, dtype=np.uint64)
                       >> np.uint64(nbits))
        same = hits[(hits >> np.uint64(64 - nbits))
                    == (hits[0] >> np.uint64(64 - nbits))]
        m = np.concatenate([crowd, np.repeat(same, 300)])
    elif case == "n_windows":
        # an assembly of gaps: all-ones pairs and the one mixed value every
        # N window gets (mix64 of the all-ones key), a few hits between
        m = np.concatenate([np.full(2000, ones),
                            lookup.mix64_np(np.full(2500, ones)),
                            hits[:40]])
    elif case == "all_misses":
        m = lookup.mix64_np(rng.integers(0, 1 << 62, 3500, dtype=np.uint64))
        m = m[~np.isin(m, hits)]
    else:
        raise KeyError(case)
    return rng.permutation(m)


@pytest.mark.parametrize("case", ["one_bucket", "n_windows", "all_misses"])
def test_bucket_query_sorted_pre_equals_gather_under_skew(skew_table, case):
    """The merge probe, one window over the whole table, gives panagram_tpu's
    gather probe row for row on a skewed batch (padded with all-ones pairs
    to whole tiles), through positional rows and through a shuffled pos."""
    keys, jbd, jt, bd = skew_table
    rng = np.random.default_rng(len(case))
    m = _skewed_batch(case, keys, bd.nbits, rng)
    want = np.asarray(jl.bucket_query(jnp.asarray(m), jt, jbd.nbits, jbd.cap,
                                      jbd.nwords, pre_mixed=True))
    assert want.any() == (case != "all_misses")
    Q0 = len(m)
    Qp = -(-Q0 // lookup.TILE_Q) * lookup.TILE_Q
    hi, lo = split64(from_u64_np(m, "cpu"))
    pad = torch.full((Qp - Q0,), -1, dtype=torch.int32)
    hi, lo = torch.cat([hi, pad]), torch.cat([lo, pad])
    got = lookup.bucket_query_sorted_pre(hi, lo, None, bd.table, bd.nbits,
                                         bd.cap, bd.nwords, Q0)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    perm = torch.from_numpy(rng.permutation(Qp))
    got = lookup.bucket_query_sorted_pre(hi[perm], lo[perm], perm, bd.table,
                                         bd.nbits, bd.cap, bd.nwords, Q0)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("ngenomes", [3, 40])
def test_anchor_chunk_matches_oracle(rng, ngenomes):
    seqs = _genomes(rng, ngenomes, 1500, 0.01)
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K, device="cpu")
    bd = lookup.BucketedDict.build(d.keys, d.masks, ngenomes, K).to("cpu")
    codes = seq_to_codes(seqs[0])
    packed, nmask, L = pack_bases_np(codes)
    nbytes = (ngenomes + 7) // 8
    p, n = torch.from_numpy(packed), torch.from_numpy(nmask)
    by, popc, cols = anchor_chunk_fast(p, n, bd.table, L, K, bd.nbits,
                                       bd.cap, bd.nwords, nbytes)
    rows = anchor_np(codes, K, d.keys, d.masks)
    P = L - K + 1
    assert by.shape == (P, nbytes) and popc.shape == (P,)
    assert cols.dtype == torch.int64 and cols.shape == (32 * bd.nwords,)
    padded = _anchor_chunk_padded(p, n, L, K, bd.table, bd.nbits, bd.cap,
                                  bd.nwords, nbytes)[0]
    assert padded.shape[0] % lookup.TILE_Q == 0 and not padded[P:].any()
    assert np.array_equal(by.numpy(), masks_to_bytes_np(rows, nbytes))
    bits = np.unpackbits(rows.astype("<u4").view(np.uint8), axis=1,
                         bitorder="little")
    assert np.array_equal(popc.numpy()[:P], bits.sum(axis=1))
    assert np.array_equal(cols.numpy(), bits.sum(axis=0))


NAMES = ["g1", "1", "yes", "g-2", "0x1F", "1e5", "null", "on", "1_000",
         "007", "-", "-g", "No", "2020-01-01", "a_b-c"]


def test_hbm_budget_guard(monkeypatch):
    """A table that does not fit the card's free memory raises before any
    upload; the CPU is not checked."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (6 << 30, 80 << 30))
    lookup.check_device_budget(2 << 30, "cuda")
    with pytest.raises(RuntimeError, match="free on cuda"):
        lookup.check_device_budget(4 << 30, "cuda")
    lookup.check_device_budget(1 << 50, "cpu")


def test_config_yaml_matches_pyyaml():
    cfg = IndexConfig()
    cfg.k, cfg.input, cfg.anchor_genomes = 11, "samples.tsv", NAMES
    want = yaml.dump(JaxIndexConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}).to_dict())
    assert dump_yaml(cfg.to_dict()) == want
    assert load_yaml(want) == yaml.safe_load(want)

    cfg.anchor_genomes, cfg.gff_anno_types = [], ["exon", "CDS"]
    cfg.genome_umap.dist, cfg.chrom_umap.eps = 0.1, 1e20
    want = yaml.dump(cfg.to_dict())
    assert dump_yaml(cfg.to_dict()) == want
    assert load_yaml(want) == yaml.safe_load(want)


def test_config_roundtrip(tmp_path):
    cfg = IndexConfig()
    cfg.k, cfg.anchor_genomes, cfg.kmc.use_existing = 17, ["a", "1"], True
    cfg.save(str(tmp_path / "c.yaml"))
    back = IndexConfig.load(str(tmp_path / "c.yaml"))
    assert back.to_dict() == cfg.to_dict()


def test_bgzf_writer_matches_jax_and_reader_parses_xlen(rng, tmp_path):
    data = rng.integers(0, 4, 600_000).astype(np.uint8).tobytes()
    with BgzfWriter(str(tmp_path / "p.gz")) as w:
        w.write(data[:1000])
        w.write(np.frombuffer(data[1000:], np.uint8))
    w.write_gzi(str(tmp_path / "p.gzi"))
    with JaxBgzfWriter(str(tmp_path / "j.gz")) as jw:
        jw.write(data[:1000])
        jw.write(np.frombuffer(data[1000:], np.uint8))
    jw.write_gzi(str(tmp_path / "j.gzi"))
    for ext in ("gz", "gzi"):
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    with BgzfReader(str(tmp_path / "p.gz"), str(tmp_path / "p.gzi")) as r:
        assert r.read_all() == data
        assert r.read_at(123_457, 70_000) == data[123_457:193_457]

    # a member whose extra field holds another subfield before BC (XLEN 10)
    payload = b"ACGT" * 1000
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    extra = b"XY" + struct.pack("<H", 0) + b"BC" + struct.pack("<HH", 2,
                                                               len(comp) + 29)
    block = (bytes([0x1F, 0x8B, 8, 4, 0, 0, 0, 0, 0, 0xFF])
             + struct.pack("<H", len(extra)) + extra + comp
             + struct.pack("<II", zlib.crc32(payload), len(payload)))
    eof = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
    (tmp_path / "x.gz").write_bytes(block + block + eof)
    build_gzi(str(tmp_path / "x.gz"))
    with BgzfReader(str(tmp_path / "x.gz"), str(tmp_path / "x.gz.gzi")) as r:
        assert r.read_all() == payload * 2
        assert r.read_at(3990, 20) == (payload * 2)[3990:4010]
