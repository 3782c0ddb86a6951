"""Calls written for panagram_tpu, made on the port, on the CPU.

The names the port carries under panagram_tpu's contract (codec, lookup,
anchor, dictionary, io, intros) and the signatures whose parameters follow
panagram_tpu's order, each called positionally as panagram_tpu's callers
call it (the port's `device` by keyword: "cpu" here).  Inputs come from
numpy with fixed seeds, and both packages get the same ones; u64 keys go to
the port as int64 tensors of the same bits, u32 words as int32.  Every
result is integers, bytes or files, so every comparison is exact
(tolerance 0).
"""

import gzip
import io
import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panagram_tpu import index as jax_index
from panagram_tpu import pipeline as jax_pipeline
from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.io.bgzf import BgzfWriter as JaxBgzfWriter
from panagram_tpu.ops import anchor as jax_anchor
from panagram_tpu.ops import codec as jax_codec
from panagram_tpu.ops import count as jax_count
from panagram_tpu.ops import devdict as jax_devdict
from panagram_tpu.ops import dictionary as jax_dictionary
from panagram_tpu.ops import lookup as jl
from panagram_tpu.ops.ref_impl import anchor_np, build_dict_np, genome_kmer_set
from panagram_tpu.parallel import shard as jax_shard
from panagram_tpu_torch import index as port_index
from panagram_tpu_torch import pipeline
from panagram_tpu_torch.io.bgzf import BgzfWriter
from panagram_tpu_torch.io.fasta import seq_to_codes
from panagram_tpu_torch.ops import anchor, codec, count, devdict, dictionary
from panagram_tpu_torch.ops import lookup
from panagram_tpu_torch.ops.codec import pack_bases_np, u64_np
from panagram_tpu_torch.parallel import distributed, shard
from tests.conftest import random_seq
from tests.test_torch_index import (
    K,
    assert_same_trees,
    jax_build_device_dict,
    write_fixture,
)

torch.set_num_threads(2)

SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy uint64 / uint32 -> int64 / int32 tensor of the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        return torch.from_numpy(a.view(np.int64).copy())
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _codes(rng, L, n_frac=0.03):
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.random(L) < n_frac] = 4
    return codes


@pytest.fixture(scope="module")
def table():
    """A 40-genome (W=2) dictionary of a genome's k-mers and random keys:
    its panagram_tpu table (host build and packed-row device form), the
    port's host table, and the genome's codes."""
    rng = np.random.default_rng(3)
    codes = _codes(rng, 6000)
    canon, valid = jax_codec.canonical_kmers(codes, 21)
    keys = np.unique(np.concatenate([
        canon[valid], rng.integers(0, 1 << 62, 3000, dtype=np.uint64)]))
    masks = rng.integers(1, 1 << 32, (len(keys), 2), dtype=np.uint64)
    masks[:, 1] &= np.uint64(0xFF)
    masks = masks.astype(np.uint32)
    jbd = jl.BucketedDict.build(keys, masks, 40, 21)
    (jt,) = jbd.device_arrays()
    bd = lookup.BucketedDict.build(keys, masks, 40, 21)
    return dict(keys=keys, masks=masks, jbd=jbd, jt=jt, bd=bd, codes=codes,
                rng=rng)


def _queries(tb, n=2500):
    """Keys, random misses, SENTINEL windows: numpy uint64 [n]."""
    rng = np.random.default_rng(n)
    q = np.concatenate([rng.choice(tb["keys"], n // 2),
                        rng.integers(0, 1 << 62, n - n // 2 - 20,
                                     dtype=np.uint64),
                        np.full(20, SENTINEL_U64)])
    return q[rng.permutation(n)]


# ---------------------------------------------------------------- codec


@pytest.mark.parametrize("L,k", [(5, 5), (37, 5), (1000, 21), (4099, 31)])
def test_unpack_bases_and_pack_kmers_packed(L, k):
    rng = np.random.default_rng(L)
    codes = _codes(rng, L, 0.05)
    packed, nmask, _ = pack_bases_np(codes)
    want = np.asarray(jax_codec.unpack_bases(jnp.asarray(packed),
                                             jnp.asarray(nmask), L))
    got = codec.unpack_bases(_t(packed), _t(nmask), L)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    jc, jv = jax_codec.pack_kmers_packed(jnp.asarray(packed),
                                         jnp.asarray(nmask), L, k)
    pc, pv = codec.pack_kmers_packed(_t(packed), _t(nmask), L, k)
    assert np.array_equal(pv.numpy(), np.asarray(jv))
    assert np.array_equal(u64_np(pc), np.asarray(jc))


# --------------------------------------------------------------- lookup


@pytest.mark.parametrize("form", ["host", "packed_row", "tensor"])
@pytest.mark.parametrize("pre_mixed", [False, True])
def test_bucket_query(table, form, pre_mixed):
    """panagram_tpu's gather probe on canonical or pre-mixed keys (the
    all-ones mixed value among them), any table form."""
    jbd, bd = table["jbd"], table["bd"]
    q = _queries(table)
    if pre_mixed:
        q = lookup.mix64_np(q)
        q[:5] = SENTINEL_U64
    want = np.asarray(jl.bucket_query(jnp.asarray(q), table["jt"], jbd.nbits,
                                      jbd.cap, jbd.nwords, pre_mixed))
    t = {"host": bd.table, "packed_row": np.asarray(table["jt"]),
         "tensor": bd.to("cpu").table}[form]
    got = lookup.bucket_query(_t(q), t, bd.nbits, bd.cap, bd.nwords,
                              pre_mixed)
    assert got.shape == want.shape and np.array_equal(_u32(got), want)
    assert want.any() and not want.all()


def test_bucket_query_sorted_equals_panagram_tpus_merge_probe(table):
    """The merge probe (panagram_tpu's Pallas kernel in interpret mode)
    over a query count that needs all-ones padding, SENTINELs included;
    its rows equal the gather probe's."""
    jbd, bd = table["jbd"], table["bd"]
    q = _queries(table, 3000)
    want = np.asarray(jl.bucket_query_sorted(
        jnp.asarray(q), table["jt"], jbd.nbits, jbd.cap, jbd.nwords))
    got = lookup.bucket_query_sorted(_t(q), bd.to("cpu").table, bd.nbits,
                                     bd.cap, bd.nwords)
    assert got.shape == (3000, 2) and np.array_equal(_u32(got), want)
    gather = lookup.bucket_query(_t(q), bd.table, bd.nbits, bd.cap, bd.nwords)
    assert torch.equal(got, gather)


def test_bucket_query_sorted_pre_with_permuted_pos(table):
    """Pre-split mixed pairs in a shuffled order, with pos naming each
    element's output row and all-ones pads at rows >= out_len."""
    jbd, bd = table["jbd"], table["bd"]
    q = _queries(table, 1800)
    m = lookup.mix64_np(q)
    Qp, out_len = 2048, len(q)
    hi = np.full(Qp, 0xFFFFFFFF, np.uint32)
    lo = hi.copy()
    hi[:out_len] = (m >> np.uint64(32)).astype(np.uint32)
    lo[:out_len] = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pos = np.arange(Qp, dtype=np.int32)
    shuffle = np.random.default_rng(9).permutation(Qp)
    hi, lo, pos = hi[shuffle], lo[shuffle], pos[shuffle]
    want = np.asarray(jl.bucket_query_sorted_pre(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pos), table["jt"],
        jbd.nbits, jbd.cap, jbd.nwords, out_len))
    t = bd.to("cpu").table
    got = lookup.bucket_query_sorted_pre(_t(hi), _t(lo), torch.from_numpy(pos),
                                         t, bd.nbits, bd.cap, bd.nwords,
                                         out_len)
    assert np.array_equal(_u32(got), want)


def test_pad_pow2_and_device_arrays(table):
    rng = np.random.default_rng(4)
    for D in (1, 2, 5, 64, 1000):
        keys = np.sort(rng.integers(0, 1 << 62, D, dtype=np.uint64))
        masks = rng.integers(0, 1 << 32, (D, 2), dtype=np.uint64).astype(
            np.uint32)
        for m in (masks, masks[:, 0]):
            jk, jm = jl.pad_pow2(keys, m)
            pk, pm = lookup.pad_pow2(keys, m)
            assert pk.dtype == jk.dtype and np.array_equal(pk, jk)
            assert pm.dtype == jm.dtype and np.array_equal(pm, jm)
    bd = lookup.BucketedDict.build(table["keys"], table["masks"], 40, 21)
    (t,) = bd.device_arrays(device="cpu")
    assert isinstance(t, torch.Tensor) and bd.table is t
    assert np.array_equal(_u32(t), table["jbd"].table)
    assert bd.device_arrays()[0] is t


def test_build_device_positional_min_nbits(table):
    """build_device(keys, masks, ngenomes, k, mixed, count, min_nbits,
    sorted_input) in panagram_tpu's order: min_nbits widens the table as
    panagram_tpu's does."""
    keys, masks = table["keys"], table["masks"]
    for min_nbits in (2, 12):
        jbd = jl.BucketedDict.build_device(keys, masks, 40, 21, False, None,
                                           min_nbits, False)
        bd = lookup.BucketedDict.build_device(keys, masks, 40, 21, False,
                                              None, min_nbits, False,
                                              device="cpu")
        assert bd.nbits == jbd.nbits
        (jt,) = jbd.device_arrays()
        want = lookup.BucketedDict.from_jax_state(
            np.asarray(jt), jbd.nbits, jbd.cap, jbd.stride, 40, 21, 2)
        assert np.array_equal(_u32(bd.table), want.table)
    assert bd.nbits == 12


def test_check_hbm_budget_in_panagram_tpus_form():
    """check_hbm_budget(D, W, n_shards, what, device_layout, include_table)
    holds the table and the layout's transients to the device's free
    memory; the CPU is not checked."""
    D, W = 10 ** 8, 1

    def need(n, mode, with_table=True):
        per = -(-D // n)
        nbits, _, stride = lookup.table_geometry(per, W)
        table_b = (1 << nbits) * stride * 4 if with_table else 0
        layout = lookup.layout_bytes(per, W, mode) if mode else 0
        return table_b + layout + lookup.ANCHOR_RESERVE_BYTES

    for n, layout, mode, with_table in (
            (1, True, "sort", True), (4, True, "sort", True),
            (1, "sorted", "sorted", True), (1, "chunked", "chunked", True),
            (1, False, None, True), (1, True, "sort", False)):
        fits = need(n, mode, with_table)
        lookup.check_hbm_budget(D, W, n, "d", layout, with_table, free=fits)
        with pytest.raises(RuntimeError, match="d: needs"):
            lookup.check_hbm_budget(D, W, n, "d", layout, with_table,
                                    free=fits - 1)
    assert need(4, "sort") < need(1, "sort")
    lookup.check_hbm_budget(D, W, device="cpu")
    lookup.check_hbm_budget(0, W, free=0)


# --------------------------------------------------------------- anchor


@pytest.mark.parametrize("ngenomes", [3, 40])
def test_anchor_chunk_fast(table, ngenomes):
    rng = np.random.default_rng(ngenomes)
    codes = table["codes"]
    keys = table["keys"]
    W = (ngenomes + 31) // 32
    masks = rng.integers(1, 1 << 32, (len(keys), W), dtype=np.uint64)
    masks[:, -1] &= np.uint64((1 << (ngenomes - 32 * (W - 1))) - 1)
    masks = masks.astype(np.uint32)
    jbd = jl.BucketedDict.build(keys, masks, ngenomes, 21)
    (jt,) = jbd.device_arrays()
    nbytes = (ngenomes + 7) // 8
    packed, nmask, L = pack_bases_np(codes)
    want = jax_anchor.anchor_chunk_fast(
        jnp.asarray(packed), jnp.asarray(nmask), jt, L, 21, jbd.nbits,
        jbd.cap, jbd.nwords, nbytes)
    got = anchor.anchor_chunk_fast(_t(packed), _t(nmask), np.asarray(jt), L,
                                   21, jbd.nbits, jbd.cap, jbd.nwords, nbytes)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), w)
    assert got[2].dtype == torch.int64 and got[1].dtype == torch.int32


def test_anchor_chunk_sorted_dictionary_step(table):
    """panagram_tpu's anchor_chunk(codes, keys, masks, k) -> (rows, popc)
    over a SENTINEL-padded sorted dictionary."""
    keys = np.concatenate([table["keys"], np.full(100, SENTINEL_U64)])
    masks = np.concatenate([table["masks"],
                            np.ones((100, 2), np.uint32)])
    codes = table["codes"][:3000]
    rows, popc = jax_anchor.anchor_chunk(jnp.asarray(codes), jnp.asarray(keys),
                                         jnp.asarray(masks), 21)
    prows, ppopc = anchor.anchor_chunk(_t(codes), _t(keys), _t(masks), 21)
    assert np.array_equal(_u32(prows), np.asarray(rows))
    assert np.array_equal(ppopc.numpy(), np.asarray(popc))
    assert np.array_equal(
        _u32(prows), anchor_np(codes, 21, table["keys"], table["masks"]))


def test_pack_bases_combined_and_masks_to_bytes():
    rng = np.random.default_rng(11)
    for L in (1, 7, 8, 1001):
        codes = _codes(rng, L, 0.2)
        jb, jL = jax_anchor.pack_bases_combined(codes)
        pb, pL = anchor.pack_bases_combined(codes)
        assert pL == jL and pb.dtype == jb.dtype and np.array_equal(pb, jb)
    rows = rng.integers(0, 1 << 32, (300, 3), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jax_anchor.masks_to_bytes(jnp.asarray(rows)))
    assert np.array_equal(anchor.masks_to_bytes(_t(rows)).numpy(), want)


def test_stream_anchor_chunks_positional(table):
    """stream_anchor_chunks(codes, nkmers, chunk, buf, table, bd, nbytes,
    ngenomes, k, state) called as bench.py calls panagram_tpu's: the same
    chunks, bytes, popcounts and column sums."""
    codes = table["codes"]
    jbd = table["jbd"]
    chunk, k = 2048, 21
    nk = len(codes) - k + 1
    buf = np.full(chunk + k - 1, 255, np.uint8)
    want = [(s, m, by.copy(), p.copy(), c.copy())
            for s, m, by, p, c in jax_anchor.stream_anchor_chunks(
                codes, nk, chunk, buf, table["jt"], jbd, 5, 40, k,
                state={})]
    bd = table["bd"].to("cpu")
    got = [(s, m, by.copy(), p.copy(), c.copy())
           for s, m, by, p, c in anchor.stream_anchor_chunks(
               codes, nk, chunk, buf, bd.table, bd, 5, 40, k, {})]
    assert len(got) == len(want) == -(-nk // chunk)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            assert np.array_equal(a, b)


def test_stream_anchor_chunks_trace_times_the_copy(table, capsys):
    """trace=True (bench.py's PANAGRAM_BENCH_TRACE) on the CPU: two chunks
    stream, each drain is printed to stderr, `phase` gains the host's
    packing and copy-back seconds, and the items equal trace=False's."""
    codes = table["codes"]
    bd = table["bd"].to("cpu")
    k = 21
    nk = len(codes) - k + 1
    chunk = -(-nk // 2)

    def run(trace, phase=None):
        return [(s, m, by.copy(), p.copy(), c.copy())
                for s, m, by, p, c in anchor.stream_anchor_chunks(
                    codes, nk, chunk, None, bd.table, bd, 5, 40, k,
                    trace=trace, phase=phase)]

    want = run(False)
    phase = {}
    got = run(True, phase)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            assert np.array_equal(a, b)
    assert set(phase) == {"pack", "copy"}
    assert phase["copy"] > 0 and phase["pack"] > 0
    assert capsys.readouterr().err.count("drain: start=") == 2


# ------------------------------------------------------ count, dictionary


def test_count_functions_positional():
    """counted_kmers_chunked(codes, k, min_count, chunk) and
    distinct_kmers_chunked(codes, k, chunk) in panagram_tpu's order: the
    third argument is the min-count / the chunk, never the device."""
    rng = np.random.default_rng(5)
    reads = [random_seq(rng, 150) for _ in range(200)]
    reads += reads[::2] + reads[::3]
    for mc in (1, 2, 3):
        want = jax_count.counted_kmers_chunked(
            (seq_to_codes(r) for r in reads), 15, mc, 1 << 12)
        got = count.counted_kmers_chunked(
            (seq_to_codes(r) for r in reads), 15, mc, 1 << 12, device="cpu")
        assert np.array_equal(got, want), mc
    seqs = [random_seq(rng, 5000, n_frac=0.01) for _ in range(3)]
    want = jax_count.distinct_kmers_chunked(
        [seq_to_codes(s) for s in seqs], 15, 1 << 11)
    got = count.distinct_kmers_chunked([seq_to_codes(s) for s in seqs], 15,
                                       1 << 11, device="cpu")
    assert np.array_equal(got, want)


def test_dictionary_nbytes_row_and_pairwise_shared_positional():
    rng = np.random.default_rng(6)
    sets = [genome_kmer_set([random_seq(rng, 2000)], 15) for _ in range(37)]
    keys, masks = build_dict_np(sets)
    jd = jax_dictionary.PanKmerDict(keys, masks, 37, 15)
    pd_ = dictionary.PanKmerDict(keys, masks, 37, 15)
    assert pd_.nbytes_row == jd.nbytes_row == 5
    assert np.array_equal(pd_.pairwise_shared(500, device="cpu"),
                          jd.pairwise_shared(500))


def test_device_dict_builder_positional():
    """DeviceDictBuilder(k, ngenomes, chunk, capacity_hint)."""
    rng = np.random.default_rng(7)
    seqs = [random_seq(rng, 3000, n_frac=0.01) for _ in range(4)]
    jb = jax_devdict.DeviceDictBuilder(15, 4, 1024, 1 << 12)
    pb = devdict.DeviceDictBuilder(15, 4, 1024, 1 << 12, device="cpu")
    assert pb.chunk == 1024
    for g, s in enumerate(seqs):
        jb.add_sequence(g, seq_to_codes(s))
        pb.add_sequence(g, seq_to_codes(s))
    jd, pd_ = jb.to_host(), pb.to_host()
    assert np.array_equal(pd_.keys, jd.keys)
    assert np.array_equal(pd_.masks, jd.masks)


def test_make_halo_chunks_positional():
    rng = np.random.default_rng(10)
    codes = _codes(rng, 5000)
    for n, k, c in ((4, 21, None), (3, 15, 1000), (8, 31, 700)):
        args = (codes, n, k) if c is None else (codes, n, k, c)
        jo, jn = jax_shard.make_halo_chunks(*args)
        po, pn = shard.make_halo_chunks(*args)
        assert pn == jn and np.array_equal(po, jo)


# ------------------------------------------------------------------- io


def test_bgzf_writer_on_a_file_object_and_block_table():
    """BgzfWriter(fileobj, level): the bytes and the block table of
    panagram_tpu's writer; the caller's file stays open after close()."""
    rng = np.random.default_rng(12)
    data = [rng.integers(0, 4, n, dtype=np.uint8).tobytes()
            for n in (10, 70_000, 3, 200_000, 65_280)]
    jf, pf = io.BytesIO(), io.BytesIO()
    jw, pw = JaxBgzfWriter(jf, 6), BgzfWriter(pf, 6)
    for d in data:
        jw.write(d)
        pw.write(d)
    assert pw.block_table == jw.block_table
    jw.close()
    pw.close()
    assert not pf.closed
    assert pw.block_table == jw.block_table and len(pw.block_table) > 4
    assert pf.getvalue() == jf.getvalue()


def test_bgzf_writer_on_a_path_closes_it(tmp_path):
    p = tmp_path / "x.gz"
    w = BgzfWriter(str(p), 6)
    w.write(b"ACGT" * 40_000)
    w.close()
    assert w._fh.closed
    assert gzip.decompress(p.read_bytes()) == b"ACGT" * 40_000


def test_gff_names():
    from panagram_tpu.io import gff as jax_gff
    from panagram_tpu_torch.io import gff

    assert gff.GFF_NAMES == jax_gff.GFF_NAMES


def test_intro_df_template_columns():
    from panagram_tpu.intros.core import get_intro_df_template as jax_tpl
    from panagram_tpu_torch.intros.core import get_intro_df_template

    for bs, n in ((10, 95), (10, 100), (10_000, 2_000_000), (7, 1)):
        want = jax_tpl(bs, n)
        got = get_intro_df_template(bs, n)
        assert list(got.columns) == list(want.columns)
        assert list(got.index) == list(want.index)
        assert np.array_equal(got.values, want.to_numpy())


# ------------------------------------------------- index and pipeline


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The 3-genome fixture built by panagram_tpu, then by the port's
    stage functions called positionally as panagram_tpu's pipeline calls
    its own."""
    tmp = tmp_path_factory.mktemp("api_calls")
    samples = write_fixture(tmp, np.random.default_rng(1234))
    jax_pipeline.build_index(str(samples), prefix=str(tmp / "jax"), k=K)
    idx = port_index.Index(str(samples), mode="w", prefix=str(tmp / "port"),
                           k=K)
    for name in idx.genome_names:
        pipeline.count_genome(idx, name, False, device="cpu")
    pipeline.build_dict_stage(idx, False, device="cpu")
    for name in idx.anchor_genomes:
        pipeline.anchor_stage(idx, name, None, False, device="cpu")
    pipeline.dist_stage(idx, None, False, device="cpu")
    return dict(tmp=tmp, samples=samples, idx=idx)


def test_stage_functions_positional(trees):
    tmp, idx = trees["tmp"], trees["idx"]
    assert_same_trees(tmp / "port", tmp / "jax")
    g = idx.genomes[idx.anchor_genomes[0]]
    before = os.path.getmtime(g.bitmap_gz_fname(1))
    # fresh outputs: skipped; force (the fourth argument): anchored again
    pipeline.anchor_stage(idx, g.name, None, False, device="cpu")
    assert os.path.getmtime(g.bitmap_gz_fname(1)) == before
    pipeline.anchor_stage(idx, g.name, None, True, device="cpu")
    assert os.path.getmtime(g.bitmap_gz_fname(1)) > before
    assert_same_trees(tmp / "port", tmp / "jax")


def test_build_index_positional_device_dict(trees, tmp_path):
    """build_index(samples, prefix, force, device_dict): the fourth
    argument is device_dict."""
    jax_build_device_dict(trees["samples"], tmp_path / "jax", k=K)
    pipeline.build_index(str(trees["samples"]), str(tmp_path / "port"),
                         False, True, device="cpu", k=K)
    assert_same_trees(tmp_path / "port", tmp_path / "jax")


def test_build_index_distributed_positional(trees, tmp_path):
    """(samples, prefix, num_processes, process_id, coordinator, force,
    device_dict): a coordinator in fifth place is not taken for force."""
    idx = distributed.build_index_distributed(
        str(trees["samples"]), str(tmp_path / "port"), 1, 0,
        "127.0.0.1:1", False, False, device="cpu", k=K)
    assert idx.prefix == str(tmp_path / "port")
    assert_same_trees(tmp_path / "port", trees["tmp"] / "jax")


class _RootLogging:
    """Keeps the root logger's handlers and level across init_logger."""

    def __enter__(self):
        root = logging.getLogger()
        self.saved = root.handlers[:], root.level
        return self

    def __exit__(self, *exc):
        root = logging.getLogger()
        for h in root.handlers:
            if h not in self.saved[0]:
                h.close()
        root.handlers[:] = self.saved[0]
        root.setLevel(self.saved[1])


def test_run_anchor_positional_with_logfile(trees, tmp_path):
    """run_anchor(pan_dict, logfile): pandict.npz is loaded when pan_dict
    is None, the table laid out on the device given, and the log goes to
    logfile."""
    shutil.copytree(trees["tmp"] / "port", tmp_path / "port")
    idx = port_index.Index(str(tmp_path / "port"), mode="w")
    g = idx.genomes["g2"]
    os.remove(g.bitmap_gz_fname(1))
    log = tmp_path / "anchor.log"
    with _RootLogging():
        g.run_anchor(None, str(log), device="cpu")
    assert "Anchoring Started" in log.read_text()
    assert_same_trees(tmp_path / "port", trees["tmp"] / "jax")


def test_run_annotate_positional_nogene(trees, tmp_path):
    """run_annotate(gff_file, logfile, nogene) in panagram_tpu's order."""
    from tests.test_torch_annotate import NEW_GFF

    gff = tmp_path / "new.gff"
    gff.write_text(NEW_GFF)
    for pkg in ("jax", "port"):
        shutil.copytree(trees["tmp"] / "port", tmp_path / pkg)
    with _RootLogging():
        JaxIndex(str(tmp_path / "jax"))["g3"].run_annotate(str(gff), None,
                                                           True)
        port_index.Index(str(tmp_path / "port"))["g3"].run_annotate(
            str(gff), None, True, device="cpu")
    d = tmp_path / "port" / "anchor" / "g3"
    assert not (d / "gene.bed.gz").exists()
    assert (d / "anno.bed.gz").exists()
    assert_same_trees(tmp_path / "port", tmp_path / "jax")


def test_index_members(trees, tmp_path):
    """The members panagram_tpu's Index and Genome have, read from one
    tree by both packages."""
    tree = str(trees["tmp"] / "jax")
    j, p = JaxIndex(tree), port_index.Index(tree)
    assert p.params == j.params
    assert p.get_subdir("kmc") == j.get_subdir("kmc") == p.kmer_dir
    for name in ("BGZ_SUFFIX", "IDX_SUFFIX", "TABIX_TYPES"):
        assert getattr(port_index, name) == getattr(jax_index, name)
    bm_j = j.query_bitmap("g1", "chr1", 0, 2500)
    bm_p = p.query_bitmap("g1", "chr1", 0, 2500)
    for binlen in (100, 700):
        want = j.bitmap_to_paircount_bins(bm_j, binlen)
        got = p.bitmap_to_paircount_bins(bm_p, binlen)
        assert list(got.columns) == list(want.columns)
        assert list(got.index) == list(want.index)
        assert np.array_equal(got.values, want.to_numpy())
    for name in j.genome_names:
        jg, pg = j.genomes[name], p.genomes[name]
        assert pg.anchor_filenames == jg.anchor_filenames
        assert list(pg.bitsum_index) == list(jg.bitsum_index)
        assert pg.gene_tabix_types == jg.gene_tabix_types
        if jg.chrs is not None:
            assert pg.chr_count == jg.chr_count
            for c in jg.chrs.index:
                assert pg.seq_len(seq_name=c) == jg.seq_len(seq_name=c)
        if jg.fasta is not None:
            assert list(pg.iter_fasta()) == list(jg.iter_fasta())
    # set_chrs with a table that lacks gene_count adds zeros
    jg, pg = j.genomes["g1"], p.genomes["g1"]
    jg.set_chrs(jg.chrs[["id", "size"]].copy())
    t = pg.chrs_table
    pg.set_chrs(port_index.Table(t.values[:, :2], t.index, ["id", "size"]))
    assert [c[1:] for c in pg.chrs] == jg.chrs.to_numpy().tolist()
    assert [c[0] for c in pg.chrs] == list(jg.chrs.index)


def test_write_and_load_config(trees, tmp_path):
    for pkg in ("jax", "port"):
        shutil.copytree(trees["tmp"] / "jax", tmp_path / pkg)
    j = JaxIndex(str(tmp_path / "jax"), mode="w")
    p = port_index.Index(str(tmp_path / "port"), mode="w")
    j.conf.k = p.conf.k = 13
    j.write_config()
    p.write_config()
    assert (tmp_path / "port" / "config.yaml").read_bytes() == \
        (tmp_path / "jax" / "config.yaml").read_bytes()
    p.conf.k = 99
    p.load_config()
    assert p.k == 13


def test_genome_positional_constructor(trees):
    """Genome(idx, id, name, fasta, gff, anchor, write)."""
    from panagram_tpu.index import Genome as JaxGenome

    tree = str(trees["tmp"] / "jax")
    j, p = JaxIndex(tree), port_index.Index(tree)
    fa = p.genomes["g2"].fasta
    jg = JaxGenome(j, 1, "g2", fa, None, True)
    pg = port_index.Genome(p, 1, "g2", fa, None, True)
    assert (pg.id, pg.name, pg.anchored, pg.prefix) == \
        (jg.id, jg.name, jg.anchored, jg.prefix)
    assert pg.chrs is not None and jg.chrs is not None


def test_init_logger_writes_panagram_tpus_format(tmp_path):
    with _RootLogging():
        port_index.init_logger(str(tmp_path / "log.txt"))
        logging.getLogger("panagram_tpu_torch.x").info("hello")
    line = (tmp_path / "log.txt").read_text().strip()
    assert line.startswith("[") and line.endswith(" INFO] hello")
