"""The port's mesh engine (panagram_tpu_torch.parallel) against panagram_tpu's
on the CPU: Gloo ranks spawned by parallel.mesh.launch, panagram_tpu's
shard_map engine on the 8-device virtual CPU mesh of tests/conftest.py.

Exact comparison throughout (tolerance 0): dictionaries and mask rows are
integers, and the index files are compared as tests/test_torch_index.py
compares them (assert_same_file: bitmaps and npz members exactly,
anno_types.txt as a set, UMAP coordinates within 1e-9).  The rank functions
live at module level, so spawned ranks import them; this module imports no
jax at its top, so they do not import it either.
"""

import numpy as np
import pytest
import torch

from panagram_tpu_torch.io.fasta import seq_to_codes
from panagram_tpu_torch.ops.dictionary import PanKmerDict, build_dictionary
from panagram_tpu_torch.ops.lookup import mix64_np
from panagram_tpu_torch.parallel import mesh as pmesh
from panagram_tpu_torch.parallel import shard

K = 11
LAUNCH_TIMEOUT = 240
# positions per rank of a chunk in the unit checks: several ranks per chunk
C_DEV = 160


def random_seq(rng, n, n_frac=0.0):
    bases = np.array(list("ACGT"))
    seq = rng.choice(bases, size=n)
    if n_frac > 0:
        seq[rng.random(n) < n_frac] = "N"
    return "".join(seq)


def _sets(seqs):
    from panagram_tpu_torch.ops.ref_impl import genome_kmer_set

    return [genome_kmer_set([s], K) for s in seqs]


def _anchor(mesh, sd, seq, ngenomes, chunk):
    """stream_mesh_chunks over one sequence: (bytes, popc, colsums) on the
    writer, None elsewhere."""
    codes = seq_to_codes(seq)
    nk = len(codes) - K + 1
    out = [item for item in shard.stream_mesh_chunks(
        mesh, sd, codes, nk, chunk, (ngenomes + 7) // 8, ngenomes, K)]
    if not mesh.writer:
        return None
    return (np.concatenate([o[2] for o in out]),
            np.concatenate([o[3] for o in out]),
            sum(o[4] for o in out))


def _inputs():
    """The unit checks' genomes (seed 7) and the cases of each mesh size:
    made from the seed by every rank and by the test, so that only the
    seed travels to the spawned ranks."""
    rng = np.random.default_rng(7)
    seqs5 = [random_seq(rng, 1200, n_frac=0.01) for _ in range(5)]
    seqs12 = [random_seq(rng, 900, n_frac=0.01) for _ in range(12)]
    seqs80 = [random_seq(rng, 700, n_frac=0.01) for _ in range(80)]
    g80 = seqs80[3] + random_seq(rng, 150, n_frac=0.1)
    sets5, sets12 = _sets(seqs5), _sets(seqs12)
    d5 = build_dictionary(sets5, K, device="cpu")
    d12 = build_dictionary(sets12, K, device="cpu")
    d80 = build_dictionary(_sets(seqs80), K, device="cpu")
    o5 = np.argsort(mix64_np(d5.keys))
    cases = {
        4: {"n5": dict(kind="range", ngenomes=5, sets=sets5, dict=d5,
                       anchor=[seqs5[0], seqs5[2], seqs5[3]],
                       reshard=[d5, PanKmerDict(mix64_np(d5.keys)[o5],
                                                d5.masks[o5], 5, K,
                                                key_space="mixed")]),
            "n12": dict(kind="range", ngenomes=12, sets=sets12, dict=d12,
                        anchor=[seqs12[1]]),
            "n80": dict(kind="genomes", ngenomes=80, dict=d80,
                        anchor=[g80])},
        3: {"n5": dict(kind="range", ngenomes=5, sets=sets5, dict=d5,
                       anchor=[seqs5[2]])},
    }
    return cases


def _rank_checks(mesh):
    """Every case of this mesh size on this rank: a sharded build (host
    dictionary gathered to the writer) and anchors through it, through
    shard_dictionary of a canonical and of a mixed dictionary, and through
    shard_dictionary_genomes.  The other ranks report whether they were
    handed a dictionary or chunk results."""
    out, peer = {}, {"pan": [], "chunks": []}
    for name, c in _inputs()[mesh.size].items():
        ng = c["ngenomes"]
        chunk = C_DEV * mesh.size
        res = {}
        if c["kind"] == "range":
            sbd, pan = shard.sharded_build_dictionary(c["sets"], mesh, ng, K,
                                                      return_host_dict=True)
            peer["pan"].append(pan is not None)
            if mesh.writer:
                res["pan"] = (pan.keys, pan.masks, pan.key_space)
            res["built"] = [_anchor(mesh, sbd, s, ng, chunk)
                            for s in c["anchor"]]
            for d in c.get("reshard", ()):
                sd = shard.shard_dictionary(d, mesh)
                res[d.key_space] = [_anchor(mesh, sd, s, ng, chunk)
                                    for s in c["anchor"]]
        else:
            gsd = shard.shard_dictionary_genomes(c["dict"], mesh)
            res["nwords_local"] = gsd.nwords_local
            res["genomes"] = [_anchor(mesh, gsd, s, ng, 512)
                              for s in c["anchor"]]
        peer["chunks"] += [r is not None for v in res.values()
                           if isinstance(v, list) for r in v]
        out[name] = res
    return out if mesh.writer else peer


def _oracle(seq, d, ngenomes):
    from panagram_tpu.ops.ref_impl import anchor_np, masks_to_bytes_np

    rows = anchor_np(seq, K, d.keys, d.masks)
    bits = np.unpackbits(rows.astype("<u4").view(np.uint8), axis=1,
                         bitorder="little")[:, :ngenomes]
    return (masks_to_bytes_np(rows, (ngenomes + 7) // 8),
            bits.sum(axis=1).astype(np.int32), bits.sum(axis=0))


@pytest.fixture(scope="module")
def launched():
    """The RankResults of the rank checks on meshes of 3 and of 4 CPU
    ranks (one launch each)."""
    return {S: pmesh.launch(_rank_checks, (), S, "cpu",
                            timeout=LAUNCH_TIMEOUT) for S in (3, 4)}


@pytest.fixture(scope="module")
def checks(launched):
    """The writer's rank checks of each mesh size, and their cases."""
    return {S: r[0].value for S, r in launched.items()}, _inputs()


@pytest.mark.parametrize("S", [3, 4])
def test_only_the_writer_receives_results(launched, S):
    """The dictionary and the chunk results are gathered to the writer
    (rank 0 on one host) only: the other ranks hold neither.  A CPU rank
    launches no kernel, and its counts stay in its RankResult: the
    parent's counters are untouched."""
    from panagram_tpu_torch.ops import kernels

    results = launched[S]
    assert [r.rank for r in results] == list(range(S))
    for r in results[1:]:
        assert r.value["pan"] and not any(r.value["pan"])
        assert r.value["chunks"] and not any(r.value["chunks"])
    for r in results:
        assert r.peak_bytes == 0 and not any(r.launches.values())
    assert not any(kernels.launches.values())


def test_set_files_are_mapped_not_loaded(tmp_path):
    """A rank of the range build reads only its slice of each k-mer set:
    npz_member maps a stored member where it lies in the archive; a
    compressed or an empty member is loaded whole; PanKmerDict.load(mmap)
    maps keys and masks."""
    from panagram_tpu_torch.ops.dictionary import npz_member

    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 62, 5000, dtype=np.uint64)
    masks = rng.integers(0, 1 << 32, (5000, 3), dtype=np.uint64) \
        .astype(np.uint32)
    np.savez(tmp_path / "s.npz", kmers=keys, k=K, empty=np.zeros(0, np.uint64))
    np.savez_compressed(tmp_path / "c.npz", kmers=keys)
    got = npz_member(str(tmp_path / "s.npz"), "kmers", mmap=True)
    assert isinstance(got, np.memmap)
    assert np.array_equal(got[1234:2345], keys[1234:2345])
    assert int(npz_member(str(tmp_path / "s.npz"), "k", mmap=True)) == K
    assert npz_member(str(tmp_path / "s.npz"), "empty", mmap=True).shape == (0,)
    whole = npz_member(str(tmp_path / "c.npz"), "kmers", mmap=True)
    assert not isinstance(whole, np.memmap) and np.array_equal(whole, keys)
    PanKmerDict(keys, masks, 70, K).save(str(tmp_path / "d.npz"))
    d = PanKmerDict.load(str(tmp_path / "d.npz"), mmap=True)
    assert isinstance(d.keys, np.memmap) and isinstance(d.masks, np.memmap)
    assert np.array_equal(d.keys, keys) and np.array_equal(d.masks, masks)
    assert (d.ngenomes, d.k, d.key_space) == (70, K, "canon")


@pytest.mark.parametrize("S", [3, 4])
def test_sharded_build_matches_host_merge_and_jax(checks, S):
    """The rank-order gather of the sharded build is the host merge in
    mixed space, sorted in unsigned order, and panagram_tpu's
    sharded_build_dictionary host dictionary on a mesh of S devices."""
    from panagram_tpu.parallel import make_mesh
    from panagram_tpu.parallel import sharded_build_dictionary as jax_build

    out, cases = checks
    keys, masks, space = out[S]["n5"]["pan"]
    d = cases[S]["n5"]["dict"]
    order = np.argsort(mix64_np(d.keys))
    assert space == "mixed"
    assert np.array_equal(keys, mix64_np(d.keys)[order])
    assert np.array_equal(masks, d.masks[order])
    _, jpan = jax_build(cases[S]["n5"]["sets"], make_mesh(S), ngenomes=5, k=K,
                        return_host_dict=True)
    assert keys.dtype == jpan.keys.dtype and masks.dtype == jpan.masks.dtype
    assert np.array_equal(keys, jpan.keys)
    assert np.array_equal(masks, jpan.masks)


@pytest.mark.parametrize("case, S", [("n5", 4), ("n5", 3), ("n12", 4)])
def test_sharded_anchor_matches_oracle(checks, case, S):
    """Range-sharded anchoring (160 positions per rank and chunk) gives the
    numpy oracle's bytes, popcounts and per-genome totals: 5 genomes on 3
    and 4 ranks, and 12 (two bytes per row) on 4."""
    out, cases = checks
    c = cases[S][case]
    for seq, got in zip(c["anchor"], out[S][case]["built"]):
        want = _oracle(seq, c["dict"], c["ngenomes"])
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("space", ["canon", "mixed"])
def test_shard_existing_dictionary_both_key_spaces(checks, space):
    """shard_dictionary of a canonical and of a mixed dictionary probes as
    the sharded build's tables do."""
    out, cases = checks
    c = cases[4]["n5"]
    for seq, got in zip(c["anchor"], out[4]["n5"][space]):
        want = _oracle(seq, c["dict"], 5)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_genome_sharded_matches_oracle(checks):
    """80 genomes (3 mask words) over 4 ranks of one word each, the last
    rank holding none: assembled byte slices, summed popcounts and the
    per-genome totals equal the oracle."""
    out, cases = checks
    res, c = out[4]["n80"], cases[4]["n80"]
    assert res["nwords_local"] == 1
    want = _oracle(c["anchor"][0], c["dict"], 80)
    for g, w in zip(res["genomes"][0], want):
        assert np.array_equal(g, w)


def test_unmix_inverts_mix():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 63, 1000, dtype=np.uint64) * np.uint64(2) + \
        np.uint64(1)
    assert np.array_equal(shard._unmix64_np(mix64_np(x)), x)
    assert np.array_equal(shard._uniform_bounds(1), np.zeros(1, np.uint64))


# ----------------------------------------------------------- the CLI --


def _write_genomes(tmp, rng, n, length, chroms=1):
    """n genomes, each a mutated copy of one base (chr1) and, with chroms=2,
    of a second one (chr2), with a few Ns; samples.tsv with absolute
    paths."""
    fa = tmp / "fa"
    fa.mkdir()
    bases = [random_seq(rng, length, n_frac=0.005) for _ in range(chroms)]

    def mutate(seq, k):
        s = list(seq)
        for i in rng.choice(len(s), k, replace=False):
            s[i] = "ACGT"[rng.integers(4)]
        return "".join(s)

    names = [f"g{i:02d}" for i in range(n)]
    for i, name in enumerate(names):
        with open(fa / f"{name}.fa", "w") as f:
            for c, b in enumerate(bases):
                seq = b if i == 0 else mutate(b, 10 + i)
                f.write(f">chr{c + 1}\n")
                for j in range(0, len(seq), 60):
                    f.write(seq[j:j + 60] + "\n")
    samples = tmp / "samples.tsv"
    samples.write_text("name\tfasta\n" + "".join(
        f"{n}\t{fa}/{n}.fa\n" for n in names))
    return names, samples


@pytest.mark.parametrize("ngenomes", [3, 34])
def test_mesh_cli_equals_panagram_tpu_mesh(tmp_path, monkeypatch, ngenomes):
    """`index --mesh 4 --device cpu` under both strategies writes the tree
    of `panagram_tpu index --mesh 4` file for file (kmc/pandict.npz
    included), and the port's one-device tree but for pandict.npz:
    3 genomes of two chromosomes, and 34 of one (two mask words), 1024
    positions per chunk, so that every chunk spans the ranks."""
    from panagram_tpu import index as jax_index
    from panagram_tpu.__main__ import main as jax_main
    from panagram_tpu_torch import index as port_index
    from panagram_tpu_torch.__main__ import main as port_main
    from tests.test_torch_index import assert_same_trees

    monkeypatch.setattr(jax_index, "ANCHOR_CHUNK", 1 << 10)
    monkeypatch.setenv("PANAGRAM_TPU_CHUNK_LOG2", "10")   # the spawned ranks
    monkeypatch.setattr(port_index, "ANCHOR_CHUNK", 1 << 10)
    rng = np.random.default_rng(99 + ngenomes)
    if ngenomes == 3:
        names, samples = _write_genomes(tmp_path, rng, 3, 2500, chroms=2)
        extra = []
    else:
        names, samples = _write_genomes(tmp_path, rng, 34, 1100)
        extra = ["--anchor-genomes", *names[:2]]
    base = ["index", str(samples), "-k", str(K), *extra]
    port_main(base + ["-o", str(tmp_path / "single"), "--device", "cpu"])
    for strategy in ("range", "genomes"):
        jax_dir, port_dir = tmp_path / f"jax_{strategy}", tmp_path / strategy
        jax_main(base + ["-o", str(jax_dir), "--mesh", "4",
                         "--mesh-strategy", strategy])
        port_main(base + ["-o", str(port_dir), "--mesh", "4",
                          "--mesh-strategy", strategy, "--device", "cpu"])
        assert_same_trees(port_dir, jax_dir)
        # one writer per file: the one-device tree's bytes, .gzi included
        assert_same_trees(port_dir, tmp_path / "single",
                          skip=("pandict.npz",))
    # the range strategy's dictionary is the one-device one, mixed
    single = np.load(tmp_path / "single" / "kmc" / "pandict.npz")
    mesh = np.load(tmp_path / "range" / "kmc" / "pandict.npz")
    order = np.argsort(mix64_np(single["keys"]))
    assert str(mesh["key_space"]) == "mixed"
    assert np.array_equal(mesh["keys"], mix64_np(single["keys"])[order])
    assert np.array_equal(mesh["masks"], single["masks"][order])


def test_mesh_refusals(tmp_path):
    """--mesh on cuda without enough cards raises naming the count; a mesh
    strategy without --mesh and a multi-process mesh without a coordinator
    are SystemExits, as panagram_tpu's."""
    from panagram_tpu_torch.__main__ import main as port_main
    from panagram_tpu_torch.pipeline import build_index

    rng = np.random.default_rng(5)
    _, samples = _write_genomes(tmp_path, rng, 2, 300)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_index(str(samples), prefix=str(tmp_path / "c"), k=K,
                        device="cuda", mesh_devices=2)
    else:
        n = torch.cuda.device_count()
        with pytest.raises(RuntimeError, match=f"{n} are visible"):
            build_index(str(samples), prefix=str(tmp_path / "c"), k=K,
                        device="cuda", mesh_devices=n + 1)
    with pytest.raises(SystemExit, match="requires --mesh"):
        port_main(["index", str(samples), "-o", str(tmp_path / "s"),
                   "--mesh-strategy", "genomes", "--device", "cpu"])
    with pytest.raises(SystemExit, match="coordinator"):
        port_main(["index", str(samples), "-o", str(tmp_path / "x"),
                   "--mesh", "4", "--num-processes", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="multiple"):
        pmesh.launch(_rank_checks, (), 3, "cpu", num_processes=2,
                     coordinator="127.0.0.1:1")


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    pmesh.barrier(mesh)


def test_failing_rank_fails_the_launch():
    """A rank that raises makes launch raise with its error, and the rank
    waiting for it in a barrier is stopped, within the timeout."""
    # the error comes from rank 1, or from rank 0 losing its peer first
    with pytest.raises(Exception, match="fails on purpose|closed by peer"):
        pmesh.launch(_fail_on_rank_1, (), 2, "cpu", timeout=LAUNCH_TIMEOUT)
