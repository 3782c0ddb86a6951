"""The port's index build against panagram_tpu's, byte for byte, on the CPU.

The 3-genome, 2-chromosome fixture of tests/test_index.py (k=11, an N
run in g3) without its GFF goes through both packages' build_index, on the
default route and on --device-dict; every file the port writes must equal
panagram_tpu's.  Exact comparison throughout (tolerance 0), but for two
kinds of file: anno_types.txt lists a set in hash order (compared as a set
of lines), and the UMAP coordinates of chrom_umaps.csv / genome_umap.csv
come from floating-point PCA (UMAP_ATOL absolute; every other column
exact).
"""

import csv
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.ops import devdict as jax_devdict
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch.__main__ import main as port_main
from panagram_tpu_torch.ops.lookup import mix64_np
from panagram_tpu_torch.pipeline import build_index
from tests.conftest import random_seq

torch.set_num_threads(2)

K = 11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UMAP_FILES = ("chrom_umaps.csv", "genome_umap.csv")
UMAP_ATOL = 1e-9


def write_fixture(tmp, rng):
    """The test_index.py genomes as FASTA and a samples.tsv with an empty
    gff column."""
    base1 = random_seq(rng, 3000)
    base2 = random_seq(rng, 1500)

    def mutate(seq, n):
        s = list(seq)
        for i in rng.choice(len(s), n, replace=False):
            s[i] = "ACGT"[rng.integers(4)]
        return "".join(s)

    genomes = {
        "g1": {"chr1": base1, "chr2": base2},
        "g2": {"chr1": mutate(base1, 60), "chr2": mutate(base2, 30)},
        "g3": {"chr1": base1[:1400] + "NN" + mutate(base1[1400:], 40)},
    }
    fa_dir = tmp / "fastas"
    fa_dir.mkdir()
    for name, chrs in genomes.items():
        with open(fa_dir / f"{name}.fa", "w") as f:
            for c, seq in chrs.items():
                f.write(f">{c} desc\n")
                for i in range(0, len(seq), 60):
                    f.write(seq[i:i + 60] + "\n")
    samples = tmp / "samples.tsv"
    samples.write_text("name\tfasta\tgff\n" + "".join(
        f"{n}\t{fa_dir}/{n}.fa\t\n" for n in genomes))
    return samples


def assert_same_umaps(p, q):
    """Two UMAP CSVs: the same header and rows, chrom/start/end/cluster
    exact and umap1/umap2 within UMAP_ATOL."""
    with open(p, newline="") as f:
        a = list(csv.reader(f))
    with open(q, newline="") as f:
        b = list(csv.reader(f))
    assert a[0] == b[0] == ["chrom", "start", "end", "umap1", "umap2",
                            "cluster"], p
    assert len(a) == len(b), p
    for ra, rb in zip(a[1:], b[1:]):
        assert ra[:3] + ra[5:] == rb[:3] + rb[5:], (p, ra, rb)
        for x, y in zip(ra[3:5], rb[3:5]):
            assert abs(float(x) - float(y)) <= UMAP_ATOL, (p, ra, rb)


def assert_same_file(p, q):
    """npz members array by array, anno_types.txt as a set of lines, the
    UMAP CSVs by assert_same_umaps, everything else byte for byte."""
    fn = os.path.basename(p)
    if fn.endswith(".npz"):
        a, b = np.load(p), np.load(q)
        assert a.files == b.files, p
        for f in a.files:
            assert a[f].dtype == b[f].dtype, (p, f)
            assert np.array_equal(a[f], b[f]), (p, f)
    elif fn == "anno_types.txt":
        with open(p) as f, open(q) as g:
            a, b = f.read().splitlines(), g.read().splitlines()
        assert sorted(a) == sorted(b) and len(set(a)) == len(a), p
    elif fn in UMAP_FILES:
        assert_same_umaps(p, q)
    else:
        assert filecmp.cmp(p, q, shallow=False), p


def assert_same_tree(port_dir, jax_dir, skip=()):
    """Every file under port_dir (but logs/ and the names in skip) equals
    its twin under jax_dir (assert_same_file)."""
    n = 0
    for root, _, files in os.walk(port_dir):
        rel = os.path.relpath(root, port_dir)
        if rel.split(os.sep)[0] == "logs":
            continue
        for fn in files:
            if fn in skip:
                continue
            p = os.path.join(root, fn)
            q = os.path.join(jax_dir, rel, fn)
            assert os.path.exists(q), q
            assert_same_file(p, q)
            n += 1
    return n


class _SmallChunkBuilder(jax_devdict.DeviceDictBuilder):
    """panagram_tpu's device dictionary builder with 4096-position chunks
    instead of 2^22: the dictionary does not depend on the chunk size, and
    the small chunk keeps its CPU run to seconds."""

    def __init__(self, k, ngenomes, chunk=1 << 12, capacity_hint=None):
        super().__init__(k, ngenomes, chunk, capacity_hint)


def jax_build_device_dict(samples, prefix, **params):
    """panagram_tpu's build_index(device_dict=True) with _SmallChunkBuilder."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_devdict, "DeviceDictBuilder", _SmallChunkBuilder)
        jax_build_index(str(samples), prefix=str(prefix), device_dict=True,
                        **params)


def assert_same_trees(port_dir, jax_dir, skip=()):
    """assert_same_tree, and the two trees hold the same number of files
    (but logs/ and the names in skip)."""
    n = assert_same_tree(str(port_dir), str(jax_dir), skip)
    m = sum(1 for root, _, files in os.walk(jax_dir)
            if os.path.relpath(root, jax_dir).split(os.sep)[0] != "logs"
            for f in files if f not in skip)
    assert n == m
    return n


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_index")
    samples = write_fixture(tmp, np.random.default_rng(1234))
    jax_build_index(str(samples), prefix=str(tmp / "jax"), k=K)
    idx = build_index(str(samples), prefix=str(tmp / "port"), k=K,
                      device="cpu")
    return dict(tmp=tmp, samples=samples, idx=idx)


def test_outputs_byte_identical(built):
    tmp = built["tmp"]
    n = assert_same_trees(tmp / "port", tmp / "jax")
    want = {"samples.tsv", "config.yaml", "genome_dist.tsv"}
    for g in ("g1", "g2", "g3"):
        want |= {f"anchor/{g}/{f}" for f in (
            "bitmap.1.gz", "bitmap.1.gzi", "bitmap.100.gz", "bitmap.100.gzi",
            "chrs.tsv", "bitsum.bins.tsv", "total_paircounts.csv",
            "chrom_umaps.csv", "genome_umap.csv")}
        want.add(f"kmc/{g}.kmers.npz")
    want.add("kmc/pandict.npz")
    for f in want:
        assert (tmp / "port" / f).exists(), f
    assert n == len(want)
    logs = set(os.listdir(tmp / "port" / "logs"))
    assert {"dict.benchmark.txt", "layout.benchmark.txt",
            "mash.triangle.benchmark.txt", "anchor.g1.benchmark.txt",
            "kmc.g3.benchmark.txt", "anchor.g2.log.txt"} <= logs


def test_jax_reader_opens_port_index(built):
    tmp = built["tmp"]
    port = JaxIndex(str(tmp / "port"))
    ref = JaxIndex(str(tmp / "jax"))
    for args in (("g1", "chr1", 100, 600), ("g3", "chr1", 1350, 1450),
                 ("g2", "chr2", 0, 1400, 100)):
        got = port.query_bitmap(*args)
        assert got.shape[0] > 0
        assert got.equals(ref.query_bitmap(*args))
    assert port.bitsum_bins.equals(ref.bitsum_bins)
    port.close()
    ref.close()


def test_resume_skips_fresh_stages(built):
    port = built["tmp"] / "port"
    outs = [port / "kmc" / "pandict.npz", port / "anchor" / "g1" / "bitmap.1.gz",
            port / "genome_dist.tsv", port / "kmc" / "g2.kmers.npz"]
    before = [os.path.getmtime(p) for p in outs]
    build_index(str(port), device="cpu")
    assert [os.path.getmtime(p) for p in outs] == before


def test_cli_prepare_and_refusals(built, tmp_path, capsys):
    samples = built["samples"]
    port_main(["index", str(samples), "-k", str(K), "--prefix",
               str(tmp_path / "prep"), "-p"])
    assert (tmp_path / "prep" / "config.yaml").read_bytes() == \
        (built["tmp"] / "port" / "config.yaml").read_bytes()
    assert "Prepared index" in capsys.readouterr().out

    base = ["index", str(samples), "-k", str(K), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--mesh-strategy requires --mesh"):
        port_main(base + ["--prefix", str(tmp_path / "mesh"),
                          "--mesh-strategy", "genomes"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_main(["index", str(samples), "-k", str(K), "--prefix",
                       str(tmp_path / "mesh"), "--mesh", "2"])
        with pytest.raises(RuntimeError, match="cuda"):
            build_index(str(samples), prefix=str(tmp_path / "c"), device="cuda")


@pytest.fixture(scope="module")
def built_dd(built):
    """The fixture through --device-dict: panagram_tpu's build_index and
    the port's CLI."""
    tmp = built["tmp"]
    jax_build_device_dict(built["samples"], tmp / "jax_dd", k=K)
    port_main(["index", str(built["samples"]), "-k", str(K), "--prefix",
               str(tmp / "port_dd"), "--device", "cpu", "--device-dict"])
    return tmp


def test_device_dict_outputs_byte_identical(built_dd):
    tmp = built_dd
    n = assert_same_trees(tmp / "port_dd", tmp / "jax_dd")
    assert n == 3 + 1 + 9 * 3           # no per-genome k-mer set files
    assert not any(f.endswith(".kmers.npz")
                   for f in os.listdir(tmp / "port_dd" / "kmc"))
    pan = np.load(tmp / "port_dd" / "kmc" / "pandict.npz")
    assert str(pan["key_space"]) == "mixed"
    # the same dictionary as the default route's, in mixed space
    canon = np.load(tmp / "port" / "kmc" / "pandict.npz")
    mixed = mix64_np(canon["keys"])
    order = np.argsort(mixed)
    assert np.array_equal(pan["keys"], mixed[order])
    assert np.array_equal(pan["masks"], canon["masks"][order])
    for g in ("g1", "g2", "g3"):
        for f in ("bitmap.1.gz", "bitsum.bins.tsv", "total_paircounts.csv"):
            assert filecmp.cmp(tmp / "port_dd" / "anchor" / g / f,
                               tmp / "port" / "anchor" / g / f, shallow=False)


def test_runs_without_jax_pandas_yaml_sklearn(built, built_dd, tmp_path):
    """The package imports and builds the fixture, on both routes, then an
    annotated build with a FASTQ read set on 2 threads and an annotate
    run, with jax, pandas, yaml and sklearn made unimportable."""
    args = ["index", str(built["samples"]), "-k", str(K), "--device", "cpu"]
    fa = built["samples"].parent / "fastas"
    (tmp_path / "g1.gff").write_text(
        "chr1\tsrc\tgene\t101\t400\t.\t+\t.\tID=gene1;Name=GeneA\n"
        "chr1\tsrc\texon\t101\t220\t.\t+\t.\tID=ex1;Parent=gene1\n")
    with open(fa / "g2.fa") as f:
        read = "".join(f.read().splitlines()[1:4])
    (tmp_path / "r.fq").write_text(f"@a\n{read}\n+\n{'I' * len(read)}\n" * 2)
    samples = tmp_path / "anno.tsv"
    samples.write_text("name\tfasta\tgff\n"
                       f"g1\t{fa}/g1.fa\t{tmp_path}/g1.gff\n"
                       f"g2\t{fa}/g2.fa\t\ng3\t{fa}/g3.fa\t\n"
                       f"reads\t{tmp_path}/r.fq\t\n")
    anno = ["index", str(samples), "-k", str(K), "--device", "cpu",
            "--cores", "2"]
    code = (
        "import sys\n"
        "for m in ('jax', 'pandas', 'yaml', 'sklearn'): sys.modules[m] = None\n"
        "import torch; torch.set_num_threads(2)\n"
        "from panagram_tpu_torch.__main__ import main\n"
        f"main({args + ['--prefix', str(tmp_path / 'iso')]!r})\n"
        f"main({args + ['--prefix', str(tmp_path / 'iso_dd'), '--device-dict']!r})\n"
        f"main({anno + ['--prefix', str(tmp_path / 'iso_anno')]!r})\n"
        f"main(['annotate', {str(tmp_path / 'iso_anno')!r}, 'g3', "
        f"{str(tmp_path / 'g1.gff')!r}, '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'pandas', 'yaml', 'sklearn', 'panagram_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    # absolute FASTA paths in samples.tsv: the isolated build's files equal
    # the in-process ones, whatever the working directory
    assert_same_tree(str(tmp_path / "iso"), str(built["tmp"] / "port"))
    assert_same_tree(str(tmp_path / "iso_dd"), str(built_dd / "port_dd"))
    jax_build_index(str(samples), prefix=str(tmp_path / "jax_anno"), k=K,
                    cores=2)
    JaxIndex(str(tmp_path / "jax_anno"))["g3"].run_annotate(
        str(tmp_path / "g1.gff"))
    # g1 and g3 annotated (15 files each), g2 not (9)
    assert assert_same_trees(tmp_path / "iso_anno", tmp_path / "jax_anno") \
        == 3 + 5 + 15 + 9 + 15
