"""The port's index build against panagram_tpu's, byte for byte, on the CPU.

The 3-genome, 2-chromosome fixture of tests/test_index.py (k=11, an N
run in g3) without its GFF goes through both packages' build_index; every
file the port writes must equal panagram_tpu's.  Exact comparison
throughout (tolerance 0).
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch.__main__ import main as port_main
from panagram_tpu_torch.pipeline import build_index
from tests.conftest import random_seq

torch.set_num_threads(2)

K = 11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def assert_same_tree(port_dir, jax_dir, skip=()):
    """Every file under port_dir (but logs/) equals its twin under jax_dir:
    npz members array by array, everything else byte for byte."""
    n = 0
    for root, _, files in os.walk(port_dir):
        rel = os.path.relpath(root, port_dir)
        if rel.split(os.sep)[0] == "logs":
            continue
        for fn in files:
            p = os.path.join(root, fn)
            q = os.path.join(jax_dir, rel, fn)
            assert os.path.exists(q), q
            if fn.endswith(".npz"):
                a, b = np.load(p), np.load(q)
                assert a.files == b.files, p
                for f in a.files:
                    assert a[f].dtype == b[f].dtype, (p, f)
                    assert np.array_equal(a[f], b[f]), (p, f)
            else:
                assert filecmp.cmp(p, q, shallow=False), p
            n += 1
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
    n = assert_same_tree(str(tmp / "port"), str(tmp / "jax"))
    want = {"samples.tsv", "config.yaml", "genome_dist.tsv"}
    for g in ("g1", "g2", "g3"):
        want |= {f"anchor/{g}/{f}" for f in (
            "bitmap.1.gz", "bitmap.1.gzi", "bitmap.100.gz", "bitmap.100.gzi",
            "chrs.tsv", "bitsum.bins.tsv", "total_paircounts.csv")}
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
    for extra, word in ((["--device-dict"], "device-dict"),
                        (["--mesh", "2"], "mesh"),
                        (["--cores", "2"], "cores")):
        with pytest.raises(NotImplementedError, match=word):
            port_main(base + ["--prefix", str(tmp_path / word)] + extra)

    gff = tmp_path / "gff.tsv"
    gff.write_text("name\tfasta\tgff\n"
                   f"g1\t{samples.parent}/fastas/g1.fa\tg1.gff\n")
    with pytest.raises(NotImplementedError, match="GFF"):
        build_index(str(gff), prefix=str(tmp_path / "g"), device="cpu")
    fq = tmp_path / "fq.tsv"
    fq.write_text("name\tfasta\nr1\treads.fq.gz\n")
    with pytest.raises(NotImplementedError, match="FASTQ"):
        build_index(str(fq), prefix=str(tmp_path / "q"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_index(str(samples), prefix=str(tmp_path / "c"), device="cuda")


def test_runs_without_jax_pandas_yaml_sklearn(built, tmp_path):
    """The package imports and builds the fixture with jax, pandas, yaml
    and sklearn made unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'pandas', 'yaml', 'sklearn'): sys.modules[m] = None\n"
        "import torch; torch.set_num_threads(2)\n"
        "from panagram_tpu_torch.__main__ import main\n"
        f"main(['index', {str(built['samples'])!r}, '-k', '{K}', '--prefix', "
        f"{str(tmp_path / 'iso')!r}, '--device', 'cpu'])\n"
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
