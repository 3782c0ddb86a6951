"""The port's shell wrappers against panagram_tpu's, on the CPU.

* ``panagram_tpu_torch/scripts/preprocess.sh`` and panagram_tpu's
  ``scripts/preprocess.sh`` on the 3-genome fixture with GFFs: the same
  tree, file for file (tests/test_torch_index.py's assert_same_trees).
* ``panagram_tpu_torch/scripts/run_umaps.sh`` on a port tree whose
  chromosomes hold several of plot_umaps' 100-kbp bins: the CSVs equal the
  build's, a plot per chromosome and ALL, each sample's shared-kmer
  percentages as panagram_tpu's pairwise_comp prints them; without
  matplotlib it stops at plot_umaps, naming it, after the CSVs.
* ``panagram_tpu_torch/examples/run_example.sh`` whole, on the CPU: every
  file the introgression caller writes (the figures aside) equals what
  panagram_tpu's runner writes from the same index and config.

Every comparison is exact (tolerance 0), but the UMAP coordinates
(assert_same_file's rule) and the figures, which are not compared.
"""

import io
import os
import runpy
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import yaml

from panagram_tpu.intros import runner as jax_runner
from panagram_tpu_torch.pipeline import build_index
from tests.conftest import random_seq
from tests.test_torch_annotate import G1_GFF, G2_GFF, G3_GFF
from tests.test_torch_index import assert_same_file, assert_same_trees
from tests.test_torch_index import write_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "panagram_tpu_torch")
K = 11
FIGURES = (".png", ".svg", ".pdf")


def _env(**extra):
    return {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", **extra}


def _run(args, cwd, timeout=600, **env):
    r = subprocess.run(["bash", *args], cwd=str(cwd), env=_env(**env),
                       capture_output=True, text=True, timeout=timeout)
    return r


@pytest.fixture(scope="module")
def pre(tmp_path_factory):
    """preprocess.sh of both packages on the fixture with a gff column."""
    tmp = tmp_path_factory.mktemp("wrappers")
    write_fixture(tmp, np.random.default_rng(1234))
    fa = tmp / "fastas"
    for g, text in (("g1", G1_GFF), ("g2", G2_GFF), ("g3", G3_GFF)):
        (fa / f"{g}.gff").write_text(text)
    samples = tmp / "samples.tsv"
    samples.write_text("name\tfasta\tgff\n" + "".join(
        f"{g}\tfastas/{g}.fa\tfastas/{g}.gff\n" for g in ("g1", "g2", "g3")))
    jax = _run([os.path.join(REPO, "scripts", "preprocess.sh"),
                str(samples), str(K), str(tmp / "jax"), "1"], tmp)
    port = _run([os.path.join(PORT, "scripts", "preprocess.sh"),
                 str(samples), str(K), str(tmp / "port"), "1", "cpu"], tmp)
    return dict(tmp=tmp, jax=jax, port=port)


def test_preprocess_sh_builds_panagram_tpus_tree(pre):
    assert pre["jax"].returncode == 0, pre["jax"].stderr[-3000:]
    assert pre["port"].returncode == 0, pre["port"].stderr[-3000:]
    assert pre["port"].stdout.splitlines()[-1] == \
        f"preprocess: index ready at {pre['tmp'] / 'port'}"
    n = assert_same_trees(pre["tmp"] / "port", pre["tmp"] / "jax")
    assert n > 20
    for g in ("g1", "g2"):
        assert (pre["tmp"] / "port" / "anchor" / g / "gene.bed.gz").exists()


def test_preprocess_sh_defaults_to_the_card(pre, tmp_path):
    """Without a device argument the build asks for the card; here, with
    none, it stops naming it."""
    r = _run([os.path.join(PORT, "scripts", "preprocess.sh"),
              str(pre["tmp"] / "samples.tsv"), str(K), str(tmp_path / "x")],
             pre["tmp"], CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr


def _pairwise_comp_text(name, tree):
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["pairwise_comp.py", name, str(tree)]
    try:
        with redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, "scripts", "pairwise_comp.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    return out.getvalue()


@pytest.fixture(scope="module")
def umaps_tree(tmp_path_factory):
    """Three genomes of two chromosomes (500 and 400 kbp; 1% and 2% of
    sites changed in g2 and g3), built by the port."""
    tmp = tmp_path_factory.mktemp("umaps")
    rng = np.random.default_rng(5)
    base = {"chr1": random_seq(rng, 500_000), "chr2": random_seq(rng, 400_000)}
    rows = []
    for g, frac in (("g1", 0.0), ("g2", 0.01), ("g3", 0.02)):
        with open(tmp / f"{g}.fa", "w") as f:
            for c, seq in base.items():
                s = np.array(list(seq))
                hit = rng.random(len(s)) < frac
                s[hit] = rng.choice(list("ACGT"), hit.sum())
                f.write(f">{c}\n{''.join(s)}\n")
        rows.append(f"{g}\t{tmp / g}.fa\n")
    (tmp / "samples.tsv").write_text("name\tfasta\n" + "".join(rows))
    build_index(str(tmp / "samples.tsv"), prefix=str(tmp / "idx"), k=K,
                device="cpu")
    return tmp / "idx"


def test_run_umaps_sh(umaps_tree, tmp_path):
    tree = tmp_path / "port"
    shutil.copytree(umaps_tree, tree)
    d = tree / "anchor" / "g1"
    built = {f: (d / f).read_bytes() for f in ("chrom_umaps.csv",
                                               "genome_umap.csv")}
    for f in built:
        (d / f).unlink()
    r = _run([os.path.join(PORT, "scripts", "run_umaps.sh"), str(tree), "g1",
              str(tmp_path / "plots")], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    for f, data in built.items():
        assert (d / f).read_bytes() == data, f
    assert [ln for ln in r.stdout.splitlines() if ln.startswith("plotting")] \
        == ["plotting g1/chr1", "plotting g1/chr2", "plotting g1/ALL"]
    assert list((tmp_path / "plots").rglob("*.png"))
    for g in ("g1", "g2", "g3"):
        got = (tree / "anchor" / g / f"perc_shared.{g}.txt").read_text()
        assert got == _pairwise_comp_text(g, tree), g


def test_run_umaps_sh_stops_at_plot_umaps_without_matplotlib(umaps_tree,
                                                            tmp_path):
    """set -euo pipefail: the CSVs are written, then plot_umaps fails
    naming matplotlib and nothing after it runs."""
    tree = tmp_path / "port"
    shutil.copytree(umaps_tree, tree)
    (tree / "anchor" / "g1" / "chrom_umaps.csv").unlink()
    block = tmp_path / "block" / "matplotlib"
    block.mkdir(parents=True)
    (block / "__init__.py").write_text(
        "raise ImportError('No module named matplotlib')\n")
    r = _run([os.path.join(PORT, "scripts", "run_umaps.sh"), str(tree), "g1"],
             tmp_path, PYTHONPATH=f"{tmp_path / 'block'}{os.pathsep}{REPO}")
    assert r.returncode != 0
    assert "matplotlib" in r.stderr
    assert (tree / "anchor" / "g1" / "chrom_umaps.csv").exists()
    assert not list(tree.glob("anchor/*/perc_shared.*.txt"))


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p for p in sorted(d.rglob("*"))
            if p.is_file()}


def test_run_example_sh_calls_what_panagram_tpu_calls(tmp_path):
    """The port's example, whole, on the CPU; then panagram_tpu's runner
    on the index it built, with its config, into a directory of the same
    name: the same calls, postprocessed calls, scores and metrics."""
    work = tmp_path / "work"
    r = _run([os.path.join(PORT, "examples", "run_example.sh"), str(work),
              "cpu"], tmp_path, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    metrics = sorted(work.glob(
        "introgressions/2way_calls/*_0.8/scored/metrics_*.tsv"))
    assert metrics and r.stdout.rstrip().splitlines()[-2] == \
        metrics[0].read_text().rstrip().splitlines()[-1]
    cfg = yaml.safe_load((work / "2way_config.yaml").read_text())
    out = tmp_path / "jax" / "2way_calls"
    cfg["general"]["output_dir"] = str(out)
    path = tmp_path / "jax.yaml"
    path.write_text(yaml.dump(cfg))
    jax_runner.run_introgression_pipeline(jax_runner.parse_config(path))
    got = {k: v for k, v in _files(work / "introgressions" / "2way_calls")
           .items() if not k.endswith(FIGURES)}
    want = {k: v for k, v in _files(out).items()
            if not k.endswith(FIGURES)}
    assert sorted(got) == sorted(want) and len(got) > 3
    for k in got:
        assert_same_file(str(got[k]), str(want[k]))
