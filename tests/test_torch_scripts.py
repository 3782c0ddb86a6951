"""The port's user scripts (panagram_tpu_torch/scripts/) against the repo's
scripts/*.py, which drive panagram_tpu, on one small annotated tree.

The tree is tests/test_torch_annotate.py's fixture (three genomes of two
chromosomes with GFFs, a FASTQ sample, small UMAP bins) built by the port
on the CPU; it equals panagram_tpu's build file for file.  Each JAX script
runs in process (runpy, its sys.argv set) and each port script through its
``main(argv)``; their stdout must be equal byte for byte, and so must
plot_umaps' PNGs (matplotlib's Agg backend, same process).  write_umaps'
CSVs hold floats written by two formatters: their coordinates are held
within UMAP_ATOL, everything else exactly.
"""

import csv
import os
import runpy
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from panagram_tpu_torch.__main__ import frame_text
from panagram_tpu_torch.index import Table
from panagram_tpu_torch.pipeline import build_index
from panagram_tpu_torch.scripts import (
    make_bins_bits,
    pairwise_comp,
    pairwise_matrix,
    plot_umaps,
    query_index,
    write_umaps,
)
from panagram_tpu_torch.umap_embed import pca_fit
from tests.test_torch_annotate import umap_params, write_annotated_fixture

torch.set_num_threads(2)

K = 11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UMAP_ATOL = 1e-9


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scripts")
    samples = write_annotated_fixture(tmp)
    prefix = tmp / "idx"
    build_index(str(samples), prefix=str(prefix), k=K, device="cpu",
                **umap_params(False))
    return prefix


def run_both(monkeypatch, capsys, script, port_main, args, port_args=None,
             cwd=None):
    """(stdout of scripts/<script>.py, stdout of the port's main) for the
    same arguments; the port's may add its own (port_args)."""
    monkeypatch.setenv("COLUMNS", "80")
    monkeypatch.setattr(sys, "path", list(sys.path))
    if cwd:
        monkeypatch.chdir(cwd[0])
    monkeypatch.setattr(sys, "argv", [script] + args)
    runpy.run_path(os.path.join(REPO, "scripts", script), run_name="__main__")
    want = capsys.readouterr().out
    if cwd:
        monkeypatch.chdir(cwd[1])
    port_main(args + (port_args or []))
    return want, capsys.readouterr().out


@pytest.mark.parametrize("args", [["g1", "gene"], ["g2", "anno"],
                                  ["g3", "bit"], ["g1", "pattern"],
                                  ["g2", "gene", "chr2"], ["g1", "anno", "chr1"],
                                  ["g1", "other"]])
def test_query_index_prints_what_panagram_tpu_prints(tree, monkeypatch,
                                                     capsys, args):
    want, got = run_both(monkeypatch, capsys, "query_index.py",
                         query_index.main, [str(tree)] + args)
    assert got == want
    assert len(got.splitlines()) >= 1


@pytest.mark.parametrize("args", [["g1"], ["g2", "1"], ["g3", "2"]])
def test_make_bins_bits_prints_what_panagram_tpu_prints(tree, monkeypatch,
                                                        capsys, args):
    want, got = run_both(monkeypatch, capsys, "make_bins_bits.py",
                         make_bins_bits.main, [str(tree)] + args)
    assert got == want and len(got.splitlines()) > 2


@pytest.mark.parametrize("anchor", ["g1", "g2", "g3"])
def test_pairwise_comp_prints_what_panagram_tpu_prints(tree, monkeypatch,
                                                       capsys, anchor):
    want, got = run_both(monkeypatch, capsys, "pairwise_comp.py",
                         pairwise_comp.main, [anchor, str(tree)])
    assert got == want and len(got.splitlines()) == 4


def test_pairwise_matrix_prints_what_panagram_tpu_prints(tree, monkeypatch,
                                                         capsys):
    want, got = run_both(monkeypatch, capsys, "pairwise_matrix.py",
                         pairwise_matrix.main, [str(tree)],
                         ["--device", "cpu"])
    assert got == want and len(got.splitlines()) == 5


def _umap_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_write_umaps_writes_what_panagram_tpu_writes(tree, tmp_path,
                                                     monkeypatch, capsys):
    """On two copies of the tree: the same lines printed, and CSVs equal
    but the coordinates, which agree within UMAP_ATOL."""
    jax_tree, port_tree = tmp_path / "jax", tmp_path / "port"
    for d in (jax_tree, port_tree):
        shutil.copytree(tree, d)
        for g in ("g1", "g3"):
            for f in ("chrom_umaps.csv", "genome_umap.csv"):
                os.remove(d / "anchor" / g / f)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["write_umaps.py", str(jax_tree),
                                      "g1", "g3"])
    runpy.run_path(os.path.join(REPO, "scripts", "write_umaps.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    write_umaps.main([str(port_tree), "g1", "g3"])
    assert capsys.readouterr().out == want == "embedding g1 ...\nembedding g3 ...\n"
    for g in ("g1", "g3"):
        for f in ("chrom_umaps.csv", "genome_umap.csv"):
            a = _umap_rows(jax_tree / "anchor" / g / f)
            b = _umap_rows(port_tree / "anchor" / g / f)
            assert len(a) == len(b) > 2
            for ra, rb in zip(a[1:], b[1:]):
                assert ra[:3] + ra[5:] == rb[:3] + rb[5:]
                assert np.allclose(np.float64(ra[3:5]), np.float64(rb[3:5]),
                                   rtol=0, atol=UMAP_ATOL)
    # every anchor by default
    write_umaps.main([str(port_tree)])
    assert capsys.readouterr().out.split() == [
        w for g in ("g1", "g2", "g3") for w in ("embedding", g, "...")]


@pytest.mark.parametrize("args", [["g1", "chr1", "--bin-size", "300",
                                   "--step", "1"],
                                  ["g2", "ALL", "--bin-size", "400",
                                   "--step", "1", "--eps", "0.2"],
                                  ["g3", "ALL", "--bin-size", "500"]])
def test_plot_umaps_draws_what_panagram_tpu_draws(tree, tmp_path, monkeypatch,
                                                  capsys, args):
    """The same lines printed and byte-equal PNGs under the Agg backend."""
    dirs = (tmp_path / "jax", tmp_path / "port")
    for d in dirs:
        d.mkdir()
    want, got = run_both(monkeypatch, capsys, "plot_umaps.py",
                         plot_umaps.main, [str(tree)] + args + ["--out", "p"],
                         cwd=dirs)
    assert got == want
    names = sorted(os.listdir(dirs[0] / "p"))
    assert names == sorted(os.listdir(dirs[1] / "p"))
    with open(tree / "anchor" / args[0] / "chrs.tsv") as f:
        nchroms = len(f.readlines()) - 1
    assert len(names) == (4 if "ALL" in args and nchroms > 1 else 3)
    for n in names:
        assert (dirs[0] / "p" / n).read_bytes() == \
            (dirs[1] / "p" / n).read_bytes(), n


def test_plot_umaps_names_matplotlib_where_it_is_missing(tree, tmp_path,
                                                         monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for m in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, m, None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_umaps.main([str(tree), "g1", "ALL", "--bin-size", "500"])
    assert capsys.readouterr().out == "9 bins x 4 genomes\n"
    assert not (tmp_path / "umap_plots").exists()


def test_scripts_run_as_modules_without_jax_or_pandas(tree, tmp_path):
    """python -m panagram_tpu_torch.scripts.<name> starts, with jax, pandas
    and panagram_tpu blocked."""
    code = ("import runpy, sys\n"
            "for m in ('jax', 'pandas', 'panagram_tpu'): sys.modules[m] = None\n"
            "sys.argv = ['pairwise_matrix', sys.argv[1], '--device', 'cpu']\n"
            "runpy.run_module('panagram_tpu_torch.scripts.pairwise_matrix',"
            " run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    blocked = subprocess.run([sys.executable, "-c", code, str(tree)],
                             cwd=str(tmp_path), env=env, capture_output=True,
                             text=True, timeout=300)
    plain = subprocess.run([sys.executable, "-m",
                            "panagram_tpu_torch.scripts.make_bins_bits",
                            str(tree), "g1", "1"], cwd=str(tmp_path), env=env,
                           capture_output=True, text=True, timeout=300)
    assert blocked.returncode == 0, blocked.stderr[-2000:]
    assert plain.returncode == 0, plain.stderr[-2000:]
    assert blocked.stdout.splitlines()[0] == "\tg1\tg2\tg3\treads"
    assert plain.stdout.startswith("chr\tstart\tend\tunique\tuniversal\ttotal\n")


def _random_frame(rng, nrows, floats):
    cols = {"chr": [f"chr{rng.integers(1, 30)}" for _ in range(nrows)],
            "start": rng.integers(0, 10**7, nrows),
            "name": [("g" * rng.integers(1, 12)) + str(i) for i in range(nrows)],
            1: rng.integers(0, 1000, nrows)}
    if floats:
        f = rng.integers(0, 40, nrows).astype(float)
        f[rng.random(nrows) < 0.3] = np.nan
        if floats == "frac":
            f = f / 8
        cols["type_id"] = f
    return pd.DataFrame(cols)


@pytest.mark.parametrize("nrows", [0, 1, 7, 60, 61, 250])
@pytest.mark.parametrize("floats", [None, "ints", "frac"])
@pytest.mark.parametrize("columns", ["80", "30"])
def test_frame_text_prints_mixed_tables_as_pandas(monkeypatch, capsys, nrows,
                                                  floats, columns):
    """query_index's tables (str, int and float columns, NaNs, truncated
    rows and columns) as print(DataFrame) shows them."""
    monkeypatch.setenv("COLUMNS", columns)
    df = _random_frame(np.random.default_rng(nrows), nrows, floats)
    print(df)
    want = capsys.readouterr().out
    vals = np.empty(df.shape, object)
    for j, c in enumerate(df.columns):
        vals[:, j] = [v.item() if hasattr(v, "item") else v
                      for v in df[c].to_numpy()]
    assert frame_text(Table(vals, np.arange(nrows), list(df.columns))) \
        + "\n" == want


@pytest.mark.parametrize("shape,n", [((200, 4), 3), ((40, 30), 3),
                                     ((600, 700), 3), ((700, 600), 2),
                                     ((9, 3), 3)])
def test_pca_fit_explained_variance_matches_sklearn(shape, n):
    """Each solver scikit-learn picks (covariance_eigh, full, randomized)."""
    from sklearn.decomposition import PCA

    X = np.random.default_rng(shape[0]).random(shape)
    X[:, 0] *= 5
    pca = PCA(n_components=n, random_state=42)
    want = pca.fit_transform(X)
    got, ratio = pca_fit(X, n)
    assert np.allclose(got, want, rtol=0, atol=1e-9)
    assert np.allclose(ratio, pca.explained_variance_ratio_, rtol=1e-12,
                       atol=0)
