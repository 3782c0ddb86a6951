"""The port's browser (view/plots.py, view/server.py, the ``view`` command)
against panagram_tpu's, on the CPU.

Two fixtures, each built by both packages: tests/test_view.py's three
genomes with a GFF on g0, and the annotated fixture of
tests/test_torch_annotate.py (three anchors with GFFs, a FASTQ read set,
small UMAP bins).  On each tree, whichever package built it, every figure
function of the port must give panagram_tpu's PNG bytes and click-through
map on the same arguments, and both servers every route's status, content
type and body, all with tolerance 0.  The ward linkage's row sample is
held to pandas' ``DataFrame.sample``.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pandas as pd
import pytest
import torch

from panagram_tpu.__main__ import _add_view as jax_add_view
from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu.view import plots as jax_plots
from panagram_tpu.view import server as jax_server
from panagram_tpu_torch.__main__ import _add_view
from panagram_tpu_torch.index import Index as PortIndex
from panagram_tpu_torch.pipeline import build_index
from panagram_tpu_torch.view import plots, server
from tests.conftest import random_seq
from tests.test_torch_annotate import umap_params, write_annotated_fixture

torch.set_num_threads(2)

K = 11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = ("jax", "port")


def write_view_fixture(tmp):
    """tests/test_view.py's three genomes (one base and two mutated copies
    of 2500 bp) with one gene on g0."""
    rng = np.random.default_rng(77)
    base = random_seq(rng, 2500)

    def mutate(seq, n):
        s = list(seq)
        for i in rng.choice(len(s), n, replace=False):
            s[i] = "ACGT"[rng.integers(4)]
        return "".join(s)

    fa = tmp / "fa"
    fa.mkdir()
    for i, seq in enumerate([base, mutate(base, 40), mutate(base, 80)]):
        (fa / f"g{i}.fa").write_text(f">chr1\n{seq}\n")
    gff = tmp / "g0.gff"
    gff.write_text("chr1\tsrc\tgene\t101\t700\t.\t+\t.\tID=gene1;Name=G1\n")
    samples = tmp / "samples.tsv"
    samples.write_text(
        "name\tfasta\tgff\n"
        f"g0\t{fa}/g0.fa\t{gff}\ng1\t{fa}/g1.fa\t\ng2\t{fa}/g2.fa\t\n")
    return samples


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{fixture: {tree: index dir}}: "view" and "anno", each built by
    panagram_tpu ("jax") and by the port ("port")."""
    tmp = tmp_path_factory.mktemp("torch_view")
    out = {}
    (tmp / "view").mkdir()
    samples = write_view_fixture(tmp / "view")
    out["view"] = {t: tmp / "view" / t for t in TREES}
    jax_build_index(str(samples), prefix=str(out["view"]["jax"]), k=K)
    build_index(str(samples), prefix=str(out["view"]["port"]), k=K,
                device="cpu")
    (tmp / "anno").mkdir()
    samples = write_annotated_fixture(tmp / "anno")
    out["anno"] = {t: tmp / "anno" / t for t in TREES}
    jax_build_index(str(samples), prefix=str(out["anno"]["jax"]), k=K,
                    **umap_params(True))
    build_index(str(samples), prefix=str(out["anno"]["port"]), k=K,
                device="cpu", **umap_params(False))
    return out


@pytest.fixture(scope="module", params=[(f, t) for f in ("view", "anno")
                                        for t in TREES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def opened(request, trees):
    """(port Index, panagram_tpu Index, fixture) on one tree."""
    fixture, tree = request.param
    d = str(trees[fixture][tree])
    port, ref = PortIndex(d), JaxIndex(d)
    yield port, ref, fixture
    port.close()
    ref.close()


def figure_calls(fixture):
    """(name, function name, args, kwargs) of every figure function on a fixture:
    tests/test_view.py's calls and more (each anchor, both chromosomes,
    the lowres route, collapse, type filters, an explicit order)."""
    if fixture == "view":
        anchors, chrom, types = ["g0", "g1", "g2"], "chr1", {"gene"}
    else:
        anchors, chrom, types = ["g1", "g2", "g3"], "chr1", {"exon"}
    calls = [(f, f, (), {}) for f in ("pangenome_composition",
                                      "genome_dendrogram",
                                      "chromosome_histograms",
                                      "genome_sizes_plot")]
    for g in anchors:
        calls += [(f"whole_genome_plot-{g}", "whole_genome_plot", (g,), {}),
                  (f"gene_content_plot-{g}", "gene_content_plot", (g,), {}),
                  (f"umap_scatter-{g}", "umap_scatter", (g,), {})]
    g = anchors[0]
    calls += [(f"umap_scatter-{chrom}", "umap_scatter", (g, chrom), {}),
              ("chr_whole_plot", "chr_whole_plot", (g, chrom), {}),
              ("chromosome_view", "chromosome_view", (g, chrom), {}),
              ("chromosome_view-last-anchor", "chromosome_view",
               (anchors[2], chrom), {})]
    g = anchors[0]
    calls += [
        ("chr_whole_plot-window", "chr_whole_plot", (g, chrom, 100, 2000), {}),
        ("chromosome_view-window", "chromosome_view",
         (g, chrom, 100, 2000), {}),
        ("chromosome_view-chr2", "chromosome_view", (g, "chr2"), {})
        if fixture == "anno" else
        ("chromosome_view-empty", "chromosome_view", (g, chrom, 900, 900), {}),
        ("chromosome_view-lowres", "chromosome_view",
         (g, chrom, 0, None, 10), {}),
        ("chromosome_view-types-none", "chromosome_view", (g, chrom),
         {"types": set()}),
        ("chromosome_view-types", "chromosome_view", (g, chrom),
         {"types": types}),
        ("chromosome_view-order", "chromosome_view", (g, chrom, 0, 1000),
         {"order_names": [anchors[2], "zz", anchors[0]]}),
    ]
    return calls


def collapse_calls(link_tree):
    """chromosome_view's collapse argument for the root and for every
    internal node."""
    out, stack = [], [link_tree]
    while stack:
        node = stack.pop()
        if "children" in node:
            out.append({node["id"]})
            stack += node["children"]
    return out


def assert_same_render(got, want):
    """PNG bytes (and the map, for the figures that return one) equal."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple)
        assert got[0][:8] == b"\x89PNG\r\n\x1a\n"
        assert json.dumps(got[1]) == json.dumps(want[1])
        assert got[0] == want[0]
    else:
        assert got[:8] == b"\x89PNG\r\n\x1a\n"
        assert got == want


N_CALLS = len(figure_calls("view"))


@pytest.mark.parametrize("case", range(N_CALLS),
                         ids=[c[0] for c in figure_calls("view")])
def test_figures_equal(opened, case):
    """Each call of figure_calls, by the port and by
    panagram_tpu on the same index."""
    port, ref, fixture = opened
    _, fn, args, kw = figure_calls(fixture)[case]
    assert_same_render(getattr(plots, fn)(port, *args, **kw),
                       getattr(jax_plots, fn)(ref, *args, **kw))


def test_figure_calls_cover_every_figure():
    """Both fixtures have N_CALLS calls, and they reach every figure function."""
    assert len(figure_calls("anno")) == N_CALLS
    called = {c[1] for c in figure_calls("anno")}
    assert called == {"pangenome_composition", "genome_dendrogram",
                      "chromosome_histograms", "genome_sizes_plot",
                      "whole_genome_plot", "gene_content_plot",
                      "umap_scatter", "chr_whole_plot", "chromosome_view"}


def test_chromosome_view_collapse(opened):
    """The linkage tree is drawn; collapsing the root merges every row into
    one ("[3 genomes]"), collapsing each other internal node merges its
    clade; each render equals panagram_tpu's."""
    port, ref, fixture = opened
    g = "g0" if fixture == "view" else "g1"
    tree = plots._linkage_tree(plots._chrom_linkage(
        port, g, "chr1", port.genomes[g].seq_len("chr1")),
        list(port.genome_names))
    assert "children" in tree
    cases = collapse_calls(tree)
    assert len(cases) == port.ngenomes - 1 and cases[0] == {tree["id"]}
    for collapse in cases:
        got = plots.chromosome_view(port, g, "chr1", 0, 1500,
                                    collapse=collapse)
        want = jax_plots.chromosome_view(ref, g, "chr1", 0, 1500,
                                         collapse=collapse)
        assert_same_render(got, want)
        assert got[1]["tree"] == tree
        if collapse == cases[0]:
            assert got[1]["labels"] == [f"[{port.ngenomes} genomes]"]


def test_chrom_linkage_equals_panagram_tpu(opened):
    """_chrom_linkage's sampled rows are pandas' DataFrame.sample(n,
    random_state=42) of the same bitmap, and its linkage panagram_tpu's."""
    port, ref, fixture = opened
    g = "g0" if fixture == "view" else "g1"
    plots._CHROM_LINK_CACHE.clear()
    jax_plots._CHROM_LINK_CACHE.clear()
    for chrom, size in port.genomes[g].sizes.items():
        got = plots._chrom_linkage(port, g, chrom, size)
        want = jax_plots._chrom_linkage(ref, g, chrom, size)
        assert (got is None) == (want is None)
        if want is not None:
            assert np.array_equal(got, want)
        bm = ref.query_bitmap(g, chrom, 0, size, port.lowres_step)
        locs = np.random.RandomState(42).choice(
            len(bm), size=min(len(bm), 50_000), replace=False)
        assert np.array_equal(bm.index.to_numpy()[locs],
                              bm.sample(n=min(len(bm), 50_000),
                                        random_state=42).index.to_numpy())


@pytest.mark.parametrize("rows", [1, 7, 49_999, 50_000, 50_001, 120_000])
def test_linkage_sample_equals_pandas_sample(rows):
    """The draw of _chrom_linkage against DataFrame.sample, below, at and
    above the 50,000-row cap, rows and their order."""
    df = pd.DataFrame(np.arange(rows * 3).reshape(rows, 3) % 7,
                      index=pd.RangeIndex(0, rows * 100, 100))
    want = df.sample(n=min(rows, 50_000), random_state=42)
    locs = np.random.RandomState(42).choice(
        rows, size=min(rows, 50_000), replace=False).astype(np.intp)
    assert np.array_equal(df.to_numpy()[locs], want.to_numpy())
    assert np.array_equal(df.index.to_numpy()[locs], want.index.to_numpy())


def serve_in_thread(handler, index, params):
    handler.index = index
    handler.params = params
    handler._cache = type(handler._cache)()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def routes(fixture):
    g, c = ("g0", "chr1") if fixture == "view" else ("g1", "chr1")
    return [
        "/", "/api/meta",
        f"/api/bitdump?genome={g}&chrom={c}&start=0&end=5",
        f"/api/bitdump?genome={g}&chrom={c}&start=100&end=1100",
        f"/api/bitdump?genome={g}&chrom={c}&end=2000&step=100",
        f"/api/bitdump?genome={g}&chrom={c}&start=7&end=7",
        f"/api/genes?genome={g}&chrom={c}&start=0&end=2000",
        f"/api/genes?genome={g}",
        f"/api/genes?genome={g}&q=a",
        f"/api/genes?genome={g}&chrom={c}&start=0&end=2000&q=zzz",
        f"/api/genes?genome={g}&chrom=chrX",
        f"/api/map/anchor/{g}",
        f"/api/map/chrom/{g}/{c}?start=100&end=900",
        f"/api/view/{g}/{c}?start=0&end=1000",
        "/plot/pangenome/composition.png", "/plot/pangenome/dendrogram.png",
        "/plot/pangenome/sizes.png", "/plot/pangenome/chr_hist.png",
        f"/plot/anchor/{g}/whole.png", f"/plot/anchor/{g}/umap.png",
        f"/plot/anchor/{g}/genes.png",
        f"/plot/chrom/{g}/{c}/whole.png?start=100&end=900",
        f"/plot/chrom/{g}/{c}/umap.png",
        f"/plot/chrom/{g}/{c}/view.png?start=0&end=1000",
        f"/plot/chrom/{g}/{c}/view.png?start=0&end=1000&types=gene",
        f"/plot/chrom/{g}/{c}/view.png?start=0&end=1000",   # cached
        "/nope", "/plot/pangenome/nope.png", "/api/genes?genome=zz",
        f"/api/view/{g}/chrX", f"/plot/anchor/{g}/nope.png",
    ]


@pytest.mark.parametrize("which", [("view", "jax"), ("view", "port"),
                                   ("anno", "port")],
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_servers_answer_alike(trees, which, tmp_path):
    """Both servers on ephemeral ports, the same params (bookmarks, an
    initial view): every route's status, content type and body equal;
    /api/view's tree drives a collapse request on both.  (The anno
    fixture's panagram_tpu tree differs from the port's only in its
    anno_types.txt order and its UMAP digits.)"""
    fixture = which[0]
    d = str(trees[fixture][which[1]])
    port_idx, ref = PortIndex(d), JaxIndex(d)
    bm = tmp_path / "b.bed"
    bm.write_text("chr1\t100\t200\tregion A\nchr1\t5\t50\n")
    params = {"max_chr_bins": 350, "order": None,
              "init": {"genome": "g1", "chrom": "chr1", "start": 3,
                       "end": 90},
              "bookmarks": server._load_bookmarks(str(bm))}
    assert params["bookmarks"] == jax_server._load_bookmarks(str(bm))
    a = serve_in_thread(server._Handler, port_idx, dict(params))
    b = serve_in_thread(jax_server._Handler, ref, dict(params))
    try:
        for path in routes(fixture):
            got, want = get(a.server_address[1], path), get(
                b.server_address[1], path)
            assert got[:2] == want[:2], path
            if want[0] != 500:
                # a 500's body is a traceback, of different files
                assert got[2] == want[2], path
        g = "g0" if fixture == "view" else "g1"
        view = json.loads(get(a.server_address[1],
                              f"/api/view/{g}/chr1?start=0&end=1000")[2])
        root = view["tree"]["id"]
        path = f"/api/view/{g}/chr1?start=0&end=1000&collapse={root}"
        got = get(a.server_address[1], path)
        assert got == get(b.server_address[1], path)
        assert json.loads(got[2])["labels"] == [f"[{ref.ngenomes} genomes]"]
    finally:
        for h in (a, b):
            h.shutdown()
            h.server_close()
        port_idx.close()
        ref.close()


def test_bitdump_route_is_the_bitmap(trees):
    """/api/bitdump's TSV: the header and one line per row of query_bitmap,
    at step 1 and 100."""
    idx = PortIndex(str(trees["view"]["port"]))
    for start, end, step in ((0, 5, 1), (37, 1337, 1), (0, 2490, 100)):
        t = idx.query_bitmap("g0", "chr1", start, end, step)
        lines = server.bitmap_tsv(t).splitlines()
        assert lines[0] == "\tg0\tg1\tg2"
        assert len(lines) == len(range(start, end, step)) + 1
        for line, p, row in zip(lines[1:], t.index, t.values):
            assert line.split("\t") == [str(p)] + [str(v) for v in row]
    idx.close()


def test_view_arguments_are_panagram_tpus():
    """The view subcommand's parser equals panagram_tpu's on the same
    argument lists."""
    def parse(add, argv):
        parser = argparse.ArgumentParser()
        add(parser.add_subparsers(dest="cmd"))
        return vars(parser.parse_args(argv))

    for argv in (["view", "idx"], ["view", "idx", "g1", "chr1", "5", "900",
                                   "--port", "9", "--host", "0.0.0.0",
                                   "--ndebug", "--max-chr-bins", "100",
                                   "--bookmarks", "b.bed", "--order", "g2",
                                   "g1"], ["view", "idx", "--order"]):
        assert parse(_add_view, argv) == parse(jax_add_view, argv)


def test_bookmarks(tmp_path):
    bed = tmp_path / "b.bed"
    bed.write_text("chr1\t100\t200\tregion A\nchr2\t5\t50\nshort\t1\n")
    bm = server._load_bookmarks(str(bed))
    assert bm == jax_server._load_bookmarks(str(bed))
    assert bm[0] == {"chrom": "chr1", "start": 100, "end": 200,
                     "name": "region A"}
    assert bm[1]["name"] is None and len(bm) == 2
    assert server._load_bookmarks(None) == []


def test_view_serves_without_matplotlib_pandas_jax(trees, tmp_path):
    """With jax, pandas, yaml, matplotlib and panagram_tpu unimportable, the
    server answers /api/meta, /api/genes and /api/bitdump as in process,
    and a PNG route answers 500 with an error that names matplotlib."""
    d = str(trees["anno"]["jax"])
    code = (
        "import sys, threading, urllib.request, urllib.error, json\n"
        "for m in ('jax', 'pandas', 'yaml', 'matplotlib', 'panagram_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from http.server import ThreadingHTTPServer\n"
        "from panagram_tpu_torch.index import Index\n"
        "from panagram_tpu_torch.view.server import _Handler\n"
        f"_Handler.index = Index({d!r})\n"
        "_Handler.params = {'init': {}, 'bookmarks': []}\n"
        "h = ThreadingHTTPServer(('127.0.0.1', 0), _Handler)\n"
        "threading.Thread(target=h.serve_forever, daemon=True).start()\n"
        "def get(p):\n"
        "    try:\n"
        "        r = urllib.request.urlopen(\n"
        "            f'http://127.0.0.1:{h.server_address[1]}{p}')\n"
        "        return r.status, r.read().decode()\n"
        "    except urllib.error.HTTPError as e:\n"
        "        return e.code, e.read().decode()\n"
        "out = {p: get(p) for p in ('/api/meta', '/api/genes?genome=g1',\n"
        "    '/api/bitdump?genome=g1&chrom=chr1&start=90&end=130',\n"
        "    '/plot/chrom/g1/chr1/view.png', '/plot/pangenome/sizes.png')}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pandas',\n"
        "    'yaml', 'matplotlib', 'panagram_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    ref = JaxIndex(d)
    assert out["/api/meta"][0] == 200
    meta = json.loads(out["/api/meta"][1])
    assert meta["anchors"] == ["g1", "g2", "g3"]
    assert meta["sizes"]["g1"] == {c: int(s) for c, s in
                                   ref.genomes["g1"].sizes.items()}
    genes = json.loads(out["/api/genes?genome=g1"][1])
    assert [x["name"] for x in genes] == list(ref.query_genes("g1")["name"])
    tsv = out["/api/bitdump?genome=g1&chrom=chr1&start=90&end=130"]
    assert tsv == [200, ref.query_bitmap("g1", "chr1", 90, 130).to_csv(
        sep="\t")]
    for p in ("/plot/chrom/g1/chr1/view.png", "/plot/pangenome/sizes.png"):
        assert out[p][0] == 500 and "matplotlib" in out[p][1], out[p]
    ref.close()
