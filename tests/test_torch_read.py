"""The port's read path (read-mode Index, its queries and tables, bitdump,
the CSI tabix reader) against panagram_tpu's on the CPU.

Two fixtures, each built by both packages: the annotated 3-genome index of
tests/test_torch_annotate.py (two chromosomes, GFFs, a FASTQ read set,
small UMAP bins) and 34 genomes of two chromosomes (two mask words, 5
bitmap bytes per position).  On each tree, whichever package built it,
``panagram_tpu_torch.index.Index`` must give the values and labels of
``panagram_tpu.index.Index``: each Table's values equal the DataFrame's
``.to_numpy()`` exactly (NaN equal to NaN), its labels ``.index`` and
``.columns``.  Two exceptions: pandas' sort_values is not stable, so the
rows of the ``*_avg`` Series that tie are compared as sets; and the floats
read back from CSV text (total_paircounts' frac, the UMAP coordinates) are
held within TEXT_ATOL: pandas' default parser (xstrtod) keeps about 17
digits after the decimal point and is not correctly rounded, the port's
(Python's float) is.  ``bitdump``
output must equal panagram_tpu's byte for byte.
"""

import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from panagram_tpu.__main__ import main as jax_main
from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.io import tabix as jax_tabix
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch.__main__ import main as port_main
from panagram_tpu_torch.index import Index as PortIndex
from panagram_tpu_torch.index import Table
from panagram_tpu_torch.io import tabix
from panagram_tpu_torch.io.bgzf import decompress_file
from panagram_tpu_torch.pipeline import build_index
from tests.conftest import random_seq
from tests.test_torch_annotate import NEW_GFF, umap_params, write_annotated_fixture

torch.set_num_threads(2)

K = 11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = ("jax", "port")
W2_GENOMES, W2_ANCHORS = 34, ["g00", "g17", "g33"]
TEXT_ATOL = 1e-15
# tables holding floats parsed from CSV text
TEXT_TABLES = ("total_paircounts", "chrom_umaps", "genome_umap")


def same_value(a, b, atol=0.0) -> bool:
    if isinstance(a, (float, np.floating)) and isinstance(b, (float, np.floating)):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return abs(a - b) <= atol
    return a == b


def assert_table(t: Table, want, tied=False, atol=0.0):
    """A port Table against panagram_tpu's DataFrame or Series; floats
    within `atol`."""
    assert isinstance(t, Table)
    got, exp = np.asarray(t.values), want.to_numpy()
    assert got.shape == exp.shape, (got.shape, exp.shape)
    if isinstance(want, pd.DataFrame):
        assert list(t.columns) == list(want.columns)
    else:
        assert t.columns is None
    if tied:
        # ascending values; each run of equal values holds the same labels
        assert np.array_equal(got, exp)
        runs, wruns = {}, {}
        for v, label in zip(got, t.index):
            runs.setdefault(v, set()).add(label)
        for v, label in zip(exp, want.index):
            wruns.setdefault(v, set()).add(label)
        assert runs == wruns
        return
    assert list(t.index) == list(want.index)
    if got.dtype == object or exp.dtype == object:
        assert got.dtype == exp.dtype == object
        for a, b in zip(got.ravel(), exp.ravel()):
            assert same_value(a, b, atol), (a, b)
    else:
        assert got.dtype.kind == exp.dtype.kind, (got.dtype, exp.dtype)
        if got.dtype.kind == "f" and atol:
            assert all(same_value(a, b, atol)
                       for a, b in zip(got.ravel(), exp.ravel()))
        else:
            assert np.array_equal(got, exp, equal_nan=got.dtype.kind == "f")


def write_w2(tmp):
    """34 genomes of two chromosomes (1200 and 700 bp): one base with
    10 + g point changes each and an N run in g17."""
    rng = np.random.default_rng(34)
    bases = [random_seq(rng, 1200), random_seq(rng, 700)]
    fa = tmp / "fa"
    fa.mkdir()
    names = [f"g{g:02d}" for g in range(W2_GENOMES)]
    for g, name in enumerate(names):
        with open(fa / f"{name}.fa", "w") as f:
            for c, base in enumerate(bases):
                s = list(base)
                for i in rng.choice(len(s), 10 + g, replace=False):
                    s[i] = "ACGT"[rng.integers(4)]
                if g == 17 and c == 0:
                    s[300:310] = "N" * 10
                f.write(f">chr{c + 1}\n" + "".join(s) + "\n")
    samples = tmp / "samples.tsv"
    samples.write_text("name\tfasta\n" + "".join(
        f"{n}\t{fa}/{n}.fa\n" for n in names))
    return samples


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{fixture: {tree: index dir}} for the annotated 3-genome fixture
    ("anno") and the 34-genome one ("w2"), each built by panagram_tpu
    ("jax") and by the port ("port")."""
    tmp = tmp_path_factory.mktemp("read")
    samples = write_annotated_fixture(tmp)
    out = {"anno": {t: tmp / t for t in TREES},
           "w2": {t: tmp / f"w2_{t}" for t in TREES}}
    jax_build_index(str(samples), prefix=str(out["anno"]["jax"]), k=K,
                    **umap_params(True))
    build_index(str(samples), prefix=str(out["anno"]["port"]), k=K,
                device="cpu", **umap_params(False))
    w2 = tmp / "w2"
    w2.mkdir()
    samples = write_w2(w2)
    jax_build_index(str(samples), prefix=str(out["w2"]["jax"]), k=K,
                    anchor_genomes=W2_ANCHORS)
    build_index(str(samples), prefix=str(out["w2"]["port"]), k=K,
                anchor_genomes=W2_ANCHORS, device="cpu")
    return out


@pytest.fixture(scope="module", params=[(f, t) for f in ("anno", "w2")
                                        for t in TREES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def opened(request, trees):
    """(port Index, panagram_tpu Index, dir) on one tree, read mode."""
    fixture, tree = request.param
    d = str(trees[fixture][tree])
    port, ref = PortIndex(d), JaxIndex(d)
    yield port, ref, d
    port.close()
    ref.close()


def windows(ref):
    """Query windows of every anchor: test_index.py's, whole chromosomes
    at steps 1 / 100 / 200 / 300, and each chromosome's last rows."""
    out = []
    for g in ref.anchor_genomes:
        sizes = ref.genomes[g].sizes
        for chrom, size in sizes.items():
            out += [(g, chrom, None, None, 1), (g, chrom, 0, int(size), 100),
                    (g, chrom, 0, int(size) - 7, 200),
                    (g, chrom, 3, None, 300), (g, chrom, 7, 399, 1),
                    (g, chrom, int(size) - 5, int(size), 1),
                    (g, chrom, 100, 101, 1)]
    return out


def test_read_mode_rule(trees, tmp_path):
    """A directory opens for reading, a samples file or mode="w" for
    writing; the refusals are panagram_tpu's."""
    d = str(trees["anno"]["port"])
    assert not PortIndex(d).write_mode
    w = PortIndex(d, mode="w")
    assert w.write_mode and w.chrs is None
    assert w.genomes["g1"].bitmaps is None
    with pytest.raises(ValueError, match="directory in mode='r'"):
        PortIndex(str(tmp_path / "nothing"))
    with pytest.raises(ValueError, match="not initialized"):
        PortIndex(str(tmp_path), mode="w")


def test_query_bitmap(opened):
    """Every window of windows() at every step, labels included."""
    port, ref, _ = opened
    n = 0
    for args in windows(ref):
        got, want = port.query_bitmap(*args), ref.query_bitmap(*args)
        assert got.values.dtype == np.uint8
        assert_table(got, want)
        n += len(got.index)
    assert n > 0


def test_query_bitmap_equals_the_bitmap_file(opened):
    """Step 1 of each chromosome, concatenated, is the decompressed
    bitmap.1.gz; step 100 the rows of bitmap.100.gz."""
    port, _, d = opened
    for name in port.anchor_genomes:
        g = port.genomes[name]
        for step in g.steps:
            rows = [g.query_rows(c[0], step=step)[1] for c in g.chrs]
            raw = decompress_file(os.path.join(d, "anchor", name,
                                               f"bitmap.{step}.gz"))
            assert np.concatenate(rows).tobytes() == raw


def test_query_genes_and_anno(opened):
    port, ref, _ = opened
    for g in ref.genomes:
        if ref.genomes[g].chrs is None:
            continue
        chroms = list(ref.genomes[g].sizes.index) + ["chrX"]
        for chrom in chroms:
            for start, end in ((0, 3000), (150, 200), (950, 960), (0, 10)):
                assert_table(port.query_genes(g, chrom, start, end),
                             ref.query_genes(g, chrom, start, end))
                assert_table(port.query_anno(g, chrom, start, end),
                             ref.query_anno(g, chrom, start, end))
        assert_table(port.query_genes(g), ref.query_genes(g))


def test_query_genes_and_anno_values(trees):
    """tests/test_index.py's checks of GeneA and the annotation types, on
    the port's reader."""
    idx = PortIndex(str(trees["anno"]["port"]))
    genes = idx.query_genes("g1", "chr1", 0, 3000)
    assert genes.values.shape[0] == 1
    row = dict(zip(genes.columns, genes.values[0]))
    assert row["name"] == "GeneA" and (row["start"], row["end"]) == (101, 400)
    bits = idx.query_bitmap("g1", "chr1", 101, 400).values
    hist = np.bincount(bits.sum(axis=1, dtype=np.int64),
                       minlength=idx.ngenomes + 1)
    assert (row[1], row[idx.ngenomes]) == (hist[1], hist[idx.ngenomes])
    anno = idx.query_anno("g1", "chr1", 0, 3000)
    col = {c: anno.values[:, i] for i, c in enumerate(anno.columns)}
    assert set(col["type"]) == {"exon", "mRNA"}
    assert set(col["name"][col["type"] == "exon"]) == {"GeneA"}
    ids = idx.genomes["g1"].anno_type_ids
    assert ids["exon"] == 0 and list(col["type_id"]) == [ids[t] for t in col["type"]]
    assert list(idx.query_genes("g1", "chr2", 0, 1500).values[:, 3]) == ["gene2"]
    assert idx.query_genes("g1", "chrX", 0, 10).values.shape == (0, 6)
    idx.close()


def test_read_api_members(opened):
    """Genome.sizes (chrs.tsv order), seq_len, chrs_table (panagram_tpu's
    read-mode chrs) and id; Index.genomes, conf and lowres_step."""
    port, ref, _ = opened
    assert list(port.genomes) == list(ref.genomes)
    assert port.lowres_step == ref.lowres_step == port.conf.lowres_step \
        == ref.conf.lowres_step
    assert port.conf.max_view_chrs == ref.conf.max_view_chrs
    for g in ref.genomes:
        p, r = port.genomes[g], ref.genomes[g]
        assert p.id == r.id
        if r.chrs is None:
            assert p.chrs is None
            continue
        assert list(p.sizes.items()) == [(c, int(s))
                                          for c, s in r.sizes.items()]
        for c in r.sizes.index:
            assert p.seq_len(c) == r.seq_len(c)
        assert_table(p.chrs_table, r.chrs)
    with pytest.raises(KeyError):
        port.genomes[ref.anchor_genomes[0]].seq_len("chrX")


GENOME_TABLES = ["bitsum_bins", "bitsum_chrs", "bitsum_total", "bitfreq_bins",
                 "bitfreq_chrs", "bitsum_genes", "bitfreq_genes",
                 "total_paircounts", "chrom_umaps", "genome_umap"]


@pytest.mark.parametrize("attr", GENOME_TABLES)
def test_genome_tables(opened, attr):
    port, ref, _ = opened
    for g in ref.anchor_genomes:
        want = getattr(ref.genomes[g], attr)
        if want is None:
            assert getattr(port.genomes[g], attr) is None
        else:
            assert_table(getattr(port.genomes[g], attr), want,
                         atol=TEXT_ATOL if attr in TEXT_TABLES else 0.0)


def test_genome_annotation_state(opened):
    port, ref, _ = opened
    for g in ref.genomes:
        p, r = port.genomes[g], ref.genomes[g]
        assert (p.chrs is None) == (r.chrs is None)
        if r.chrs is None:
            continue
        assert p.annotated == r.annotated
        assert p.gff_anno_types == r.gff_anno_types
        assert (p.anno_type_ids is None) == (r.anno_type_ids is None)
        if r.anno_type_ids is not None:
            assert p.anno_type_ids == r.anno_type_ids.to_dict()
            assert list(p.anno_type_ids) == list(r.anno_type_ids.index)


INDEX_TABLES = ["chrs", "bitsum_bins", "bitsum_chrs", "bitfreq_chrs",
                "bitsum_totals", "bitfreq_totals", "genome_sizes"]


@pytest.mark.parametrize("attr", INDEX_TABLES)
def test_index_tables(opened, attr):
    port, ref, _ = opened
    assert_table(getattr(port, attr), getattr(ref, attr))


@pytest.mark.parametrize("attr", ["bitsum_totals_avg", "bitsum_chrs_avg"])
def test_index_mean_occupancy(opened, attr):
    port, ref, _ = opened
    assert_table(getattr(port, attr), getattr(ref, attr), tied=True)


def test_index_read_aggregates(trees):
    """tests/test_index.py's aggregate checks, on the port's reader."""
    idx = PortIndex(str(trees["anno"]["port"]))
    sizes = dict(zip(idx.genome_sizes.index, idx.genome_sizes.values))
    assert sizes["g1"][0] == (3000 - K + 1) + (1500 - K + 1)
    assert sizes["g3"][1] == 1
    assert (idx.bitsum_totals.values.sum(axis=1) > 0).all()
    assert np.allclose(idx.bitfreq_totals.values.sum(axis=1), 1.0)
    assert idx.ngenomes == 4 and set(idx.anchor_genomes) == {"g1", "g2", "g3"}
    idx.close()


@pytest.mark.parametrize("binlen", [1, 300, 500, 2000])
def test_bitmap_and_pancount_bins(opened, binlen):
    port, ref, _ = opened
    for g in ref.anchor_genomes:
        chrom = ref.genomes[g].sizes.index[0]
        for start, end in ((0, 1000), (17, None)):
            bm, wbm = (port.query_bitmap(g, chrom, start, end),
                       ref.query_bitmap(g, chrom, start, end))
            for got, want in zip(port.bitmap_to_bins(bm, binlen),
                                 ref.bitmap_to_bins(wbm, binlen)):
                assert_table(got, want)
            pc = port.bitmap_to_pancount(bm)
            assert_table(pc, ref.bitmap_to_pancount(wbm))
            assert_table(port.pancount_to_bins(pc, binlen),
                         ref.pancount_to_bins(ref.bitmap_to_pancount(wbm),
                                              binlen))


def test_bitsum_count(opened):
    port, ref, _ = opened
    rng = np.random.default_rng(3)
    for occs in (rng.integers(1, ref.ngenomes + 1, 500), np.arange(1, 4),
                 np.array([ref.ngenomes] * 3)):
        got, want = port.bitsum_count(occs), ref.bitsum_count(occs)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("tree", TREES)
def test_annotate_then_read(trees, tree, tmp_path):
    """tests/test_index.py's annotate check: the port's annotate on a copy
    of the tree, then both readers; and panagram_tpu's run_annotate on
    another copy, read by the port."""
    gff = tmp_path / "new.gff"
    gff.write_text(NEW_GFF)
    for d in ("by_port", "by_jax"):
        shutil.copytree(trees["anno"][tree], tmp_path / d)
    port_main(["annotate", str(tmp_path / "by_port"), "g2", str(gff),
               "--device", "cpu"])
    ref = JaxIndex(str(tmp_path / "by_jax"))
    ref["g2"].run_annotate(str(gff))
    ref.close()
    for d in ("by_port", "by_jax"):
        port, ref = PortIndex(str(tmp_path / d)), JaxIndex(str(tmp_path / d))
        for chrom in ("chr1", "chr2", "chr3"):
            assert_table(port.query_genes("g2", chrom, 0, 3000),
                         ref.query_genes("g2", chrom, 0, 3000))
            assert_table(port.query_anno("g2", chrom, 0, 3000),
                         ref.query_anno("g2", chrom, 0, 3000))
        assert_table(port.genomes["g2"].bitsum_genes,
                     ref.genomes["g2"].bitsum_genes)
        genes = port.query_genes("g2", "chr1", 0, 3000)
        assert list(genes.values[:, 3]) == ["NewGene", "geneX2", "geneEnd"]
        port.close()
        ref.close()


def bitdump_text(main, capsys, args) -> str:
    capsys.readouterr()
    main(["bitdump", *[str(a) for a in args]])
    return capsys.readouterr().out


@pytest.mark.parametrize("window", [
    ("g1", "chr1", 100, 140), ("g1", "chr1", 100, 300),
    ("g2", "chr2", None, None, 100), ("g3", "chr1", 1390, 1430),
    ("g1", "chr2", 5, 5)], ids=["40rows", "200rows", "step100", "nrun",
                                 "empty"])
@pytest.mark.parametrize("verbose", [False, True], ids=["table", "v"])
@pytest.mark.parametrize("tree", TREES)
def test_bitdump(trees, tree, window, verbose, capsys, monkeypatch):
    monkeypatch.setenv("COLUMNS", "80")
    d = trees["anno"][tree]
    args = [d] + [a for a in window if a is not None] + (
        ["-v"] if verbose else [])
    if window[2] is None:     # positional step after the whole chromosome
        args = [d, window[0], window[1], 0, 1500 - K + 1, window[4]] + (
            ["-v"] if verbose else [])
    want = bitdump_text(jax_main, capsys, args)
    assert bitdump_text(port_main, capsys, args) == want
    assert want


@pytest.mark.parametrize("columns", ["80", "200"])
@pytest.mark.parametrize("window", [("g17", "chr1", 280, 330),
                                   ("g00", "chr2", 0, 690)])
def test_bitdump_34_genomes(trees, window, columns, capsys, monkeypatch):
    """34 genome columns: pandas elides the middle ones to the width."""
    monkeypatch.setenv("COLUMNS", columns)
    for tree in TREES:
        args = [trees["w2"][tree], *window]
        want = bitdump_text(jax_main, capsys, args)
        assert bitdump_text(port_main, capsys, args) == want
        assert bitdump_text(port_main, capsys, args + ["-v"]) == \
            bitdump_text(jax_main, capsys, args + ["-v"])


@pytest.mark.parametrize("ncols", [1, 3, 20, 21, 34, 81, 250])
@pytest.mark.parametrize("columns", ["80", "120", "40", "10"])
def test_frame_text_equals_pandas(ncols, columns, monkeypatch):
    """frame_text against print(DataFrame) of the same table: rows 0, 1,
    40, 60, 61 and 200 (step 1 and 100, starts with 2 to 6 digits), short
    and long genome names, named columns as bitdump prints them."""
    import contextlib
    import io

    from panagram_tpu_torch.__main__ import frame_text

    monkeypatch.setenv("COLUMNS", columns)
    rng = np.random.default_rng(ncols)
    for nrows, start, step in ((0, 5, 1), (1, 0, 1), (40, 95, 1),
                               (60, 0, 1), (61, 99_990, 100),
                               (200, 100, 1)):
        for names in ([f"g{i}" for i in range(ncols)],
                      [f"genome_{i:03d}x" for i in range(ncols)]):
            v = rng.integers(0, 2, (nrows, ncols)).astype(np.uint8)
            df = pd.DataFrame(v, index=pd.RangeIndex(start, start + nrows * step,
                                                     step),
                              columns=pd.Index(names, name="name"))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                print(df)
            got = frame_text(Table(v, np.arange(start, start + nrows * step,
                                                step), names), "name")
            assert got + "\n" == buf.getvalue(), (nrows, ncols, columns)


def test_read_path_imports_no_jax_pandas(trees, tmp_path):
    """With jax, pandas and panagram_tpu unimportable, an index opens, its
    queries run and bitdump prints what it prints in process."""
    d = str(trees["anno"]["jax"])
    code = (
        "import sys\n"
        "for m in ('jax', 'pandas', 'panagram_tpu'): sys.modules[m] = None\n"
        "from panagram_tpu_torch.index import Index\n"
        "from panagram_tpu_torch.__main__ import main\n"
        f"idx = Index({d!r})\n"
        "assert idx.query_genes('g1', 'chr1', 0, 3000).values.shape == (1, 6)\n"
        "assert idx.bitsum_totals.values.shape == (3, 5)\n"
        "idx.close()\n"
        f"main(['bitdump', {d!r}, 'g1', 'chr1', '100', '300'])\n"
        f"main(['bitdump', {d!r}, 'g1', 'chr1', '100', '140', '-v'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'pandas', 'panagram_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO, COLUMNS="80")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    idx = JaxIndex(d)
    want = str(idx.query_bitmap("g1", "chr1", 100, 300)) + "\n"
    want += " ".join(idx.genomes) + "\n" + "".join(
        " ".join(r.astype(str)) + "\n"
        for r in idx.query_bitmap("g1", "chr1", 100, 140).to_numpy())
    idx.close()
    assert res.stdout == want


def test_port_imports_no_jax_pandas_yaml(tmp_path):
    """No module of the port, nor chip_smoke.py, imports jax, panagram_tpu,
    pandas or yaml, at any depth; matplotlib only inside a function."""
    import ast

    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f)
        for root, _, files in os.walk(os.path.join(REPO, "panagram_tpu_torch"))
        for f in files if f.endswith(".py")]
    assert len(paths) > 40
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "panagram_tpu", "pandas",
                                    "yaml"), (path, name)
                if root == "matplotlib":
                    assert id(node) not in top, (path, name)


def test_query_across_bgzf_blocks(tmp_path):
    """A chromosome of 200,000 rows spans four BGZF blocks: windows across
    the 65,280-byte block edges and at the chromosome's end, through the
    port's reader and panagram_tpu's, against the decompressed file."""
    rng = np.random.default_rng(11)
    base = random_seq(rng, 200_000 + K - 1)
    fa = tmp_path / "fa"
    fa.mkdir()
    for g in range(3):
        s = list(base)
        for i in rng.choice(len(s), 2_000, replace=False):
            s[i] = "ACGT"[rng.integers(4)]
        (fa / f"g{g}.fa").write_text(">chr1\n" + "".join(s)
                                     + "\n>chr2\n" + base[:5000] + "\n")
    samples = tmp_path / "samples.tsv"
    samples.write_text("name\tfasta\n" + "".join(
        f"g{g}\t{fa}/g{g}.fa\n" for g in range(3)))
    build_index(str(samples), prefix=str(tmp_path / "idx"), k=K,
                anchor_genomes=["g0"], device="cpu")
    d = str(tmp_path / "idx")
    rows = np.frombuffer(decompress_file(f"{d}/anchor/g0/bitmap.1.gz"),
                         np.uint8)
    bits = np.unpackbits(rows[:200_000, None], axis=1,
                         bitorder="little")[:, :3]
    port, ref = PortIndex(d), JaxIndex(d)
    edge = 65_280
    for start, end, step in ((edge - 3, edge + 5, 1), (2 * edge - 1,
                             2 * edge + 1, 1), (0, 200_000, 1),
                             (edge - 50, 3 * edge + 50, 7),
                             (199_990, 200_000, 1), (0, 200_000, 100),
                             (150, 199_999, 300)):
        got = port.query_bitmap("g0", "chr1", start, end, step)
        # rows from the coarsest stored step that divides `step`, from the
        # stored row at or before `start` (panagram_tpu's rule)
        stored = 100 if step % 100 == 0 else 1
        want = bits[start // stored * stored::step]
        assert np.array_equal(got.values, want[:len(range(start, end, step))])
        assert_table(got, ref.query_bitmap("g0", "chr1", start, end, step))
    got = port.query_bitmap("g0", "chr2", 4900, None)
    assert_table(got, ref.query_bitmap("g0", "chr2", 4900, None))
    port.close()
    ref.close()


# --------------------------------------------------------- tabix reader --

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tabix_roundtrip_and_large_coords(tmp_path, writer):
    """tests/test_io.py's roundtrip, through the port's reader, on files of
    either package's writer."""
    rows = [("chr1", 100, 200, "a"), ("chr1", 150, 900, "b"),
            ("chr1", 600_000_000, 600_000_500, "distal"),
            ("chr2", 5, 10, "c")]
    bgz = str(tmp_path / "t.bed.gz")
    (tabix if writer == "port" else jax_tabix).write_tabix(rows, bgz)
    t = tabix.TabixFile(bgz)
    assert t.contigs == ["chr1", "chr2"]
    assert {g[3] for g in t.fetch("chr1", 120, 160)} == {"a", "b"}
    assert {g[3] for g in t.fetch("chr1")} == {"a", "b", "distal"}
    assert list(t.fetch("chr1", 599_999_000, 700_000_000))[0][3] == "distal"
    assert list(t.fetch("chr2", 0, 100))[0][3] == "c"
    assert [r[3] for r in t.fetch()] == ["a", "b", "distal", "c"]
    with pytest.raises(ValueError, match="unknown contig"):
        list(t.fetch("chrX", 0, 10))
    t.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tabix_long_record_survives_loffset_pruning(tmp_path, writer):
    """tests/test_io.py's pruning check, through the port's reader."""
    rows = [("chr1", 0, 100_000, "longgene")]
    rows += [("chr1", 20_000 + 10 * i, 20_050 + 10 * i, f"s{i}")
             for i in range(50)]
    bgz = str(tmp_path / "t.bed.gz")
    (tabix if writer == "port" else jax_tabix).write_tabix(iter(rows), bgz)
    with tabix.TabixFile(bgz) as tf:
        names = {r[3] for r in tf.fetch("chr1", 20_000, 21_000)}
        assert "longgene" in names
        assert {f"s{i}" for i in range(50)} <= names
        assert list(tf.fetch("chr1", 500_000, 600_000)) == []
        assert [r[3] for r in tf.fetch("chr1", 1_000, 1_100)] == ["longgene"]


def test_tabix_fetch_equals_panagram_tpu(tmp_path):
    """Random records over several contigs, many spanning BGZF blocks:
    every window's records equal panagram_tpu's reader's, in order."""
    rng = np.random.default_rng(21)
    rows = []
    for c in ("chr1", "chr2", "chr3"):
        starts = np.sort(rng.integers(0, 3_000_000, 4_000))
        for i, s in enumerate(starts):
            e = int(s) + int(rng.integers(1, 200_000 if i % 97 == 0 else 900))
            rows.append((c, int(s), e, f"r{c}_{i}", "x" * int(rng.integers(0, 30))))
    bgz = str(tmp_path / "r.bed.gz")
    tabix.write_tabix(rows, bgz)
    t, j = tabix.TabixFile(bgz), jax_tabix.TabixFile(bgz)
    for _ in range(200):
        c = f"chr{rng.integers(1, 4)}"
        s = int(rng.integers(0, 3_100_000))
        e = s + int(rng.integers(1, 300_000))
        assert list(t.fetch(c, s, e)) == list(j.fetch(c, s, e))
    assert list(t.fetch()) == list(j.fetch())
    t.close()
    j.close()
