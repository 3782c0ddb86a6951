"""The port's annotated index build, --cores and annotate against
panagram_tpu's, on the CPU.

The 3-genome fixture of tests/test_torch_index.py gains GFF files (g1 the
GFF of tests/test_index.py; g2 one with duplicate genes, genes out of
bounds or on an unknown chromosome, Parent chains and transcripts; g3 one
with comments only) and a FASTQ read set, and UMAP bins small enough for
several bins per chromosome.  Every file must equal panagram_tpu's, with
the two exceptions of assert_same_file (anno_types.txt as a set of lines;
the UMAP coordinates within 1e-9).  The GFF tables themselves are held to
panagram_tpu.io.gff.split_gff on random files.
"""

import gzip
import logging
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from panagram_tpu.config import UMAPParams as JaxUMAPParams
from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.io import tabix as jax_tabix
from panagram_tpu.io.gff import split_gff as jax_split_gff
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch.__main__ import main as port_main
from panagram_tpu_torch.config import UMAPParams
from panagram_tpu_torch.index import Index as PortIndex
from panagram_tpu_torch.index import bitmap_to_bins
from panagram_tpu_torch.io.fasta import iter_fasta
from panagram_tpu_torch.io import tabix
from panagram_tpu_torch.io.gff import split_gff
from panagram_tpu_torch.ops import kernels
from panagram_tpu_torch.pipeline import build_index
from tests.test_torch_index import assert_same_file, assert_same_trees, write_fixture

torch.set_num_threads(2)

K = 11
CHROM_BIN, GENOME_BIN = 500, 300

G1_GFF = (  # tests/test_index.py's
    "##gff-version 3\n"
    "chr1\tsrc\tgene\t101\t400\t.\t+\t.\tID=gene1;Name=GeneA\n"
    "chr1\tsrc\tmRNA\t101\t400\t.\t+\t.\tID=rna1;Parent=gene1\n"
    "chr1\tsrc\texon\t101\t220\t.\t+\t.\tID=ex1;Parent=rna1\n"
    "chr1\tsrc\texon\t300\t400\t.\t+\t.\tID=ex2;Parent=rna1\n"
    "chr2\tsrc\tgene\t51\t900\t.\t-\t.\tID=gene2\n"
    "chr2\tsrc\trepeat_region\t10\t40\t.\t+\t.\tID=rep1\n"
)
G2_GFF = (
    "# duplicates, bounds, an unknown chromosome, deep Parent chains\n"
    "chr2\tsrc\tgene\t700\t1200\t.\t+\t.\tID=gB;Name=Bee\n"
    "chr1\tsrc\tgene\t900\t1500\t.\t+\t.\tgene_id=gD;Note=x\n"
    "chr1\tsrc\tgene\t900\t1500\t.\t+\t.\tID=gD2;name=Dee2\n"
    "chr1\tsrc\tgene\t900\t1300\t.\t+\t.\tID=gE\n"
    "chr1\tsrc\tgene\t2500\t3100\t.\t+\t.\tID=gF;Name=PastEnd\n"
    "chr1\tsrc\tgene\t60\t60\t.\t+\t.\tID=gEmpty\n"
    "chrX\tsrc\tgene\t1\t100\t.\t+\t.\tID=gX;Name=Nowhere\n"
    "chr1\tsrc\ttranscript\t900\t1500\t.\t+\t.\tID=t1;Parent=gD2\n"
    "chr1\tsrc\tmRNA\t900\t1500\t.\t+\t.\tID=m1;Parent=t1\n"
    "chr1\tsrc\texon\t900\t1000\t.\t+\t.\tID=e1;Parent=m1\n"
    "chr1\tsrc\texon\t900\t1000\t.\t+\t.\tID=e1;Parent=m1\n"
    "chr1\tsrc\tCDS\t950\t990\t.\t+\t0\tParent=m1\n"
    "chr1\tsrc\tfive_prime_UTR\t900\t949\t.\t+\t.\tParent=orphan;Name=Lone\n"
    "chr2\tsrc\trepeat_region\t5\t30\t.\t+\t.\tNote=no_id\n"
    "chr1\tsrc\tshort\t1\t2\n"
)
G3_GFF = "##gff-version 3\n# no features\n"
NEW_GFF = (  # for annotate on g2
    "chr1\tsrc\tgene\t501\t900\t.\t+\t.\tID=geneX;Name=NewGene\n"
    "chr1\tsrc\texon\t501\t700\t.\t+\t.\tID=exX;Parent=geneX\n"
    "chr1\tsrc\tgene\t501\t900\t.\t+\t.\tID=geneX2\n"
    "chr1\tsrc\tgene\t2000\t2995\t.\t+\t.\tID=geneEnd\n"
    "chr2\tsrc\tgene\t100\t1400\t.\t-\t.\tID=geneY\n"
    "chr3\tsrc\tgene\t1\t50\t.\t+\t.\tID=geneZ\n"
)


def write_annotated_fixture(tmp):
    """The FASTA fixture plus three GFFs and a gzipped FASTQ sample `reads`
    (2x coverage of g1 chr1[400:950] in 150-bp reads), in
    samples_anno.tsv."""
    write_fixture(tmp, np.random.default_rng(1234))
    fa = tmp / "fastas"
    for g, text in (("g1", G1_GFF), ("g2", G2_GFF), ("g3", G3_GFF)):
        (fa / f"{g}.gff").write_text(text)
    base = dict(iter_fasta(str(fa / "g1.fa")))["chr1"]
    with gzip.open(fa / "reads.fq.gz", "wt") as f:
        for rep in range(2):
            for s in range(0, 400, 100):
                read = base[400 + s:550 + s]
                f.write(f"@r{rep}_{s}\n{read}\n+\n{'I' * len(read)}\n")
    samples = tmp / "samples_anno.tsv"
    samples.write_text("name\tfasta\tgff\n" + "".join(
        f"{g}\t{fa}/{g}.fa\t{fa}/{g}.gff\n" for g in ("g1", "g2", "g3"))
        + f"reads\t{fa}/reads.fq.gz\t\n")
    return samples


def umap_params(jax):
    cls = JaxUMAPParams if jax else UMAPParams
    return dict(chrom_umap=cls(bin_size=CHROM_BIN),
                genome_umap=cls(bin_size=GENOME_BIN))


@pytest.fixture(scope="module")
def anno(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_annotate")
    samples = write_annotated_fixture(tmp)
    jax_build_index(str(samples), prefix=str(tmp / "jax"), k=K,
                    **umap_params(True))
    jax_build_index(str(samples), prefix=str(tmp / "jax3"), k=K, cores=3,
                    **umap_params(True))
    build_index(str(samples), prefix=str(tmp / "port"), k=K, device="cpu",
                **umap_params(False))
    build_index(str(samples), prefix=str(tmp / "port3"), k=K, device="cpu",
                cores=3, **umap_params(False))
    return dict(tmp=tmp, samples=samples)


def test_annotated_fastq_build_matches(anno):
    tmp = anno["tmp"]
    n = assert_same_trees(tmp / "port", tmp / "jax")
    per_anchor = {"bitmap.1.gz", "bitmap.1.gzi", "bitmap.100.gz",
                  "bitmap.100.gzi", "chrs.tsv", "bitsum.bins.tsv",
                  "total_paircounts.csv", "chrom_umaps.csv",
                  "genome_umap.csv", "gene.bed.gz", "gene.bed.gz.csi",
                  "anno.bed.gz", "anno.bed.gz.csi", "anno_types.txt",
                  "bitsum.genes.tsv"}
    for g in ("g1", "g2", "g3"):
        assert set(os.listdir(tmp / "port" / "anchor" / g)) == per_anchor
    assert not (tmp / "port" / "anchor" / "reads").exists()
    assert n == 3 + 5 + 3 * len(per_anchor)
    # the read set contributes its presence bit where it covers g1
    pan = np.load(tmp / "port" / "kmc" / "reads.kmers.npz")["kmers"]
    assert 0 < len(pan) < 550
    # several bins per chromosome: PCA ran, not the zero fallback
    with open(tmp / "port" / "anchor" / "g1" / "chrom_umaps.csv") as f:
        rows = f.read().splitlines()[1:]
    assert len(rows) == 6 + 3
    assert any(float(r.split(",")[3]) != 0.0 for r in rows)


def test_cores_match_serial_and_panagram_tpu(anno):
    """--cores 3 writes what --cores 1 writes (all but config.yaml, whose
    cores field differs), and what panagram_tpu's cores=3 writes; the
    threads write no per-anchor log file."""
    tmp = anno["tmp"]
    assert_same_trees(tmp / "port3", tmp / "jax3")
    n = assert_same_trees(tmp / "port3", tmp / "port", skip={"config.yaml"})
    assert n == 7 + 3 * 15
    logs = set(os.listdir(tmp / "port3" / "logs"))
    assert "anchor.g1.benchmark.txt" in logs
    assert not any(f.endswith(".log.txt") for f in logs)
    assert "anchor.g2.log.txt" in set(os.listdir(tmp / "port" / "logs"))


def test_query_and_bins_match_panagram_tpu(anno):
    """The port's read path (Genome.query, bitmap_to_bins) against
    panagram_tpu's query_bitmap and Index.bitmap_to_bins on the same
    index."""
    tmp = anno["tmp"]
    port = PortIndex(str(tmp / "port"))
    ref = JaxIndex(str(tmp / "jax"))
    for g, chrom, start, end, step in (("g1", "chr1", None, None, 100),
                                       ("g2", "chr2", 7, 1399, 1),
                                       ("g3", "chr1", 100, 2000, 200)):
        got = port.genomes[g].query(chrom, start, end, step)
        pos, bits = got.index, got.values
        want = ref.query_bitmap(g, chrom, start, end, step)
        assert list(got.columns) == list(want.columns)
        assert np.array_equal(pos, want.index.to_numpy())
        assert np.array_equal(bits, want.to_numpy())
        for binlen in (300, 1000):
            starts, occ, scaled = bitmap_to_bins(pos, bits, binlen)
            wocc, wpair = ref.bitmap_to_bins(want, binlen)
            assert np.array_equal(occ, wocc.to_numpy())
            assert np.array_equal(starts, wpair.columns.to_numpy())
            assert np.array_equal(scaled, wpair.to_numpy().T, equal_nan=True)
    ref.close()
    port.close()


def test_public_entry_points_default_to_the_card():
    """build_index, build_index_distributed and Genome.run_annotate run on
    the card unless the caller asks for the CPU."""
    import inspect

    from panagram_tpu_torch.index import Genome
    from panagram_tpu_torch.parallel.distributed import build_index_distributed

    for fn in (build_index, build_index_distributed, Genome.run_annotate):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_run_annotate_in_process(anno, tmp_path):
    """Genome.run_annotate called in process (device="cpu") writes what
    panagram_tpu's writes."""
    gff = tmp_path / "new.gff"
    gff.write_text(NEW_GFF)
    for d in ("port", "jax"):
        shutil.copytree(anno["tmp"] / "port", tmp_path / d)
    idx = PortIndex(str(tmp_path / "port"))
    idx["g2"].run_annotate(str(gff), device="cpu")
    idx.close()
    ref = JaxIndex(str(tmp_path / "jax"))
    ref["g2"].run_annotate(str(gff))
    ref.close()
    assert_same_trees(tmp_path / "port", tmp_path / "jax")


def test_annotate_cli_matches_run_annotate(anno, tmp_path):
    """`annotate <index> g2 <gff>` through the port's CLI against
    panagram_tpu's Genome.run_annotate on a copy of the same index."""
    tmp = anno["tmp"]
    gff = tmp_path / "new.gff"
    gff.write_text(NEW_GFF)
    for d in ("port", "jax"):
        shutil.copytree(tmp / "port", tmp_path / d)
    idx = JaxIndex(str(tmp_path / "jax"))
    idx["g2"].run_annotate(str(gff))
    idx.close()
    port_main(["annotate", str(tmp_path / "port"), "g2", str(gff),
               "--device", "cpu"])
    assert_same_trees(tmp_path / "port", tmp_path / "jax")
    ref = tmp / "port" / "anchor" / "g2"
    for f in ("gene.bed.gz", "anno.bed.gz", "bitsum.genes.tsv"):
        assert (tmp_path / "port" / "anchor" / "g2" / f).read_bytes() \
            != (ref / f).read_bytes(), f
    assert (tmp_path / "port" / "anchor" / "g2" / "chrs.tsv").read_bytes() \
        == (ref / "chrs.tsv").read_bytes()
    # panagram_tpu reads the new genes: NewGene counted twice (duplicate)
    idx = JaxIndex(str(tmp_path / "port"))
    genes = idx.query_genes("g2", "chr1", 0, 3000)
    assert list(genes["name"]) == ["NewGene", "geneX2", "geneEnd"]
    assert genes.iloc[0][1] + genes.iloc[0][4] > 0
    idx.close()


def test_annotate_nogene_writes_annotations_only(anno, tmp_path):
    tmp = anno["tmp"]
    gff = tmp_path / "new.gff"
    gff.write_text(NEW_GFF)
    shutil.copytree(tmp / "port", tmp_path / "port")
    port_main(["annotate", str(tmp_path / "port"), "g3", str(gff),
               "--device", "cpu", "--nogene"])
    d = tmp_path / "port" / "anchor" / "g3"
    assert (d / "anno_types.txt").read_text() == "exon\n"
    assert (d / "gene.bed.gz").read_bytes() == \
        (tmp / "port" / "anchor" / "g3" / "gene.bed.gz").read_bytes()


def _random_gff(rng, path):
    """A GFF with every feature of split_gff's rules: sort ties, IDs in
    gene_id=, names by Name= or name=, Parent chains (some cyclic, some
    dangling), transcripts and duplicate rows."""
    chroms = ["chr1", "chr10", "chr2", "Chr2", "scaf_9"]
    types = ["gene", "mRNA", "exon", "CDS", "transcript", "repeat_region"]
    ids = [f"f{i}" for i in range(40)]
    lines = ["##gff-version 3"]
    for i in range(120):
        attrs = []
        if rng.random() < 0.8:
            attrs.append(("ID", "gene_id", "Id")[rng.integers(3)] + "=" +
                         ids[rng.integers(len(ids))])
        if rng.random() < 0.6:
            attrs.append(f"Parent={ids[rng.integers(len(ids))]}")
        if rng.random() < 0.4:
            attrs.append(("Name", "name", "gene_name")[rng.integers(3)]
                         + f"=N{rng.integers(9)}")
        rng.shuffle(attrs)
        start = int(rng.integers(1, 60))
        line = "\t".join([chroms[rng.integers(len(chroms))], "src",
                          types[rng.integers(len(types))], str(start),
                          str(start + int(rng.integers(0, 30))), ".", "+",
                          ".", ";".join(attrs) or "."])
        lines.append(line)
        if rng.random() < 0.1:
            lines.append(line)
        if rng.random() < 0.05:
            lines.append("# a comment")
    path.write_text("\n".join(lines) + "\n")


def _frame_rows(df):
    return [tuple(None if isinstance(v, float) and np.isnan(v) else v
                  for v in row) for row in df.itertuples(index=False)]


@pytest.mark.parametrize("seed", range(4))
def test_split_gff_matches_panagram_tpu(seed, tmp_path):
    rng = np.random.default_rng(seed)
    path = tmp_path / "r.gff"
    _random_gff(rng, path)
    for kw in ({}, {"anno_types": ["exon", "CDS"]},
               {"gene_types": ["gene", "mRNA"], "name_attr": "ID"}):
        genes, annos = split_gff(str(path), **kw)
        jg, ja = jax_split_gff(str(path), **kw)
        assert [tuple(g) for g in genes] == _frame_rows(jg), kw
        assert annos == _frame_rows(ja), kw
    (tmp_path / "e.gff").write_text("# nothing\n\n")
    assert split_gff(str(tmp_path / "e.gff")) == ([], [])


@pytest.mark.parametrize("scale", [1 << 12, 1 << 20, 1 << 30])
def test_tabix_matches_panagram_tpu(scale, tmp_path):
    """CSI bins and the BGZF + .csi files of write_tabix against
    panagram_tpu's, up to coordinates that need a deeper index; with
    records long enough to span many windows and over 64 KiB of text."""
    rng = np.random.default_rng(scale)
    rows = []
    for chrom in ("chr1", "chr10", "chr2"):
        starts = np.sort(rng.integers(0, scale, 1500))
        for st in starts:
            end = int(st) + int(rng.integers(0, max(scale // 50, 2)))
            rows.append((chrom, int(st), end, "exon", f"n{int(st) % 97}",
                         int(rng.integers(0, 9))))
    for beg, end in zip(rng.integers(0, scale, 200).tolist(),
                        rng.integers(1, 1 << 16, 200).tolist()):
        for depth in (5, 6, 7):
            assert tabix._reg2bin(beg, beg + end, 14, depth) == \
                jax_tabix._reg2bin(beg, beg + end, 14, depth)
            assert tabix._reg2bins(beg, beg + end, 14, depth) == \
                jax_tabix._reg2bins(beg, beg + end, 14, depth)
    tabix.write_tabix(rows, str(tmp_path / "p.bed.gz"))
    jax_tabix.write_tabix(rows, str(tmp_path / "j.bed.gz"))
    for ext in (".bed.gz", ".bed.gz.csi"):
        assert (tmp_path / f"p{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    got = list(jax_tabix.TabixFile(str(tmp_path / "p.bed.gz")).fetch(
        "chr10", scale // 3, scale // 3 + scale // 10))
    assert got and all(int(r[1]) < scale // 3 + scale // 10 for r in got)


def test_kernel_counters_are_thread_safe():
    """Many threads: plain versions on CPU tensors count no launch, and
    concurrent counter updates lose none (the lock of ops/kernels.py)."""
    nthreads, calls = 8, 200
    rows = torch.from_numpy(np.arange(64, dtype=np.int32).reshape(32, 2))
    before = dict(kernels.launches)
    errors = []

    def plain():
        try:
            for _ in range(calls):
                kernels.fused_popcount_colsums(rows, 40)
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    def launch():
        for _ in range(calls):
            kernels._launched("masks_to_bytes", 0, "test")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for target in (plain, launch):
            threads = [threading.Thread(target=target)
                       for _ in range(nthreads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    after = dict(kernels.launches)
    assert after["masks_to_bytes"] - before["masks_to_bytes"] == \
        nthreads * calls
    after["masks_to_bytes"] = before["masks_to_bytes"]
    assert after == before
    kernels.launches["masks_to_bytes"] = before["masks_to_bytes"]


def test_threaded_build_logs_to_the_package_logger(anno, tmp_path):
    """A threaded build writes every anchor's lines to the shared package
    logger and no per-anchor file."""
    seen = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: seen.append(record.getMessage())
    pkg = logging.getLogger("panagram_tpu_torch")
    level = pkg.level
    pkg.addHandler(handler)
    pkg.setLevel(logging.INFO)
    try:
        build_index(str(anno["samples"]), prefix=str(tmp_path / "t"), k=K,
                    device="cpu", cores=2, **umap_params(False))
    finally:
        pkg.removeHandler(handler)
        pkg.setLevel(level)
    assert seen.count("Anchoring Started") == 3
    assert not any(f.endswith(".log.txt")
                   for f in os.listdir(tmp_path / "t" / "logs"))
