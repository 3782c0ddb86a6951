"""panagram_tpu's readers on a full index that the port built, on the CPU.

The annotated fixture of tests/test_torch_annotate.py (three genomes of
two chromosomes with GFFs, a FASTQ read set, small UMAP bins) goes through
the port's ``index --mesh 4 --device cpu`` (four Gloo ranks, 1024
positions per chunk so that every chunk spans the ranks) and through
panagram_tpu's one-device build.  panagram_tpu's ``bitdump``, its viewer's
plot functions (the calls of tests/test_view.py) and its Index's read-mode
tables must open the port's tree without error and give what they give on
panagram_tpu's tree: the same printed text, the same PNG bytes and
click-through maps, the same DataFrames (tolerance 0; the UMAP
coordinates within 1e-9, and annotation type ids by each tree's own
anno_types.txt, which lists a set in hash order).
"""

import numpy as np
import pytest
import torch

from panagram_tpu import index as jax_index
from panagram_tpu.__main__ import main as jax_main
from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch import index as port_index
from panagram_tpu_torch.pipeline import build_index
from tests.test_torch_annotate import umap_params, write_annotated_fixture

torch.set_num_threads(2)

K = 11


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """(panagram_tpu Index on the port's mesh tree, on its own tree)."""
    tmp = tmp_path_factory.mktemp("read_view")
    samples = write_annotated_fixture(tmp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_index, "ANCHOR_CHUNK", 1 << 10)
        mp.setattr(port_index, "ANCHOR_CHUNK", 1 << 10)
        mp.setenv("PANAGRAM_TPU_CHUNK_LOG2", "10")     # the spawned ranks
        jax_build_index(str(samples), prefix=str(tmp / "jax"), k=K,
                        **umap_params(True))
        idx = build_index(str(samples), prefix=str(tmp / "mesh"), k=K,
                          device="cpu", mesh_devices=4, **umap_params(False))
    assert len(idx.mesh_ranks) == 4 and not idx.write_mode
    idx.close()
    port, ref = JaxIndex(str(tmp / "mesh")), JaxIndex(str(tmp / "jax"))
    yield port, ref, tmp
    port.close()
    ref.close()


@pytest.mark.parametrize("args", [
    ("g1", "chr1", 100, 140), ("g2", "chr1", 0, 2000), ("g3", "chr1"),
    ("g1", "chr2", 0, 1400, 100)])
@pytest.mark.parametrize("verbose", [False, True])
def test_bitdump_reads_the_port_tree(views, args, verbose, capsys,
                                     monkeypatch):
    monkeypatch.setenv("COLUMNS", "80")
    _, _, tmp = views
    out = []
    for tree in ("mesh", "jax"):
        capsys.readouterr()
        jax_main(["bitdump", str(tmp / tree), *[str(a) for a in args]]
                 + (["-v"] if verbose else []))
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[0]


@pytest.mark.parametrize("attr", [
    "chrs", "bitsum_bins", "bitsum_chrs", "bitfreq_chrs", "bitsum_totals",
    "bitfreq_totals", "bitsum_totals_avg", "bitsum_chrs_avg",
    "genome_sizes"])
def test_index_tables_of_the_port_tree(views, attr):
    port, ref, _ = views
    assert getattr(port, attr).equals(getattr(ref, attr))


def test_genome_tables_of_the_port_tree(views):
    port, ref, _ = views
    for g in ("g1", "g2", "g3"):
        for attr in ("bitsum_bins", "bitsum_genes", "total_paircounts"):
            assert getattr(port[g], attr).equals(getattr(ref[g], attr)), attr
        for chrom in ("chr1", "chr2"):
            assert port.query_genes(g, chrom, 0, 3000).equals(
                ref.query_genes(g, chrom, 0, 3000))
            # type ids follow anno_types.txt, a set written in hash order:
            # each tree's own ids
            got = port.query_anno(g, chrom, 0, 3000)
            want = ref.query_anno(g, chrom, 0, 3000)
            assert got.drop(columns="type_id").equals(
                want.drop(columns="type_id"))
            if len(got):
                ids = port[g].anno_type_ids
                assert list(got["type_id"]) == [ids[t] for t in got["type"]]
        assert np.allclose(port[g].chrom_umaps.to_numpy(),
                           ref[g].chrom_umaps.to_numpy(), atol=1e-9)


def test_view_plots_of_the_port_tree(views):
    """tests/test_view.py's plot functions: the same PNGs and maps."""
    from panagram_tpu.view import plots

    port, ref, _ = views

    def render(idx):
        wg_png, wg_map = plots.whole_genome_plot(idx, "g1")
        cv_png, cv_map = plots.chromosome_view(idx, "g1", "chr1", 100, 2000)
        cw_png, cw_map = plots.chr_whole_plot(idx, "g1", "chr1", 100, 2000)
        _, full = plots.chromosome_view(idx, "g1", "chr1")
        typed_png, typed_map = plots.chromosome_view(idx, "g1", "chr1",
                                                     types=set())
        pngs = [plots.pangenome_composition(idx), plots.genome_dendrogram(idx),
                plots.chromosome_histograms(idx), plots.genome_sizes_plot(idx),
                plots.gene_content_plot(idx, "g1"), wg_png, cv_png, cw_png,
                typed_png]
        return pngs, [wg_map, cv_map, cw_map, full, typed_map]

    pngs, maps = render(port)
    want_pngs, want_maps = render(ref)
    for png in pngs:
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 2000
    assert maps == want_maps
    assert pngs == want_pngs
    assert [r["chrom"] for r in maps[0]["rows"]] == ["chr1", "chr2"]
    assert maps[1]["start"] == 100 and maps[1]["end"] == 2000
