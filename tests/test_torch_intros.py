"""The port's introgression subsystem (intros/, the ``intros`` command, the
YAML reader) against panagram_tpu's, on the CPU.

tests/test_intros.py's example (simulate with seed 7, a k=17 index of the
reference, its wild relative and three offspring generations, bed2txt)
runs through both packages: the simulated FASTA and BED files and the
ground-truth matrices must be byte-equal.  The 2-way, 3-way and sweep
configs of tests/test_intros.py, and a 3-way config with smoothing, gnm,
rmu and ground-truth actions, then run through both runners on the same
index (panagram_tpu's build, and the port's for the 2-way config): every
raw, postprocessed and scored file, every heatmap (SVG under a fixed
svg.hashsalt and SOURCE_DATE_EPOCH, PNG) and the sweep plots must be
byte-equal.  The one exception is sweep_metrics.tsv, whose rates pandas
re-reads from the metrics text with its own float parser, which is not
correctly rounded (the port's float() is): its Accuracy, Precision, Recall
and FPR columns are held within 1e-12, every other cell exactly, and the
metrics files it is read from are byte-equal.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from panagram_tpu.__main__ import _add_intros as jax_add_intros
from panagram_tpu.intros import core as jax_core
from panagram_tpu.intros import postprocess as jax_postprocess
from panagram_tpu.intros import runner as jax_runner
from panagram_tpu.intros import simulate as jax_simulate
from panagram_tpu.intros.bed2txt import bed_to_text as jax_bed_to_text
from panagram_tpu.intros.heatmap import panagram_heatmap_general as jax_heatmap
from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch.__main__ import _add_intros
from panagram_tpu_torch.__main__ import main as port_main
from panagram_tpu_torch.config import load_yaml
from panagram_tpu_torch.index import Index as PortIndex
from panagram_tpu_torch.intros import call, core, postprocess
from panagram_tpu_torch.intros.heatmap import panagram_heatmap_general
from panagram_tpu_torch.pipeline import build_index

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_ARGS = [
    "--num-introgressions", "1",
    "--introgression-size-min", "20000",
    "--introgression-size-max", "30000",
    "--rel-sub-rate", "0.02",
    "--rel-ins-rate", "1e-5", "--rel-del-rate", "1e-5",
    "--rel-ins-size-min", "1", "--rel-ins-size-max", "50",
    "--rel-del-size-min", "1", "--rel-del-size-max", "50",
    "--mut-sub-rate", "5e-4", "--mut-ins-rate", "1e-6",
    "--mut-del-rate", "1e-6",
    "--mut-ins-size-min", "1", "--mut-ins-size-max", "20",
    "--mut-del-size-min", "1", "--mut-del-size-max", "20",
    "--rounds", "2", "--seed", "7",
]
GENOMES = ["Reference", "WildRelative", "OffspringGen1", "OffspringGen2",
           "OffspringGen3"]
GROUPS = "name\tgroup\nReference\tREF\nWildRelative\tWT\n" \
    "OffspringGen1\tOFFSPRING\nOffspringGen2\tOFFSPRING\n" \
    "OffspringGen3\tOFFSPRING\n"
# sweep_metrics.tsv's columns that pandas reads back through its parser
REREAD_RATES = ("Accuracy", "Precision", "Recall", "FPR")
RATE_ATOL = 1e-12


def write_reference(path):
    """tests/test_intros.py's reference: 100 kbp of random bases."""
    rng = np.random.default_rng(5)
    ref_seq = "".join(rng.choice(list("ACGT"), 100_000))
    with open(path, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(ref_seq), 70):
            f.write(ref_seq[i:i + 70] + "\n")


def files_of(d: Path) -> dict:
    return {str(p.relative_to(d)): p for p in sorted(d.rglob("*"))
            if p.is_file()}


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """The simulated example through both packages: each package's
    simulation with its ground-truth matrices (bed2txt) beside it, and the
    index of the simulated genomes built by panagram_tpu ("jax") and by the
    port ("port")."""
    tmp = tmp_path_factory.mktemp("torch_intros")
    (tmp / "FASTAS").mkdir()
    ref_fa = tmp / "FASTAS" / "toyref.fasta"
    write_reference(ref_fa)
    sims = {"jax": tmp / "sim_jax", "port": tmp / "sim_port"}
    jax_simulate.main(["--ref", str(ref_fa), "--out-folder",
                       str(sims["jax"])] + SIM_ARGS)
    port_main(["intros", "simulate", "--ref", str(ref_fa), "--out-folder",
               str(sims["port"])] + SIM_ARGS)
    (tmp / "group.tsv").write_text(GROUPS)
    # one samples.tsv of panagram_tpu's simulation (the port's is the same
    # bytes) for both builds
    samples = tmp / "samples.tsv"
    sim = sims["jax"]
    samples.write_text("name\tfasta\n" + "".join(
        f"{n}\t{p}\n" for n, p in zip(GENOMES, [
            ref_fa, sim / "toyref_wildrelative.fasta",
            sim / "toyref_0_offspring.fasta", sim / "toyref_1_offspring.fasta",
            sim / "toyref_2_offspring.fasta"])))
    idx = {"jax": tmp / "index_jax", "port": tmp / "index_port"}
    jax_build_index(str(samples), prefix=str(idx["jax"]), k=17)
    build_index(str(samples), prefix=str(idx["port"]), k=17, device="cpu")
    jax_bed_to_text(sims["jax"] / "toyref_0_introgressions.bed", idx["jax"],
                    "Reference", "WildRelative", "WT", bin_size=5000)
    port_main(["intros", "bed2txt", "--gt_bed_file",
               str(sims["port"] / "toyref_0_introgressions.bed"),
               "--index_dir", str(idx["port"]), "--ref", "Reference",
               "--wild_type", "WildRelative", "--wild_type_group", "WT",
               "--bin_size", "5000"])
    return dict(tmp=tmp, sims=sims, idx=idx, groups=tmp / "group.tsv")


def test_simulated_files_equal(example):
    """simulate through the port's CLI writes panagram_tpu's bytes; so does
    bed2txt (its matrices beside the BED).  The builds' FASTA indexes
    (.fai) lie beside panagram_tpu's simulation only."""
    a, b = files_of(example["sims"]["port"]), files_of(example["sims"]["jax"])
    b = {k: v for k, v in b.items() if not k.endswith(".fai")}
    assert sorted(a) == sorted(b)
    assert {"toyref_wildrelative.fasta", "toyref_0_introgressions.bed",
            "toyref_2_offspring.fasta", "chr1_WT.txt"} <= set(a)
    for name in a:
        assert a[name].read_bytes() == b[name].read_bytes(), name


def test_index_trees_equal(example):
    """The port's index of the example equals panagram_tpu's."""
    from tests.test_torch_index import assert_same_trees

    assert assert_same_trees(example["idx"]["port"], example["idx"]["jax"])


def config(example, out_dir, calling, scoring=None, post=None, tree="jax",
           threads=1):
    """tests/test_intros.py's config with `calling` (and `scoring`,
    `post`) entries replaced."""
    cfg = {
        "general": {"output_dir": str(out_dir),
                    "index_dir": str(example["idx"][tree]),
                    "tsv": str(example["groups"]), "bin": 5000,
                    "ref": "Reference", "threads": threads},
        "calling": {"run": True, "grp": ["OFFSPRING"], "cmp": ["REF"],
                    "thr": [0.8], "stp": 100, "gnm": None, "trm": 3,
                    "sft": "mean", "ssz": 2, "urf": True, "rmf": True,
                    "rmu": None, "ogrp": None, "edg": False, "vis": True,
                    **calling},
        "postprocessing": {"run": True, "act": ["fgap", "rmbn"], "min": 2,
                           "gap": 1, **(post or {})},
        "scoring": {"run": True, "gdt": str(example["sims"]["jax"]),
                    "act": None, "min": 1, "gap": 1, "thr": 0.25,
                    "cmp": ["WT"], "vis": True, **(scoring or {})},
    }
    return cfg


CONFIGS = {
    "2way": ({}, None, None),
    "3way": ({"cmp": ["WT"], "thr": [0.2], "sft": None, "urf": False,
              "vis": False}, {"vis": False}, None),
    "3way-gnm-rmu": ({"cmp": ["WT"], "thr": [0.1, 0.2], "sft": "median",
                      "ssz": 3, "urf": False, "gnm": -1, "trm": 2,
                      "rmu": True, "ogrp": ["NONE"], "edg": True},
                     {"act": ["fgap", "rmbn", "fcen"], "min": 2},
                     {"act": ["fcen", "fgap"]}),
    "2way-gnm": ({"gnm": 0.9, "anc": ["OffspringGen1", "OffspringGen3"],
                  "grp": None, "vis": False, "thr": [0.7, 0.85]},
                 {"vis": True, "thr": 0.5}, {"run": False}),
}


@pytest.fixture(autouse=True)
def fixed_svg(monkeypatch):
    """SVG ids and dates fixed, so that two renders compare byte for
    byte."""
    import matplotlib

    monkeypatch.setitem(matplotlib.rcParams, "svg.hashsalt", "panagram")
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")


def run_both(example, name, cfg, sweep=False):
    """cfg through panagram_tpu's runner and through the port's CLI, into
    directories of the same name (the name is part of every threshold
    directory's and of the sweep montage's titles): {relative path: (port
    file, jax file)}."""
    tmp = example["tmp"]
    outs = {}
    for pkg in ("jax", "port"):
        out = tmp / f"runs_{pkg}" / name
        c = {k: dict(v) for k, v in cfg.items()}
        c["general"]["output_dir"] = str(out)
        path = tmp / f"{name}-{pkg}.yaml"
        path.write_text(yaml.dump(c))
        if pkg == "jax":
            jax_runner.run_introgression_pipeline(
                jax_runner.parse_config(path), sweep=sweep)
        else:
            port_main(["intros", str(path)] + (["--sweep"] if sweep else []))
        outs[pkg] = files_of(out)
    a, b = outs["port"], outs["jax"]
    assert sorted(a) == sorted(b)
    return {k: (a[k], b[k]) for k in a}


def assert_sweep_metrics(got: Path, want: Path):
    g, w = (pd.read_csv(got, sep="\t", keep_default_na=False, dtype=str),
            pd.read_csv(want, sep="\t", keep_default_na=False, dtype=str))
    assert list(g.columns) == list(w.columns) and g.shape == w.shape
    for col in g.columns:
        for x, y in zip(g[col], w[col]):
            if col in REREAD_RATES and x and y:
                assert abs(float(x) - float(y)) <= RATE_ATOL, (col, x, y)
            else:
                assert x == y, (col, x, y)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_runner_outputs_equal(example, name):
    """Each config through both runners on panagram_tpu's index: the same
    files, byte for byte."""
    calling, scoring, post = CONFIGS[name]
    pairs = run_both(example, name, config(example, "x", calling, scoring,
                                           post))
    assert any(k.endswith(".bed") and "/raw/" in k for k in pairs)
    if scoring is None or scoring.get("vis", True):
        assert any(k.endswith(".png") for k in pairs)
    for k, (got, want) in pairs.items():
        assert got.read_bytes() == want.read_bytes(), k


def test_runner_on_the_ports_index(example):
    """The 2-way config (heatmaps included) on the port's own index: the
    port's runner writes what panagram_tpu's writes there, and recall and
    precision pass tests/test_intros.py's bars."""
    pairs = run_both(example, "2way_port_idx",
                     config(example, "x", {}, tree="port"))
    assert any(k.endswith(".svg") for k in pairs)
    for k, (got, want) in pairs.items():
        assert got.read_bytes() == want.read_bytes(), k
    m = pd.read_csv(pairs["2way_port_idx_0.8/scored/metrics_REF.tsv"][0], sep="\t",
                    index_col=0)
    assert m["Recall"].iloc[0] >= 0.9 and m["Precision"].iloc[0] >= 0.85


def test_sweep_outputs_equal(example):
    """--sweep after the config, threads 2, sweep plots: every file equal
    (sweep_metrics.tsv as the module docstring says)."""
    pairs = run_both(example, "sweep", config(example, "x", {"vis": False},
                                              scoring={"vis": True}),
                     sweep=True)
    for thr in call.SWEEP_2WAY:
        assert f"sweep_{thr}/scored/metrics_REF.tsv" in pairs
    for f in ("sweep_pr_curve.png", "sweep_pr_per_chr.png", "sweep_mcc.png",
              "sweep_heatmaps.png", "sweep_metrics.tsv"):
        assert f in pairs
    for k, (got, want) in pairs.items():
        if k == "sweep_metrics.tsv":
            assert_sweep_metrics(got, want)
        else:
            assert got.read_bytes() == want.read_bytes(), k


def test_heatmap_tool_equal(example, tmp_path):
    """The heatmap sub-tool through the port's CLI and panagram_tpu's
    function: the same SVGs, with and without groups."""
    for groups in (None, example["groups"]):
        out = {p: tmp_path / f"{p}_{groups is None}" for p in ("j", "p")}
        jax_heatmap(example["idx"]["jax"], "OffspringGen1", groups_tsv=groups,
                    bin_size=5000, step=100, out_dir=out["j"])
        port_main(["intros", "heatmap", "--index-dir",
                   str(example["idx"]["jax"]), "--anchor", "OffspringGen1",
                   "--bin", "5000", "--stp", "100", "--out", str(out["p"])]
                  + (["--groups", str(groups)] if groups else []))
        got, want = files_of(out["p"]), files_of(out["j"])
        assert sorted(got) == sorted(want) == ["OffspringGen1_chr1_heatmap.svg"]
        for k in got:
            assert got[k].read_bytes() == want[k].read_bytes()
    assert panagram_heatmap_general(example["idx"]["jax"], "Reference",
                                    bin_size=20_000, rmf=False,
                                    out_dir=tmp_path / "r")[0].exists()


def test_binned_bitmap_equals_panagram_tpu(example):
    """The caller's bitmap_to_bins (rmf, rmu) and preprocessing (gnm, edge,
    mean and median smoothing) against panagram_tpu's frames, tolerance
    0; and get_genome_similarities."""
    from panagram_tpu.intros import call as jax_call

    d = str(example["idx"]["jax"])
    port, ref = PortIndex(d), JaxIndex(d)
    for g in ("OffspringGen1", "WildRelative"):
        pg, rg = port.genomes[g], ref.genomes[g]
        bm, wbm = pg.query("chr1", 0, pg.seq_len("chr1"), 100), rg.query(
            "chr1", 0, int(rg.seq_len("chr1")), 100)
        # rmu with the outgroups and the reference in column order (see
        # test_rmu_sets_the_bits_of_rows_none_holds for the other order)
        for args in ((False, False, None, None), (True, False, None, None),
                     (True, True, "WildRelative", ["Reference"]),
                     (False, True, "Reference", [])):
            got = call.bitmap_to_bins(bm, 5000, *args)
            want = jax_call.bitmap_to_bins(wbm, 5000, *args)
            assert np.array_equal(got.values, want.to_numpy(), equal_nan=True)
            assert list(got.index) == list(want.index)
            assert list(got.columns) == list(want.columns)
        for trim in (3.0, 1.0, -1):
            gs = call.get_genome_similarities(pg, 100, 5000, True, False,
                                              None, None, trim)
            ws = jax_call.get_genome_similarities(rg, 100, 5000, True, False,
                                                  None, None, trim)
            assert list(gs.index) == list(ws.index)
            assert np.array_equal(gs.values, ws.to_numpy(), equal_nan=True)
        for target in (0.9, -1):
            for sft, ssz in ((None, 5), ("mean", 2), ("median", 3),
                             ("other", 3)):
                for edg in (False, True):
                    pp = dict(similarity_normalization_mean=target,
                              smoothing_filter=sft, smoothing_filter_size=ssz,
                              edge_normalization=edg)
                    got = call.preprocess_binned_bitmap(
                        call.bitmap_to_bins(bm, 5000, True), gs, **pp)
                    want = jax_call.preprocess_binned_bitmap(
                        jax_call.bitmap_to_bins(wbm, 5000, True), ws, **pp)
                    assert np.array_equal(got.values, want.to_numpy(),
                                          equal_nan=True), pp
    port.close()
    ref.close()


@pytest.mark.parametrize("rmf", [False, True])
def test_rmu_sets_the_bits_of_rows_none_holds(example, rmf):
    """rmu with the outgroups after the reference in column order: the
    port sets the bits of every row none of them holds, then bins, which is
    panagram_tpu's binning of the bitmap with those bits set.
    panagram_tpu's own rmu leaves such a bitmap as it is under pandas 3's
    copy-on-write (`df.loc[mask, cols] = 1` on a frame made by set_index
    writes nothing when `cols` is not in column order), so its output is
    not the reference here (ROADMAP: reference-side faults)."""
    from panagram_tpu.intros import call as jax_call

    d = str(example["idx"]["jax"])
    port, ref = PortIndex(d), JaxIndex(d)
    g, keep = "OffspringGen2", ["WildRelative", "Reference"]
    bm = port.genomes[g].query("chr1", 0, port.genomes[g].seq_len("chr1"), 100)
    wbm = ref.genomes[g].query("chr1", 0, int(ref.genomes[g].seq_len("chr1")),
                               100).copy()
    none = wbm[keep].to_numpy().sum(axis=1) == 0
    assert none.any()
    set_bits = wbm.to_numpy().copy()
    set_bits[np.ix_(none, [list(wbm.columns).index(c) for c in keep])] = 1
    want = jax_call.bitmap_to_bins(
        pd.DataFrame(set_bits, index=wbm.index, columns=wbm.columns), 5000,
        rmf)
    got = call.bitmap_to_bins(bm, 5000, rmf, True, "Reference",
                              ["WildRelative"])
    assert np.array_equal(got.values, want.to_numpy(), equal_nan=True)
    assert not np.array_equal(got.values, jax_call.bitmap_to_bins(
        wbm, 5000, rmf, True, "Reference", ["WildRelative"]).to_numpy(),
        equal_nan=True)
    port.close()
    ref.close()


@pytest.mark.parametrize("rows", [2, 7, 8, 9, 40])
def test_column_means_add_as_pandas(rows):
    """similarity_frame's column means and maxima against pandas' on frames
    of NaN-holding rows, below and above numpy's 8-way pairwise block."""
    rng = np.random.default_rng(rows)
    v = rng.random((rows, 300)) * 10.0 ** rng.integers(-3, 3, (rows, 300))
    v[rng.random(v.shape) < 0.1] = np.nan
    v[:, 5] = np.nan
    df = pd.DataFrame(v, columns=np.arange(300) * 5000)
    assert np.array_equal(call._col_nanmean(v), df.mean(axis=0).to_numpy(),
                          equal_nan=True)
    assert np.array_equal(call._col_nanmax(v), df.max(axis=0).to_numpy(),
                          equal_nan=True)
    for r in v:
        s = pd.Series(r)
        assert call._nanmean(r) == s.mean()
        assert call._nanstd(r) == s.std() or np.isnan(s.std())


# ------------------------------------------------ core twins (tests/test_intros.py)

@pytest.mark.parametrize("gap", [0, 1, 2, 3])
@pytest.mark.parametrize("row", [[1, 1, 0, 0, 1, 0, 0, 0, 1], [0] * 5,
                                 [1, 0, 1, 1, 0, 1, 1, 1], [0, 1, 0, 0, 1, 0]])
def test_fill_gaps_and_remove_small_regions(row, gap):
    row = np.array(row)
    assert list(core.fill_gaps(row, gap)) == list(jax_core.fill_gaps(row, gap))
    assert list(core.remove_small_regions(row, gap)) == list(
        jax_core.remove_small_regions(row, gap))


def test_fill_gaps_values():
    row = np.array([1, 1, 0, 0, 1, 0, 0, 0, 1])
    assert list(core.fill_gaps(row, 2)) == [1, 1, 1, 1, 1, 0, 0, 0, 1]
    assert list(core.fill_gaps(row, 3)) == [1, 1, 1, 1, 1, 1, 1, 1, 1]
    row = np.array([1, 0, 1, 1, 0, 1, 1, 1])
    assert list(core.remove_small_regions(row, 2)) == [0, 0, 1, 1, 0, 1, 1, 1]
    assert list(core.remove_small_regions(row, 3)) == [0, 0, 0, 0, 0, 1, 1, 1]


BEDS = [
    [("c1", 1000, 2000, "x"), ("c1", 5000, 8100, "x")],
    [("c1", 2500, 3500, "x"), ("c1", 7499, 7500, "x"), ("c1", 9000, 9300, "y")],
    [("c1", 0, 10000, "x")],
    [("c1", 9600, 12000, "x"), ("c1", 3250, 3750, "x")],
    [],
]


@pytest.mark.parametrize("bed", BEDS)
@pytest.mark.parametrize("chr_length", [10000, 9500])
def test_bed_bins_roundtrip(bed, chr_length, tmp_path):
    """bed_to_bins, bins_to_bed and the BED reader and writer against
    panagram_tpu's on the same rows (rounding half to even, the quarter-bin
    rule, ends past the chromosome)."""
    path = tmp_path / "x.bed"
    path.write_text("".join("\t".join(map(str, r)) + "\n" for r in bed))
    got = core.bed_to_bins(core.read_bed_file(path), 1000, chr_length)
    want = jax_core.bed_to_bins(jax_core.read_bed_file(path), 1000, chr_length)
    assert list(got.index) == list(want.index)
    assert list(got.values) == list(want["introgression"])
    out = core.bins_to_bed(got, 1000, "c1", "WT")
    wout = jax_core.bins_to_bed(want, 1000, "c1", "WT")
    core.write_bed(out, tmp_path / "a.bed")
    wout.to_csv(tmp_path / "b.bed", header=False, index=False, sep="\t")
    assert (tmp_path / "a.bed").read_bytes() == (tmp_path / "b.bed").read_bytes()


def test_bed_bins_values():
    bed = [["c1", 1000, 2000, "x"], ["c1", 5000, 8100, "x"]]
    bins = core.bed_to_bins(bed, 1000, 10000)
    flags = dict(zip(bins.index, bins.values))
    assert list(bins.index) == list(range(0, 10000, 1000))
    assert flags[1000] == flags[5000] == flags[7000] == 1 and flags[3000] == 0
    out = core.bins_to_bed(bins, 1000, "c1", "WT")
    assert out == [("c1", 1000, 1999, "WT_intro"), ("c1", 5000, 7999, "WT_intro")]


@pytest.mark.parametrize("name,cands", [
    ("Off_1_chr_2_WT.bed", ["Off_1", "Off", "Other"]),
    ("A_chr1_REF.bed", ["A", "B"]), ("nounderscore.bed", ["x"]),
    ("A_REF.bed", ["A"]), ("Z_chr1_REF.bed", ["A"])])
def test_get_bed_pieces(name, cands):
    try:
        want = jax_core.get_bed_pieces(name, cands)
    except ValueError as e:
        with pytest.raises(ValueError, match="Unable to parse"):
            core.get_bed_pieces(name, cands)
        assert str(e)
    else:
        assert core.get_bed_pieces(name, cands) == want
    if name == "Off_1_chr_2_WT.bed":
        assert core.get_bed_pieces(name, cands) == ("chr_2", "Off_1", "WT")


def test_merge_centromere_regions(tmp_path):
    """Events two bins apart merge across a run of 50 N's, not across
    bases; rows are written as panagram_tpu writes them."""
    seq = "A" * 3000 + "N" * 60 + "A" * 6940
    bed = [["c1", 5000, 6000, "a"], ["c1", 1000, 2000, "b"],
           ["c1", 4000, 4500, "c"], ["c1", 8000, 9000, "d"]]
    path = tmp_path / "x.bed"
    path.write_text("".join("\t".join(map(str, r)) + "\n" for r in bed))
    got = core.merge_centromere_regions(core.read_bed_file(path),
                                        {"c1": seq}, 1000)
    want = jax_core.merge_centromere_regions(jax_core.read_bed_file(path),
                                             {"c1": seq}, 1000)
    assert got == [[c, s, e, n] for c, s, e, n in want[
        ["Chromosome", "Start", "End", "Notes"]].itertuples(index=False)]
    assert got[0] == ["c1", 1000, 4500, "b"]


def test_lift_needs_minimap2(example, tmp_path, monkeypatch):
    """lift raises panagram_tpu's RuntimeError where minimap2 and
    paftools.js are not on PATH."""
    bed = tmp_path / "OffspringGen1_chr1_REF.bed"
    bed.write_text("chr1\t0\t4999\tREF_intro\n")
    idx = PortIndex(str(example["idx"]["jax"]))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError) as got:
        postprocess.postprocess(idx, [bed], ["lift"], tmp_path / "o",
                                ref="Reference")
    with pytest.raises(RuntimeError) as want:
        jax_postprocess.postprocess(JaxIndex(str(example["idx"]["jax"])),
                                    [bed], ["lift"], tmp_path / "o",
                                    ref="Reference")
    assert str(got.value) == str(want.value)
    assert "minimap2" in str(got.value)
    with pytest.raises(ValueError, match="Unrecognized action"):
        postprocess.postprocess(idx, [bed], ["nope"], tmp_path / "o")


def test_intros_arguments_are_panagram_tpus():
    def parse(add, argv):
        parser = argparse.ArgumentParser()
        add(parser.add_subparsers(dest="cmd"))
        return vars(parser.parse_args(argv))

    for argv in (["intros", "c.yaml"], ["intros", "c.yaml", "--sweep"],
                 ["intros", "--sweep", "c.yaml"],
                 ["intros", "simulate", "--ref", "x", "--seed", "3"]):
        assert parse(_add_intros, argv) == parse(jax_add_intros, argv)


def test_intros_runs_without_matplotlib_pandas_jax(example, tmp_path):
    """With jax, pandas, yaml, matplotlib and panagram_tpu unimportable, a
    vis: false config runs through the port's CLI to its scored metrics,
    equal to panagram_tpu's; the heatmap tool raises an ImportError that
    names matplotlib."""
    cfg = config(example, tmp_path / "nompl", {"vis": False},
                 scoring={"vis": False})
    path = tmp_path / "nompl.yaml"
    path.write_text(yaml.dump(cfg))
    code = (
        "import sys\n"
        "for m in ('jax', 'pandas', 'yaml', 'matplotlib', 'panagram_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from panagram_tpu_torch.__main__ import main\n"
        f"main(['intros', {str(path)!r}])\n"
        "try:\n"
        f"    main(['intros', 'heatmap', '--index-dir', "
        f"{str(example['idx']['jax'])!r}, '--anchor', 'OffspringGen1', "
        f"'--out', {str(tmp_path / 'h')!r}])\n"
        "except ImportError as e:\n"
        "    assert 'matplotlib' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('heatmap without matplotlib')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pandas',\n"
        "    'yaml', 'matplotlib', 'panagram_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = tmp_path / "nompl" / "nompl_0.8" / "scored" / "metrics_REF.tsv"
    cfg["general"]["output_dir"] = str(tmp_path / "jax_nompl")
    jax_runner.run_introgression_pipeline(cfg)
    want = tmp_path / "jax_nompl" / "jax_nompl_0.8" / "scored" / "metrics_REF.tsv"
    assert got.read_bytes() == want.read_bytes()


# ------------------------------------------------------------- YAML reader

YAML_TEXTS = [
    """general:
  output_dir: out   # where the calls go
  index_dir: "idx dir"
  tsv: 'group.tsv'
  bin: 1000000
  ref: Reference
  threads: 4
calling:
  run: true
  grp: OFFSPRING
  cmp: [REF]
  thr: [0.8, 0.75]
  gnm: ~
  sft: mean
  ssz: 5
  rmu: null
  ogrp:
    - WT
    - REF
  vis: False
postprocessing:
  run: yes
  act:
  - fgap
  - rmbn
  map:
scoring:
  run: true
  gdt: sim/
  thr: 0.5
  cmp: [WT, 'A B', "x#y"]
""",
    "# a comment\n\ngeneral:\n  bin: 1_000\n  e: 1.0e+3\n  s: 1e3\n"
    "  o: 0o7\n  h: 0x10\n  n: -.5\ncalling:\n  thr: []\n  chr: {}\n",
    "---\na:\n  b:\n    c: 1\n    d: [1, 2.5, ~, true, x]\n  e: -1\nf: it's\n",
]


@pytest.mark.parametrize("text", YAML_TEXTS + list(
    CONFIGS), ids=["hand1", "hand2", "hand3"] + list(CONFIGS))
def test_load_yaml_equals_safe_load(text, example):
    """load_yaml against yaml.safe_load: the runner's configs as yaml.dump
    writes them, and configs as users write them (flow lists, comments,
    ~, quoted strings, indented and unindented block lists)."""
    if text in CONFIGS:
        calling, scoring, post = CONFIGS[text]
        text = yaml.dump(config(example, "out", calling, scoring, post))
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\n", "a: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: >\n  x\n",
    "a:\n  - b: 1\n", "a: [[1]]\n", "a: {b: 1}\n", "a: 2001-12-14\n",
    "a: b: c\n", "just text\n", "a: 1\n  b: 2\n", "a: \"x\\ny\"\n",
    "a: 1:30\n", "? a\n", "a:\n\tb: 1\n", "- 1\n- 2\n", "a: [1, 2\n",
    "a: 'x\n", "a:\n  - 1\n  b: 2\n"])
def test_load_yaml_refuses_what_it_does_not_read(text):
    """Anything outside the subset raises a ValueError naming the line."""
    with pytest.raises(ValueError, match="YAML line"):
        load_yaml(text)
