"""athal30_k31.anchor_member cut to a tiny size inside this file: its
configuration with 6 genomes of five short chromosomes, built by the
`device_dict` builder, anchored in chunks of CHUNK positions (the index's
largest anchor chunk, index.ANCHOR_CHUNK, patched), on the CPU."""

from unittest import mock

import numpy as np
import pytest
import torch

from portbench import control, kinds, run
from portbench.builders import count_merge, device_dict
from portbench.kinds import anchor as kind
from portbench.reference import kmers as ref
from portbench.tests.test_portbench_faults import (altered_chunk, half_chunk,
                                                   stale)
from portbench.tests.tiny import SPEC, JoinedBuilder

CPU = torch.device("cpu")
NAME = "athal30_k31.anchor_member"
CHROMOSOME_BP = [4000, 2500, 3300, 2000, 3000]
CHUNK = 1536
NEW_METRICS = ("setup.devdict.merge_share", "setup.devdict.pack_share",
               "setup.devdict.rows_per_key")


def tiny_athal():
    """(cfg, mix): the cell's configuration and mix at a test's size."""
    _cell, cfg, mix = run.cell_spec(SPEC, NAME)
    cfg = dict(cfg, genomes=6, chromosome_bp=CHROMOSOME_BP)
    mix = dict(mix, sample_positions=64)
    return cfg, mix


def run_athal(seconds: float = 0.3, trace: bool = False, system=None,
              seed: int = 2**31 + 2121, device=CPU) -> dict:
    from panagram_tpu_torch import index

    cfg, mix = tiny_athal()
    with mock.patch.object(index, "ANCHOR_CHUNK", CHUNK):
        return run.run_cell(NAME, cfg, mix,
                            run.cell_metrics(SPEC, NAME, trace), seed,
                            seconds, trace, device, system=system)


def test_the_configuration_is_the_cells():
    """The cell's configuration: TAIR10's five chromosomes, 30 genomes at
    k = 31 from founder_chromosomes, built by device_dict; the cut here
    changes only the counts and lengths."""
    _cell, cfg, mix = run.cell_spec(SPEC, NAME)
    assert cfg["chromosome_bp"] == [30427671, 19698289, 23459830, 18585056,
                                    26975502]
    assert sum(cfg["chromosome_bp"]) == 119_146_348
    assert (cfg["genomes"], cfg["k"], cfg["generator"], cfg["builder"]) == (
        30, 31, "founder_chromosomes", "device_dict")
    assert "genome_bp" not in cfg and cfg["reduced"] == []
    assert mix["kind"] == "anchor"
    small, _ = tiny_athal()
    assert {k for k in cfg if cfg[k] != small[k]} == {"genomes",
                                                      "chromosome_bp"}


def test_sound_run_is_correct():
    r = run_athal()
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["value"] == 0 == c["limit"] for c in r["checks"].values())
    assert set(r["metrics"]) == {"anchor_kmers_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [stale, half_chunk, altered_chunk])
def test_anchor_fault_is_refused(fault, monkeypatch):
    from panagram_tpu_torch.ops import anchor

    monkeypatch.setattr(anchor, "_anchor_chunk_padded",
                        fault(anchor._anchor_chunk_padded))
    r = run_athal()
    assert not r["correct"] and r["failed"] > 0


def test_control_is_refused():
    r = run_athal(system=control.control)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["bad_bytes"]["value"] > 0


def answers(bd, table, queries):
    from panagram_tpu_torch.ops import lookup

    return lookup.bucket_query_sorted(queries, table, bd.nbits, bd.cap,
                                      bd.nwords)


def test_table_answers_every_key_as_count_merge_does():
    """The device_dict table answers every key of the genomes' union with
    its presence row, and as many absent keys with zeros, as count_merge's
    table of the same genomes joined by an N answers them; its key count is
    the union's."""
    cfg, _mix = tiny_athal()
    genomes = kinds.genomes(cfg)
    bd, table, pan = device_dict.build(genomes, cfg, CPU)
    assert pan.key_space == "mixed" and bd.nwords == 1
    jbd, jtable, _ = JoinedBuilder.build(genomes, dict(cfg,
                                                       builder="count_merge"),
                                         CPU)
    sets = [kind.genome_set(kind.chromosomes(g), cfg["k"], CPU)
            for g in genomes]
    keys = ref.union_keys(sets)
    assert device_dict.LAST["keys"] == keys.shape[0] == len(pan)
    rng = np.random.default_rng(5)
    words, valid = ref.kmer_words(torch.from_numpy(
        rng.integers(0, 4, 3 * keys.shape[0], dtype=np.uint8)), cfg["k"])
    words = torch.unique(words[valid])
    at = torch.searchsorted(keys, words).clamp_(max=keys.shape[0] - 1)
    absent = words[keys[at] != words][:keys.shape[0]]
    assert absent.shape[0] == keys.shape[0]
    queries = torch.cat([keys, absent])
    want = torch.cat([ref.masks(keys, sets),
                      torch.zeros(absent.shape[0], 1, dtype=torch.int32)])
    got = answers(bd, table, queries)
    assert torch.equal(got, want)
    assert torch.equal(answers(jbd, jtable, queries), got)


def test_traced_run_reads_the_new_metrics():
    """A traced run reports every per-layer metric of the cell the CPU
    has, the three set-up metrics among them, each within its range."""
    r = run_athal(trace=True)
    assert r["correct"]
    got = r["metrics"]
    assert set(NEW_METRICS) <= set(got)
    assert {"anchor.pack_share", "anchor.pass_p95_ms"} <= set(got)
    for name in NEW_METRICS[:2]:
        assert 0 < got[name]["value"] < 100
        assert got[name]["unit"] == "%"
    assert got["setup.devdict.rows_per_key"]["value"] >= 1
    assert got["setup.devdict.rows_per_key"]["unit"] == "rows/key"


@pytest.mark.gpu
def test_sound_run_on_card_reads_every_metric():
    """On the card: correct, untraced and traced, and the traced run
    reports every per-layer metric of the cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    r = run_athal(device=dev)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in
                                 run.cell_metrics(SPEC, NAME, False)}
    r = run_athal(device=dev, trace=True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in
                                 run.cell_metrics(SPEC, NAME, True)}
    assert r["metrics"]["setup.devdict.merge_share"]["value"] > 0


def test_new_metrics_read_nothing_without_the_programs_spans(monkeypatch):
    """On a program whose builder records no devdict spans or counters (as
    before they were added), or with no build recorded, the three metrics
    give None."""
    ctx = mock.Mock(kind="anchor", setup_s=10.0)
    monkeypatch.setattr(device_dict, "LAST", None)
    assert all(run.reader(n)(ctx) is None for n in NEW_METRICS)
    monkeypatch.setattr(device_dict, "LAST", {
        "totals": {"spans": {"layout.upload": {"count": 1, "host_s": 1.0,
                                               "self_s": 1.0,
                                               "device_s": None}},
                   "counters": {}},
        "keys": 100})
    assert all(run.reader(n)(ctx) is None for n in NEW_METRICS)


def test_builder_is_count_merges_on_one_chromosome():
    """A genome given as one array builds the table count_merge builds."""
    cfg, _mix = tiny_athal()
    genomes = [np.concatenate(g) for g in kinds.genomes(cfg)]
    bd, table, pan = device_dict.build(genomes, cfg, CPU)
    cbd, ctable, cpan = count_merge.build(genomes, cfg, CPU)
    assert len(pan) == len(cpan)
    keys = torch.from_numpy(cpan.keys.view(np.int64))
    assert torch.equal(answers(bd, table, keys), answers(cbd, ctable, keys))
