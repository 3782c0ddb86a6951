"""Anchor cells of multi-chromosome genomes, and the check that holds one
genome's k-mer set at a time against the whole-union computation it
replaced."""

import collections

import numpy as np
import pytest
import torch

from portbench import control
from portbench.kinds import anchor as kind
from portbench.reference import kmers as ref
from portbench.roofline import anchor_chunk_least_bytes
from portbench.tests import check_at_scale
from portbench.tests.test_portbench_faults import (altered_chunk, half_chunk,
                                                   stale)
from portbench.tests.tiny import (CHROMOSOME_BP, CHROMOSOME_CHUNK,
                                  run_chromosomes, run_tiny)

CPU = torch.device("cpu")
CHUNKS = [-(-(bp - 31 + 1) // CHROMOSOME_CHUNK) for bp in CHROMOSOME_BP]


def test_sound_run_is_correct():
    r = run_chromosomes(CPU)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["value"] == 0 == c["limit"] for c in r["checks"].values())


@pytest.mark.gpu
def test_sound_run_is_correct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_chromosomes(torch.device("cuda", 0))
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"


def test_pass_streams_every_chromosome_in_the_genome_chunk(monkeypatch):
    """Each pass makes one stream call a chromosome, in order, each in the
    chunk that Genome._anchor_chunk gives the whole genome."""
    from panagram_tpu_torch.index import Genome
    from panagram_tpu_torch.ops import anchor

    seen, calls = [], []
    rule = Genome._anchor_chunk

    def spy_rule(self):
        seen.append([c[2] for c in self.chrs])
        return rule(self)

    def spy_stream(real):
        def f(codes, nkmers, chunk, *a, **kw):
            calls.append((len(codes), nkmers, chunk))
            return real(codes, nkmers, chunk, *a, **kw)
        return f

    monkeypatch.setattr(Genome, "_anchor_chunk", spy_rule)
    monkeypatch.setattr(anchor, "stream_anchor_chunks",
                        spy_stream(anchor.stream_anchor_chunks))
    cells = []
    r = run_chromosomes(CPU, system=cells.append)
    assert r["correct"]
    positions = [bp - 31 + 1 for bp in CHROMOSOME_BP]
    assert seen and all(s == positions for s in seen)
    passes = len(calls) // 3
    assert calls == [(bp, bp - 30, CHROMOSOME_CHUNK)
                     for bp in CHROMOSOME_BP] * passes
    cell = cells[0]
    assert passes == r["attempted"] + cell.warm_passes
    assert 3 * cell.warm_passes >= kind.WARM_CALLS
    per = collections.Counter((rec[0], rec[2]) for rec in cell.recs)
    assert all(per[i, h] == CHUNKS[h] for i in range(r["attempted"])
               for h in range(3))


def test_chunk_rule_takes_the_largest_chromosome():
    """The rule over every chromosome, not the first one alone."""
    assert kind.program_chunk([300_000, 600_000]) == 1 << 20
    assert kind.program_chunk([600_000, 300_000]) == 1 << 20
    assert kind.program_chunk(300_000) == 1 << 19


def skip_chromosome(real):
    """The genome's second chromosome never streamed."""
    def f(codes, *a, **kw):
        return iter(()) if len(codes) == CHROMOSOME_BP[1] else real(
            codes, *a, **kw)
    return f


def drop_chunk(real):
    """The third chromosome's first chunk left out."""
    def f(codes, *a, **kw):
        for c, item in enumerate(real(codes, *a, **kw)):
            if c or len(codes) != CHROMOSOME_BP[2]:
                yield item
    return f


def alter_bit(real):
    """Genome 0's bit flipped at the third chromosome's first position, as
    produced: its bytes, popcount and column sum agree with each other."""
    def f(codes, *a, **kw):
        for c, (start, m, by, popc, cs) in enumerate(real(codes, *a, **kw)):
            if c == 0 and len(codes) == CHROMOSOME_BP[2]:
                by, popc, cs = by.copy(), popc.copy(), cs.copy()
                old = int(by[0, 0] & 1)
                by[0, 0] ^= 1
                popc[0] += 1 - 2 * old
                cs[0] += 1 - 2 * old
            yield start, m, by, popc, cs
    return f


@pytest.mark.parametrize("fault", [skip_chromosome, drop_chunk, alter_bit])
def test_chromosome_fault_is_refused(fault, monkeypatch):
    from panagram_tpu_torch.ops import anchor

    monkeypatch.setattr(anchor, "stream_anchor_chunks",
                        fault(anchor.stream_anchor_chunks))
    r = run_chromosomes(CPU)
    assert not r["correct"] and r["failed"] == r["attempted"]
    bad = {n: c["value"] for n, c in r["checks"].items() if c["value"]}
    want = {skip_chromosome: {"bad_chunks"}, drop_chunk: {"bad_chunks"},
            alter_bit: {"bad_colsums"}}[fault]
    assert want <= set(bad)


def test_control_is_refused():
    cells = []
    r = run_chromosomes(CPU, system=lambda c: (control.control(c),
                                                cells.append(c)))
    assert not r["correct"] and r["failed"] > 0
    # the control's dictionary holds every chromosome's canonical k-mers
    sets = control._GenomeSets(cells[0])
    assert sets[0].numel() == torch.unique(torch.cat([
        ref.kmer_set(torch.from_numpy(c), 31) for c in cells[0].chrs[0]
    ])).numel()


def union_check(cell, least_bytes: bool):
    """The check as the harness made it before it took several
    chromosomes: every genome's set at once, their union and the masks,
    each chunk's rows from them (a genome is one chromosome)."""
    dev, k, n, nb = cell.device, cell.k, cell.n, cell.nbytes
    sets = [ref.kmer_set(torch.from_numpy(g).to(dev), k)
            for g in cell.genomes]
    keys = ref.union_keys(sets)
    mask = ref.masks(keys, sets)
    groups = collections.defaultdict(list)
    chunks_of = collections.Counter()
    for rec in cell.recs:
        groups[rec[1], rec[3]].append(rec)
        chunks_of[rec[0], rec[1]] += 1
    bad = {"bad_chunks": 0, "bad_colsums": 0, "bad_bytes": 0,
           "bad_popcounts": 0}
    failed = set()
    chunk = cell.chunks[0]
    for (i, e), got in chunks_of.items():
        want = -(-(len(cell.genomes[e]) - k + 1) // chunk)
        if got != want:
            bad["bad_chunks"] += abs(want - got)
            failed.add(i)
    lb = 0
    for (e, c), recs in groups.items():
        codes = cell.genomes[e]
        start = c * chunk
        m = min(chunk, len(codes) - k + 1 - start)
        if m <= 0:
            bad["bad_chunks"] += len(recs)
            failed.update(r[0] for r in recs)
            continue
        win = torch.from_numpy(codes[start:start + m + k - 1]).to(dev)
        words, valid = ref.kmer_words(win, k)
        rows = ref.rows(words, valid, keys, mask)
        full = ref.row_bytes(rows)
        cs = ref.column_sums(rows, n).cpu().numpy()
        if least_bytes:
            d = torch.unique(words[valid])
            at = torch.searchsorted(keys, d).clamp_(max=keys.shape[0] - 1)
            hits = int((keys[at] == d).sum())
            lb += len(recs) * anchor_chunk_least_bytes(
                m, k, d.shape[0], hits, n)
        for r in recs:
            if (r[4], r[5]) != (start, m):
                bad["bad_chunks"] += 1
                failed.add(r[0])
                continue
            ix = torch.from_numpy(cell.sample_at(r[6], m))
            nbad = [int((r[9].astype(np.int64) != cs).sum()),
                    int((r[7] != full[ix, :nb].numpy()).any(1).sum()),
                    int((r[8] != ref.popcount(full[ix]).numpy()).sum())]
            bad["bad_colsums"] += nbad[0]
            bad["bad_bytes"] += nbad[1]
            bad["bad_popcounts"] += nbad[2]
            if any(nbad):
                failed.add(r[0])
    return {name: (v, 0) for name, v in bad.items()}, len(failed), lb


@pytest.mark.parametrize("held", ["all", "one"])
@pytest.mark.parametrize("fault", [None, stale, half_chunk, altered_chunk])
@pytest.mark.parametrize("name", ["pan30_k31.anchor_member",
                                  "pan100_k21.anchor_member"])
def test_check_equals_the_whole_union(name, fault, held, monkeypatch):
    """Every number, the failed count and the least bytes equal the
    whole-union computation's to the integer, with every set held at
    once, or with one set held and one chunk searched at a time."""
    from panagram_tpu_torch.ops import anchor

    if fault is not None:
        monkeypatch.setattr(anchor, "_anchor_chunk_padded",
                            fault(anchor._anchor_chunk_padded))
    if held == "one":
        monkeypatch.setattr(kind, "SETS_SHARE", 0)
        monkeypatch.setattr(kind, "BATCH_POSITIONS", 1)
    cells = []
    r = run_tiny(name, CPU, system=cells.append)
    cell = cells[0]
    got = cell.check(least_bytes=True)
    numbers, failed, lb = union_check(cell, True)
    assert got.numbers == numbers and got.failed == failed == r["failed"]
    assert got.least_bytes == lb > 0
    assert r["checks"] == {n: {"value": v, "limit": lim}
                           for n, (v, lim) in numbers.items()}
    assert (fault is None) == r["correct"]


def test_rehearsal_at_a_tiny_size(monkeypatch):
    """The scale rehearsal's path: one pass a member, every chunk
    checked against records of zeros."""
    from panagram_tpu_torch import index

    monkeypatch.setattr(index, "ANCHOR_CHUNK", CHROMOSOME_CHUNK)
    out = check_at_scale.rehearse(3, CHROMOSOME_BP, 7, CPU, lambda _m: None)
    assert out["chunks"] == 3 * sum(CHUNKS)
    assert out["positions"] == 3 * sum(bp - 30 for bp in CHROMOSOME_BP)
    assert out["checks"]["bad_chunks"] == 0
    assert out["checks"]["bad_colsums"] > 0 and out["least_bytes"] > 0
