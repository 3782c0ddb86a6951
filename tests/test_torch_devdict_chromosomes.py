"""The device dictionary builder over genomes of several chromosomes, its
packing on the device against the host's, and its spans and counters.

CPU tests (pack_bases and pack_mix run their plain torch versions), but
for one marked `gpu`, which skips without a card.  The module imports no
jax at its top (the comparison with panagram_tpu's builder imports it in
its test), so the card's case also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_devdict_chromosomes.py

Genomes come from numpy with fixed seeds; keys and masks are integer, so
every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from panagram_tpu_torch import spans
from panagram_tpu_torch.ops import devdict, kernels
from panagram_tpu_torch.ops.codec import pack_bases_np
from panagram_tpu_torch.ops.lookup import mix64_np
from panagram_tpu_torch.ops.ref_impl import build_dict_np, genome_kmer_set

K = 31
NGENOMES = 6
# bp of each chromosome: the third is shorter than k, so it adds nothing
CHROMOSOME_BP = [2500, 1800, 20, 3100]
WALL_KEYS = {"pack", "chunk_dispatch", "union_dispatch", "merge_dispatch",
             "sync", "first_sync", "flushes"}
SPAN_NAMES = {"devdict.pack", "devdict.chunk", "devdict.union",
              "devdict.merge", "devdict.sync", "devdict.grow"}


def founder_genomes(n=NGENOMES, lengths=CHROMOSOME_BP, seed=21):
    """n genomes, each a list of chromosome code arrays: per chromosome
    one random base, four founders at 1% divergence from it, genome g
    founder g % 4 with 0.1% private changes; N runs in two chromosomes."""
    rng = np.random.default_rng(seed)
    per_chromosome = []
    for bp in lengths:
        base = rng.integers(0, 4, bp).astype(np.uint8)
        founders = []
        for _ in range(4):
            f = base.copy()
            at = rng.random(bp) < 0.01
            f[at] = rng.integers(0, 4, int(at.sum()))
            founders.append(f)
        genomes = []
        for g in range(n):
            c = founders[g % 4].copy()
            at = rng.random(bp) < 0.001
            c[at] = rng.integers(0, 4, int(at.sum()))
            genomes.append(c)
        per_chromosome.append(genomes)
    genomes = [list(chrs) for chrs in zip(*per_chromosome)]
    genomes[1][1][300:360] = 4
    genomes[4][3][1000:1005] = 4
    genomes[4][3][2000] = 4
    return genomes


def positions(chromosomes) -> int:
    return sum(max(len(c) - K + 1, 0) for c in chromosomes)


def chunks(chromosomes, chunk: int) -> int:
    """The builder's chunks of one genome: each chromosome of n >= 1
    positions in chunks of min(chunk, n)."""
    out = 0
    for c in chromosomes:
        n = len(c) - K + 1
        if n > 0:
            out += -(-n // min(chunk, n))
    return out


def build(genomes, chunk: int, device="cpu", capacity_hint=None):
    """The builder's calls of the `index --device-dict` route: each genome's
    chromosomes in order, then its count."""
    b = devdict.DeviceDictBuilder(K, len(genomes), chunk=chunk,
                                  capacity_hint=capacity_hint, device=device)
    for gid, chrs in enumerate(genomes):
        for c in chrs:
            b.add_sequence(gid, c)
        b.synced_count()
    return b


def host_packing(calls: list):
    """kernels.pack_bases' contract through codec.pack_bases_np on the
    host, the builder's packing before it packed on the device; counts its
    calls in `calls`."""
    def pack(codes, nvalid, L, out):
        buf = np.full(L, 255, np.uint8)
        buf[:nvalid] = codes[:nvalid].cpu().numpy()
        packed, nmask, _ = pack_bases_np(buf)
        n4 = len(packed)
        out[:n4] = torch.from_numpy(packed).to(out.device)
        out[n4:n4 + len(nmask)] = torch.from_numpy(nmask).to(out.device)
        calls.append(L)
        return out
    return pack


def oracle(genomes):
    """The plain dictionary: the union of each genome's set over all its
    chromosomes, in mixed space, keys in unsigned order."""
    keys, masks = build_dict_np([genome_kmer_set(chrs, K) for chrs in genomes])
    mixed = mix64_np(keys)
    order = np.argsort(mixed)
    return mixed[order], masks[order]


@pytest.mark.parametrize("chunk", [256, 1024])
def test_chromosomes_match_jax_and_the_plain_union(chunk):
    """Keys and masks of six founder genomes of four chromosomes (one
    shorter than k, two with N runs) equal panagram_tpu's builder's and
    the plain union of per-genome sets; so do the flushes."""
    from panagram_tpu.ops import devdict as jdd

    genomes = founder_genomes()
    jb = jdd.DeviceDictBuilder(K, NGENOMES, chunk=chunk)
    for gid, chrs in enumerate(genomes):
        for c in chrs:
            jb.add_sequence(gid, c)
        jb.synced_count()
    b = build(genomes, chunk)
    jd, d = jb.to_host(), b.to_host()
    want_keys, want_masks = oracle(genomes)
    assert len(d) == len(want_keys) > positions(genomes[0]) // 2
    assert d.key_space == jd.key_space == "mixed"
    assert np.array_equal(d.keys, jd.keys)
    assert np.array_equal(d.masks, jd.masks)
    assert np.array_equal(d.keys, want_keys)
    assert np.array_equal(d.masks, want_masks)
    assert b.walls["flushes"] == jb.walls["flushes"] >= NGENOMES


@pytest.mark.parametrize("chunk", [64, 700, 1 << 22])
def test_device_packing_equals_host_packing(chunk, monkeypatch):
    """The builder packing its chunks through kernels.pack_bases gives the
    dictionary of the host's pack_bases_np, bit for bit: whole arrays,
    capacity padding included; one packing a chunk either way."""
    genomes = founder_genomes(seed=22)
    calls = []
    with monkeypatch.context() as mp:
        mp.setattr(kernels, "pack_bases", host_packing(calls))
        want = build(genomes, chunk, capacity_hint=1 << 10)
    got = build(genomes, chunk, capacity_hint=1 << 10)
    assert len(calls) == sum(chunks(chrs, chunk) for chrs in genomes)
    assert torch.equal(got.keys, want.keys)
    assert torch.equal(got.masks, want.masks)
    assert got.count == want.count > 0


def spy_merges(monkeypatch) -> list:
    """Each _merge_into call's concatenated rows."""
    rows = []
    real = devdict._merge_into

    def merge(keys, masks, new_keys, *a, **kw):
        rows.append(keys.shape[0] + new_keys.shape[0])
        return real(keys, masks, new_keys, *a, **kw)
    monkeypatch.setattr(devdict, "_merge_into", merge)
    return rows


def spy_growth(monkeypatch) -> list:
    """The capacity before and after each _ensure_capacity that grows."""
    grown = []
    real = devdict.DeviceDictBuilder._ensure_capacity

    def ensure(self, needed):
        before = 0 if self.keys is None else self.keys.shape[0]
        real(self, needed)
        if self.keys.shape[0] != before:
            grown.append((before, self.keys.shape[0]))
    monkeypatch.setattr(devdict.DeviceDictBuilder, "_ensure_capacity",
                        ensure)
    return grown


@pytest.mark.parametrize("chunk", [128, 1 << 22])
def test_spans_and_counters_count_the_steps(chunk, monkeypatch):
    """Under a recording: a pack and a chunk span a chunk, a union, a merge
    and a sync a flush, a grow each time the arrays grow; devdict.positions
    the genomes' positions, devdict.flushes the merges, devdict.merged_rows
    the rows the merges sorted.  No device pairs on the CPU."""
    genomes = founder_genomes(seed=23)
    rows, grown = spy_merges(monkeypatch), spy_growth(monkeypatch)
    with spans.recording() as rec:
        b = build(genomes, chunk, capacity_hint=1 << 10)
    tot = rec.totals()
    t, ctr = tot["spans"], tot["counters"]
    nchunks = sum(chunks(chrs, chunk) for chrs in genomes)
    flushes = b.walls["flushes"]
    assert flushes == len(rows) >= NGENOMES
    assert len(grown) >= 2 and grown[0][0] == 0
    assert {n: t[n]["count"] for n in t} == {
        "devdict.pack": nchunks, "devdict.chunk": nchunks,
        "devdict.union": flushes, "devdict.merge": flushes,
        "devdict.sync": flushes, "devdict.grow": len(grown)}
    assert ctr == {"devdict.positions": sum(map(positions, genomes)),
                   "devdict.flushes": flushes,
                   "devdict.merged_rows": sum(rows)}
    assert all(t[n]["device_s"] is None for n in t)
    assert all(r.parent is None for r in rec.spans)


def test_positions_counter_is_each_genomes_positions():
    """devdict.positions, read genome by genome, is that genome's k-mer
    positions over all its chromosomes (the one shorter than k adds
    none)."""
    genomes = founder_genomes(seed=24)
    b = devdict.DeviceDictBuilder(K, NGENOMES, chunk=512, device="cpu")
    got = []
    for gid, chrs in enumerate(genomes):
        with spans.recording() as rec:
            for c in chrs:
                b.add_sequence(gid, c)
            b.synced_count()
        got.append(rec.totals()["counters"]["devdict.positions"])
    assert got == [positions(chrs) for chrs in genomes]
    assert got[0] == sum(bp - K + 1 for bp in CHROMOSOME_BP if bp >= K)


def test_no_recording_records_nothing(monkeypatch):
    """With no recording open the builder enters no profiler range and
    counts nothing; its spans that feed `walls` still time on the host
    (CPU), and those without `phase` are the shared null context."""
    assert spans.span("devdict.grow") is spans.span("x")

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    genomes = founder_genomes(seed=25)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        b = build(genomes, 512)
    names = {e.name for e in prof.events()}
    assert not [n for n in names if n.startswith("devdict.")], names
    assert b.walls["flushes"] >= NGENOMES
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_recording_annotates_the_profiler():
    """With a recording open the profiler's trace holds the builder's span
    names."""
    genomes = founder_genomes(seed=26)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.recording():
            build(genomes, 256, capacity_hint=1 << 10)
    assert SPAN_NAMES <= {e.name for e in prof.events()}


@pytest.mark.parametrize("record", [False, True])
def test_walls_keep_their_keys(record):
    """`walls` holds the keys the pipeline's log line and bigdict_run read,
    each step's seconds filled with or without a recording; on the CPU each
    equals its span's host seconds."""
    genomes = founder_genomes(seed=27)
    if record:
        with spans.recording() as rec:
            b = build(genomes, 256)
    else:
        b = build(genomes, 256)
    w = b.walls
    assert set(w) == WALL_KEYS
    assert w["flushes"] >= NGENOMES
    for key in ("pack", "chunk_dispatch", "union_dispatch",
                "merge_dispatch", "sync"):
        assert w[key] > 0, key
    assert 0 <= w["first_sync"] <= w["sync"]
    if record:
        t = rec.totals()["spans"]
        for key, name in (("pack", "devdict.pack"),
                          ("chunk_dispatch", "devdict.chunk"),
                          ("union_dispatch", "devdict.union"),
                          ("merge_dispatch", "devdict.merge"),
                          ("sync", "devdict.sync")):
            assert w[key] == pytest.approx(t[name]["host_s"], rel=1e-9)


@pytest.mark.gpu
def test_device_packing_on_the_card():
    """On the card the builder launches pack_bases once a chunk and builds
    what the host's packing builds, bit for bit; under a recording its
    device spans read their event pairs, and `walls` gets the card's
    seconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest -m "
                    "gpu tests/test_torch_devdict_chromosomes.py on the card")
    dev = torch.device("cuda")
    genomes = founder_genomes(seed=28)
    for chunk in (64, 700, 1 << 22):
        calls = []
        mp = pytest.MonkeyPatch()
        mp.setattr(kernels, "pack_bases", host_packing(calls))
        try:
            want = build(genomes, chunk, device=dev, capacity_hint=1 << 10)
        finally:
            mp.undo()
        before = kernels.launches["pack_bases"]
        with spans.recording() as rec:
            got = build(genomes, chunk, device=dev, capacity_hint=1 << 10)
        nchunks = sum(chunks(chrs, chunk) for chrs in genomes)
        assert kernels.launches["pack_bases"] - before == nchunks == len(calls)
        assert torch.equal(got.keys, want.keys)
        assert torch.equal(got.masks, want.masks)
        t = rec.totals()["spans"]
        for name in ("devdict.chunk", "devdict.union", "devdict.merge"):
            assert t[name]["device_s"] is not None and t[name]["device_s"] > 0
        assert t["devdict.pack"]["device_s"] is None
        assert got.walls["merge_dispatch"] == pytest.approx(
            t["devdict.merge"]["device_s"], rel=1e-6)
