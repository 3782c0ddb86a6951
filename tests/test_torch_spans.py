"""panagram_tpu_torch.spans: the recorder, and the spans and counters of the
anchor stream and the build.

CPU tests, but for one marked `gpu` (the device spans of the stream and
the build), which skips without a card.  This module imports no jax, so it
also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_spans.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from panagram_tpu_torch import spans
from panagram_tpu_torch.ops import anchor, count, dictionary
from panagram_tpu_torch.ops.lookup import TILE_Q, BucketedDict

K = 21
STREAM_SPANS = ("anchor.alloc", "anchor.pack", "anchor.dispatch",
                "anchor.drain", "anchor.copyback")
BUILD_SPANS = ("count.upload", "count.unique", "count.readback",
               "dict.upload", "dict.merge", "dict.readback", "layout.upload")


def _genomes(n=5, L=6000, seed=5):
    """n related genomes (a shared ancestor, 2% of bases changed each, a
    run of N in the first) as code arrays."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, L).astype(np.uint8)
    out = []
    for _ in range(n):
        g = base.copy()
        at = rng.choice(L, L // 50, replace=False)
        g[at] = rng.integers(0, 4, len(at)).astype(np.uint8)
        out.append(g)
    out[0][100:140] = 4
    return out


@pytest.fixture(scope="module")
def built():
    genomes = _genomes()
    sets = [count.distinct_kmers_chunked([g], K, device="cpu")
            for g in genomes]
    pan = dictionary.build_dictionary(sets, K, len(genomes), device="cpu")
    bd = BucketedDict.build_device(pan.keys, pan.masks, len(genomes), K,
                                   device="cpu")
    return genomes, bd


def _stream(built, chunk, phase=None, trace=False, device="cpu"):
    genomes, bd = built
    if device != "cpu":
        bd = bd.to(device)
    codes = genomes[0]
    nk = len(codes) - K + 1
    return [(s, m, by.copy(), p.copy(), c.copy())
            for s, m, by, p, c in anchor.stream_anchor_chunks(
                codes, nk, chunk, None, bd.table, bd, 1, len(genomes), K,
                trace=trace, phase=phase)], nk


def _names(prof) -> set:
    return {e.name for e in prof.events()}


def test_no_recording_records_nothing(built, monkeypatch):
    """With no recording open a span is one shared null context: under a
    running profiler the stream leaves no program annotation, a device span
    records no CUDA event, and a counter counts nothing."""
    assert spans.span("a") is spans.span("b", device=True)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with spans.span("x", device=True):
        spans.count("x.n", 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _stream(built, 2048)
    names = _names(prof)
    assert not [n for n in names if n.split(".")[0] in
                ("anchor", "count", "dict", "layout")], names


def test_recording_annotates_the_profiler(built):
    """With a recording open each span is a record_function range, so the
    profiler's trace holds the program's span names."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.recording():
            _stream(built, 2048)
    assert set(STREAM_SPANS) <= _names(prof)


def test_phase_span_adds_its_seconds():
    """A span given `phase` adds its host seconds to phase[key] with or
    without a recording, and records only inside one."""
    phase = {"pack": 0.0}
    with spans.span("p", phase=phase, key="pack"):
        time.sleep(0.01)
    assert phase["pack"] >= 0.01
    with spans.recording() as rec:
        with spans.span("p", phase=phase, key="pack"):
            time.sleep(0.01)
    assert phase["pack"] >= 0.02
    (row,) = rec.spans
    t = rec.totals()["spans"]["p"]
    assert t["count"] == 1 and t["device_s"] is None
    assert t["host_s"] == (row.end_ns - row.start_ns) / 1e9 >= 0.01


def test_nesting_gives_parents_and_self_time():
    with spans.recording() as rec:
        with spans.span("outer"):
            time.sleep(0.002)
            with spans.span("inner"):
                time.sleep(0.005)
            with spans.span("inner"):
                with spans.span("leaf"):
                    time.sleep(0.001)
    outer, in1, in2, leaf = rec.spans
    assert [r.name for r in rec.spans] == ["outer", "inner", "inner", "leaf"]
    assert outer.parent is None
    assert in1.parent == in2.parent == outer.id and leaf.parent == in2.id
    ns = {r.id: r.end_ns - r.start_ns for r in rec.spans}
    t = rec.totals()["spans"]
    assert t["inner"]["count"] == 2
    assert t["outer"]["self_s"] == pytest.approx(
        (ns[outer.id] - ns[in1.id] - ns[in2.id]) / 1e9, abs=1e-12)
    assert t["inner"]["self_s"] == pytest.approx(
        (ns[in1.id] + ns[in2.id] - ns[leaf.id]) / 1e9, abs=1e-12)
    assert t["leaf"]["self_s"] == t["leaf"]["host_s"]
    assert 0 < t["outer"]["self_s"] < t["outer"]["host_s"]


def test_threads_keep_separate_stacks():
    """Spans open at once in two threads nest under their own thread's
    spans."""
    both = threading.Barrier(2, timeout=10)

    def work(tag):
        with spans.span(f"outer.{tag}"):
            both.wait()
            with spans.span(f"inner.{tag}"):
                both.wait()

    with spans.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    by_name = {r.name: r for r in rec.spans}
    for tag in "ab":
        outer, inner = by_name[f"outer.{tag}"], by_name[f"inner.{tag}"]
        assert outer.parent is None and inner.parent == outer.id
        assert inner.thread == outer.thread
    assert by_name["outer.a"].thread != by_name["outer.b"].thread


def test_counters_add_only_inside_a_recording():
    spans.count("c", 5)
    with spans.recording() as rec:
        spans.count("c", 2)
        spans.count("c", 3)
        spans.count("d", 1)
    spans.count("c", 7)
    assert rec.totals()["counters"] == {"c": 5, "d": 1}
    with spans.recording() as again:
        pass
    assert again.totals() == {"spans": {}, "counters": {}}
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass


@pytest.mark.parametrize("chunk", [2048, 4096, 1 << 13])
def test_stream_under_a_recording(built, chunk):
    """The stream on the CPU under a recording yields what it yields
    without one, records one anchor.alloc a call and one pack, dispatch
    and drain a chunk, counts its positions exactly, and its phase["pack"]
    is the anchor.pack spans' host sum."""
    want, nk = _stream(built, chunk)
    phase = {}
    with spans.recording() as rec:
        got, _ = _stream(built, chunk, phase)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            assert np.array_equal(a, b)
    n = -(-nk // chunk)
    tot = rec.totals()
    t, c = tot["spans"], tot["counters"]
    assert set(t) == set(STREAM_SPANS)
    assert t["anchor.alloc"]["count"] == 1
    for name in STREAM_SPANS[1:]:
        assert t[name]["count"] == n, name
        assert t[name]["device_s"] is None, name
    ppad = -(-chunk // TILE_Q) * TILE_Q
    assert c == {"anchor.positions_yielded": nk,
                 "anchor.positions_computed": n * ppad}
    assert set(phase) == {"pack", "copy"}
    assert phase["pack"] == pytest.approx(t["anchor.pack"]["host_s"],
                                          abs=1e-12)
    assert phase["copy"] == pytest.approx(t["anchor.copyback"]["host_s"],
                                          abs=1e-12)
    by_id = {r.id: r for r in rec.spans}
    for r in rec.spans:
        parent = by_id[r.parent].name if r.parent is not None else None
        assert parent == ("anchor.dispatch" if r.name == "anchor.copyback"
                          else None), r.name


def test_stream_trace_reads_the_drain_span(built, capsys):
    """trace=True prints one drain line a chunk, under a recording too."""
    with spans.recording() as rec:
        _stream(built, 2048, trace=True)
    n = rec.totals()["spans"]["anchor.drain"]["count"]
    assert capsys.readouterr().err.count("drain: start=") == n == 3


def test_build_steps_under_a_recording(built):
    """distinct_kmers_chunked, build_dictionary and
    BucketedDict.build_device on the CPU build what they build without a
    recording, and record one span a step: an upload and a unique a
    window, a unique and a readback a spill, and one upload, merge and
    readback of the dictionary and one upload of its layout."""
    genomes = built[0]
    chunk = 2048
    want = [count.distinct_kmers_chunked([g], K, chunk, device="cpu")
            for g in genomes]
    with spans.recording() as rec:
        sets = [count.distinct_kmers_chunked([g], K, chunk, device="cpu")
                for g in genomes]
    assert all(np.array_equal(s, w) for s, w in zip(sets, want))
    tot = rec.totals()
    t = tot["spans"]
    windows = sum(len(range(0, len(g) - K + 1, chunk)) for g in genomes)
    assert windows == 3 * len(genomes)
    assert {n: t[n]["count"] for n in t} == {
        "count.upload": windows, "count.unique": windows + len(genomes),
        "count.readback": len(genomes)}

    with spans.recording() as rec:
        pan = dictionary.build_dictionary(sets, K, len(genomes),
                                          device="cpu")
        bd = BucketedDict.build_device(pan.keys, pan.masks, len(genomes), K,
                                       device="cpu")
    t = rec.totals()["spans"]
    assert {n: t[n]["count"] for n in t} == {
        n: 1 for n in BUILD_SPANS if not n.startswith("count.")}
    assert all(t[n]["device_s"] is None for n in t)
    assert all(r.parent is None for r in rec.spans)
    assert rec.totals()["counters"] == {}
    assert bd.nbits == built[1].nbits
    assert torch.equal(bd.table, built[1].table)


def test_counted_kmers_take_the_count_spans():
    """counted_kmers_chunked records the count spans: one upload a
    window, a unique a window and a spill, a readback a spill."""
    rng = np.random.default_rng(9)
    reads = [rng.integers(0, 4, 150).astype(np.uint8) for _ in range(400)]
    reads += reads[:200]
    with spans.recording() as rec:
        got = count.counted_kmers_chunked(reads, K, 2, 1024, device="cpu")
    want = count.counted_kmers_chunked(reads, K, 2, 1024, device="cpu")
    assert np.array_equal(got, want) and len(got)
    t = rec.totals()["spans"]
    assert set(t) == {"count.upload", "count.unique", "count.readback"}
    uploads, spills = t["count.upload"]["count"], t["count.readback"]["count"]
    # 600 reads of 150 bases and a separator each: six to a window of
    # 1024 + K - 1 bytes
    assert uploads == 100
    assert spills == -(-uploads // count.SPILL_CHUNKS)
    assert t["count.unique"]["count"] == uploads + spills


@pytest.mark.gpu
def test_device_spans_resolve_on_the_card(built):
    """On the card the stream's copy-back pairs are read by the end of the
    stream and are phase["copy"], with or without a recording; the build's
    device spans are read by the recording's close; no pair stays
    pending."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest -m "
                    "gpu tests/test_torch_spans.py on the card")
    chunk = 2048
    want, nk = _stream(built, chunk)
    phase = {}
    with spans.recording() as rec:
        got, _ = _stream(built, chunk, phase, device="cuda")
        pending = len(spans._PENDING)
    assert pending == 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            assert np.array_equal(a, b)
    t = rec.totals()["spans"]
    n = -(-nk // chunk)
    assert set(t) == set(STREAM_SPANS)
    for name in STREAM_SPANS:
        assert t[name]["count"] == (1 if name == "anchor.alloc" else n)
        assert (t[name]["device_s"] is None) == (name != "anchor.copyback")
    assert t["anchor.copyback"]["device_s"] > 0
    assert phase["copy"] == pytest.approx(t["anchor.copyback"]["device_s"],
                                          abs=1e-12)
    # without a recording the copy-back's pairs still feed phase, and are
    # all read by the stream's end
    phase = {}
    _stream(built, chunk, phase, device="cuda")
    assert phase["copy"] > 0 and not spans._PENDING

    genomes, bd = built
    with spans.recording() as rec:
        sets = [count.distinct_kmers_chunked([g], K, 2048, device="cuda")
                for g in genomes]
        pan = dictionary.build_dictionary(sets, K, len(genomes),
                                          device="cuda")
        got = BucketedDict.build_device(pan.keys, pan.masks, len(genomes), K,
                                        device="cuda")
    assert not spans._PENDING
    t = rec.totals()["spans"]
    assert set(t) == set(BUILD_SPANS)
    assert all(t[n]["device_s"] is not None and t[n]["device_s"] >= 0
               for n in t)
    assert torch.equal(got.table.cpu(), bd.table)
