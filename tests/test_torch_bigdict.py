"""The port's tools/bigdict_run.py and tools/w4_steady.py against the JAX
tools' own steps, on the CPU at small sizes.

bigdict_run.run (device="cpu": the kernels' plain versions) is held to
panagram_tpu's DeviceDictBuilder, bucketed() and stream_anchor_chunks on
JAX's CPU backend over the same genomes (the tool's generator, seed 0): the
key count after each genome, the builder's to_host() keys and masks, the
table and every chunk's bytes, popcounts and column sums.  The oracle that
reads the genomes (ref_impl.genome_sets, distinct_count, truth_rows) is
held to ref_impl's dictionary and anchor_np.  w4_steady.run is held to
panagram_tpu's layout and stream on the same index.  Every comparison is of
integers or bytes, so exact (tolerance 0).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from panagram_tpu.ops import anchor as jax_anchor
from panagram_tpu.ops import devdict as jax_devdict
from panagram_tpu.ops import lookup as jl
from panagram_tpu.ops.dictionary import PanKmerDict as JaxPanKmerDict
from panagram_tpu_torch.ops import devdict, lookup
from panagram_tpu_torch.ops.lookup import BucketedDict
from panagram_tpu_torch.ops.ref_impl import (
    anchor_np,
    build_dict_np,
    canonical_kmers_np,
    distinct_count,
    genome_sets,
    masks_to_bytes_np,
    popcount_np,
    truth_rows,
)
from panagram_tpu_torch.pipeline import build_index
from panagram_tpu_torch.tools import bigdict_run, w4_steady
from panagram_tpu_torch.tools.scale_run import write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)

K = 21


def _jax_table(bd) -> np.ndarray:
    """panagram_tpu's table as this package's [B, stride] numpy uint32."""
    (t,) = bd.device_arrays()
    return BucketedDict.from_jax_state(np.asarray(t), bd.nbits, bd.cap,
                                       bd.stride, bd.ngenomes, bd.k,
                                       bd.nwords).table


def _jax_tool_steps(genomes, k, chunk, anchor_codes):
    """tools/bigdict_run.py's steps on panagram_tpu (its prewarm call
    apart): the builder fed genome by genome with the count synced after
    each, to_host(), bucketed(), then one stream over the anchor."""
    n, glen = len(genomes), len(genomes[0])
    b = jax_devdict.DeviceDictBuilder(k, n, chunk,
                                      capacity_hint=int(n * glen * 1.05))
    counts = []
    for g, codes in enumerate(genomes):
        b.add_sequence(g, codes)
        counts.append(b.synced_count())
    host = b.to_host()
    bd = b.bucketed()
    (t1,) = bd.device_arrays()
    nk = len(anchor_codes) - k + 1
    buf = np.full(chunk + k - 1, 255, np.uint8)
    chunks = [(s, m, by.copy(), p.copy(), c.copy())
              for s, m, by, p, c in jax_anchor.stream_anchor_chunks(
                  anchor_codes, nk, chunk, buf, t1, bd, (n + 7) // 8, n, k,
                  state={})]
    return counts, host, bd, chunks


@pytest.mark.parametrize("ngenomes,mbp,anchor_mbp,chunk", [
    (4, 0.05, 0.115, 1 << 14),      # W=1, an anchor of 2.3 tiles
    (100, 0.0006, 0.00138, 1 << 10),  # W=4, 13 B per position
])
def test_run_matches_the_jax_tool_steps(monkeypatch, capsys, ngenomes, mbp,
                                        anchor_mbp, chunk):
    monkeypatch.setattr(bigdict_run, "CHUNK", chunk)
    kept = {}
    bucketed = devdict.DeviceDictBuilder.bucketed

    def keep_dict(self, **kw):
        kept["dict"], kept["kw"] = self.to_host(), kw
        return bucketed(self, **kw)

    monkeypatch.setattr(devdict.DeviceDictBuilder, "bucketed", keep_dict)
    r = bigdict_run.run(ngenomes, mbp, anchor_mbp, K, device="cpu")
    out = capsys.readouterr().out
    glen = int(mbp * 1e6)
    rng = np.random.default_rng(0)
    genomes = [rng.integers(0, 4, glen, dtype=np.uint8)
               for _ in range(ngenomes)]
    assert all(np.array_equal(a, b) for a, b in zip(r.genomes, genomes))
    reps = -(-int(anchor_mbp * 1e6) // glen)
    anchor = np.tile(genomes[0], reps)[:int(anchor_mbp * 1e6)]
    assert np.array_equal(r.anchor_codes, anchor)

    counts, host, jbd, chunks = _jax_tool_steps(genomes, K, chunk, anchor)
    assert r.D == counts[-1] == len(host.keys)
    printed = [int(c.replace(",", "")) for c in
               re.findall(r"merged genome \d+: ([\d,]+) keys", out)]
    assert printed == counts
    assert kept["dict"].key_space == host.key_space == "mixed"
    assert np.array_equal(kept["dict"].keys, np.asarray(host.keys))
    assert np.array_equal(kept["dict"].masks, np.asarray(host.masks))
    assert (r.nbits, r.cap, r.stride, r.nwords) == (
        jbd.nbits, jbd.cap, jbd.stride, (ngenomes + 31) // 32)
    assert np.array_equal(r.bd.table.numpy().view(np.uint32), _jax_table(jbd))
    assert r.route == r.bd.route == "single" and r.peaks["builder"] is None
    assert kept["kw"] == {"host_layout": False}

    assert len(chunks) == len(r.colsums) > 1
    for (s, m, by, popc, cs), (gs, gm, gcs) in zip(chunks, r.colsums):
        assert (gs, gm) == (s, m)
        assert np.array_equal(r.bytes[s:s + m], by)
        assert np.array_equal(r.popc[s:s + m], popc)
        assert np.array_equal(gcs, cs)
    assert r.popc.sum() == sum(int(c[2].sum()) for c in r.colsums) > 0
    assert len(r.passes) == bigdict_run.PASSES and r.best > 0
    for line in ("anchor warmup (copy-back dense)...", "RESULT: ",
                 f"count+merge: {r.D:,} keys", "(sorted-input device layout, "
                 "route single)"):
        assert line in out, line
    assert len(re.findall(r"anchor rep: [0-9.]+ Mkmers/s \(wall [0-9.]+ s, "
                          r"pack [0-9.]+ s, copy [0-9.]+ s\)", out)) == 3


@pytest.mark.parametrize("ngenomes", [3, 40])
def test_truth_oracle_matches_anchor_np(ngenomes):
    """truth_rows over the genomes' own sets equals anchor_np against
    build_dict_np's dictionary of the same sets, on an anchor tiled from
    genome 0 with an N run (junction windows included); distinct_count
    equals the dictionary's size."""
    rng = np.random.default_rng(ngenomes)
    base = rng.integers(0, 4, 3000, dtype=np.uint8)
    genomes = []
    for _ in range(ngenomes):
        g = base.copy()
        pos = rng.choice(len(g), 60, replace=False)
        g[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        genomes.append(g)
    genomes[1][100:110] = 4
    sets = genome_sets(genomes, K)
    for g, s in zip(genomes, sets):
        canon, valid = canonical_kmers_np(g, K)
        assert np.array_equal(s, np.unique(canon[valid]))
    keys, masks = build_dict_np(sets)
    assert distinct_count(sets) == len(keys)
    anchor = np.tile(genomes[0], 3)[:7000]
    anchor[4000:4005] = 255
    rows = truth_rows(sets, *canonical_kmers_np(anchor, K))
    want = anchor_np(anchor, K, keys, masks)
    assert rows.dtype == np.uint32 and np.array_equal(rows, want)
    nbytes = (ngenomes + 7) // 8
    assert np.array_equal(masks_to_bytes_np(rows, nbytes),
                          masks_to_bytes_np(want, nbytes))
    assert popcount_np(rows).sum() > 0
    assert distinct_count([]) == 0


def test_build_device_lays_out_the_live_rows_of_sorted_input(monkeypatch):
    """Sorted input's padding is its tail: build_device lays out the first
    `count` rows only (the builder's arrays hold up to twice that), and the
    table equals the one from the padded arrays' full layout."""
    rng = np.random.default_rng(5)
    b = devdict.DeviceDictBuilder(K, 3, 1 << 12, capacity_hint=20_000,
                                  device="cpu")
    for g in range(3):
        b.add_sequence(g, rng.integers(0, 4, 5000, dtype=np.uint8))
    n = b.synced_count()
    assert b.keys.shape[0] >= 2 * n
    from panagram_tpu_torch.ops import lookup

    rows = []
    real = lookup._layout_device

    def spy(keys, masks, *args, **kwargs):
        rows.append(keys.shape[0])
        return real(keys, masks, *args, **kwargs)

    monkeypatch.setattr(lookup, "_layout_device", spy)
    bd = b.bucketed()
    assert rows == [n]
    full, ov = real(b.keys, b.masks, bd.nbits, bd.cap, bd.stride,
                    pre_sorted=True)
    assert int(ov) == 0 and torch.equal(bd.table.reshape(-1), full)


@pytest.mark.parametrize("device_dict", [False, True])
def test_w4_steady_matches_panagram_tpu_stream(tmp_path, capsys,
                                               device_dict):
    """A 40-genome index (W=2) built by the port, genome 0 the tool's base
    sequence so that most positions hit, on the default route (canonical
    dictionary) and --device-dict (mixed): w4_steady.run's table equals
    panagram_tpu's build_device over the same pandict.npz, and each rep's
    k-mers, hits and column sums equal panagram_tpu's stream over the same
    sequences."""
    mbp, reps, log2 = 0.008, 2, 12
    L = int(mbp * 1e6)
    base = np.random.default_rng(3).integers(0, 4, L, dtype=np.uint8)
    rng = np.random.default_rng(7)
    (tmp_path / "fa").mkdir()
    names = []
    for g in range(40):
        codes = base.copy()
        if g:
            pos = rng.choice(L, 20 + g, replace=False)
            codes[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        names.append(f"g{g:02d}")
        write_fasta(str(tmp_path / "fa" / f"{names[-1]}.fa"), "chr1", codes)
    (tmp_path / "samples.tsv").write_text("name\tfasta\n" + "".join(
        f"{n}\tfa/{n}.fa\n" for n in names))
    prefix = str(tmp_path / "idx")
    build_index(str(tmp_path / "samples.tsv"), prefix=prefix,
                device_dict=device_dict, device="cpu", k=K,
                anchor_genomes=["g00"])
    capsys.readouterr()

    r = w4_steady.run(prefix, mbp, reps, log2, device="cpu")
    out = capsys.readouterr().out
    d = JaxPanKmerDict.load(os.path.join(prefix, "kmc", "pandict.npz"))
    mixed = d.key_space == "mixed"
    assert mixed == device_dict and (r.ngenomes, r.nwords) == (40, 2)
    pk, pm = jl.pad_pow2(d.keys, d.masks)
    jbd = jl.BucketedDict.build_device(pk, pm, 40, K, mixed=mixed,
                                       count=len(d.keys), sorted_input=mixed)
    assert np.array_equal(r.bd.table.numpy().view(np.uint32), _jax_table(jbd))
    (t1,) = jbd.device_arrays()

    chunk = 1 << log2
    buf = np.empty(chunk + K - 1, np.uint8)
    seqs = list(w4_steady.sequences(L, reps))
    assert len(seqs) == len(r.reps) == reps + 1
    for codes, got in zip(seqs, r.reps):
        total = hits = 0
        colsum = np.zeros(40, np.int64)
        for _s, m, _by, popc, cs in jax_anchor.stream_anchor_chunks(
                codes, L - K + 1, chunk, buf, t1, jbd, 5, 40, K, state={}):
            total += m
            hits += int(np.count_nonzero(popc))
            colsum += cs
        assert (got["kmers"], got["hits"]) == (total, hits)
        assert np.array_equal(got["colsums"], colsum)
        assert hits > 0.9 * total
    assert len(re.findall(r"rep \d: .* hit share 0\.9\d+, column sums over "
                          r"positions", out)) == reps + 1
    assert "W=2 steady: " in out and r.best_mbp_s > 0


def test_main_keeps_the_1e8_assertion(capsys):
    """bigdict_run's main asserts >= 1e8 keys after the count, as the JAX
    tool does; run() itself asserts nothing by default."""
    with pytest.raises(AssertionError, match=r"expected >= 100,000,000 keys, "
                       r"got [\d,]+$"):
        bigdict_run.main(["--genomes", "2", "--mbp", "0.02", "--anchor-mbp",
                          "0.03", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "count+merge: " in out and "bucket table" not in out


def test_tools_import_no_jax():
    """With jax and panagram_tpu unimportable, both tools import and run
    their main on the CPU (bigdict_run up to its 1e8-key assertion)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'panagram_tpu'): sys.modules[m] = None\n"
        "from panagram_tpu_torch.tools import bigdict_run, w4_steady\n"
        "try:\n"
        "    bigdict_run.main(['--genomes', '2', '--mbp', '0.01',\n"
        "                      '--anchor-mbp', '0.01', '--device', 'cpu'])\n"
        "except AssertionError as e:\n"
        "    assert 'expected >= 100,000,000 keys' in str(e), e\n"
        "bigdict_run.CHUNK = 1 << 12\n"
        "r = bigdict_run.run(2, 0.01, 0.015, device='cpu')\n"
        "assert r.D > 0 and r.best > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'panagram_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESULT: " in res.stdout


def test_entry_points_default_to_the_card(monkeypatch):
    """Both tools run on the card unless asked for the CPU: without one,
    their defaults raise before any work."""
    import inspect

    for fn in (bigdict_run.run, w4_steady.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (bigdict_run, w4_steady):
        with pytest.raises(RuntimeError, match="is_available"):
            mod.main([])


def _card_memory(monkeypatch, free, reserved, allocated, split):
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 85 * 10**9))
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: {
        "reserved_bytes.all.current": reserved,
        "allocated_bytes.all.current": allocated,
        "inactive_split_bytes.all.current": split})


def test_free_bytes_counts_the_allocators_cached_blocks(monkeypatch):
    """On a card, the free figure of the budget checks is the card's free
    memory plus the segments torch's caching allocator holds unused.  After
    the 100-genome builder's 100 growing merges the card had 13.4 GB free
    and the allocator ~63 GB unused (NVIDIA H100 80GB HBM3): counting the
    card's figure alone, the 16-GiB W=4 table was refused."""
    gb = 10**8
    _card_memory(monkeypatch, 134 * gb, 660 * gb, 32 * gb, 0)
    assert lookup._free_bytes("cuda", None) == (134 + 660 - 32) * gb
    assert lookup._free_bytes("cpu", None) is None
    assert lookup._free_bytes("cuda", 5) == 5
    D, W = 103_995_512, 4
    assert lookup.layout_route(D, W, "cuda", True) == "single"
    _card_memory(monkeypatch, 134 * gb, 32 * gb, 32 * gb, 0)
    with pytest.raises(RuntimeError, match="13.4 GB are free on cuda"):
        lookup.layout_route(D, W, "cuda", True)


def test_free_bytes_leaves_out_split_blocks(monkeypatch):
    """The free part of a segment that still holds a tensor (an inactive
    split block) cannot be released, so the free figure leaves it out: of
    66 GB reserved and 3.2 GB allocated, 55 GB lie beside live tensors, so
    13.4 + 66 - 3.2 - 55 = 21.2 GB are free: the W=4 table (17.2 GB) and
    the chunk buffers fit, but neither device layout beside them, where
    the figure with those 55 GB had chosen the one-pass layout."""
    gb = 10**8
    _card_memory(monkeypatch, 134 * gb, 660 * gb, 32 * gb, 550 * gb)
    assert lookup._free_bytes("cuda", None) == 212 * gb
    with pytest.raises(RuntimeError, match="21.2 GB are free on cuda"):
        lookup.check_device_budget(20 * 10**9, "cuda", layout=6 * 10**9)
    assert lookup.layout_route(103_995_512, 4, "cuda", True) == "host"
    _card_memory(monkeypatch, 134 * gb, 660 * gb, 32 * gb, 0)
    assert lookup.layout_route(103_995_512, 4, "cuda", True) == "single"


def _sorted_dict(W):
    """A small builder's arrays (sorted in mixed space, padded) and its
    key count, over 32W - 31 genomes."""
    rng = np.random.default_rng(W)
    N = 32 * W - 31
    b = devdict.DeviceDictBuilder(K, N, 1 << 12, capacity_hint=20_000,
                                  device="cpu")
    for g in range(N):
        b.add_sequence(g, rng.integers(0, 4, 3000 // N + 300, dtype=np.uint8))
    return b, b.synced_count(), N


@pytest.mark.parametrize("route", ["single", "chunked", "host"])
def test_build_device_records_its_route(route):
    """build_device's result names the route that laid it out, and the
    three routes lay out the same table (sorted input, free figures that
    leave room for the one-pass layout, for the chunked one alone, or for
    the table alone)."""
    b, n, N = _sorted_dict(1)
    nb, _, st = lookup.table_geometry(n, 1)
    fixed = (1 << nb) * st * 4 + lookup.ANCHOR_RESERVE_BYTES
    free = {"single": None, "chunked": fixed + lookup.layout_bytes(
        n, 1, "chunked", piece_rows=256), "host": fixed}[route]
    bd = BucketedDict.build_device(b.keys, b.masks, N, K, mixed=True,
                                   count=n, sorted_input=True, device="cpu",
                                   free=free, piece_rows=256)
    want = b.bucketed()
    assert (bd.route, want.route) == (route, "single")
    assert torch.equal(bd.table, want.table)


@pytest.mark.parametrize("sorted_input", [False, True])
def test_build_device_without_host_layout_raises_naming_the_budget(
        sorted_input):
    """With host_layout=False, a layout that fits on no device route
    raises naming the table, the smallest device route's transients and
    the free figure; it does not lay out on the host."""
    b, n, N = _sorted_dict(2)
    nb, _, st = lookup.table_geometry(n, 2)
    free = (1 << nb) * st * 4 + lookup.ANCHOR_RESERVE_BYTES
    mode = "chunked" if sorted_input else "sort"
    with pytest.raises(RuntimeError, match=(
            rf"device layout of {n:,} keys x 2 words needs .* \({mode} "
            rf"layout\) .* but {free / 1e9:.1f} GB are free on cpu, and the "
            "host layout was not allowed")):
        BucketedDict.build_device(b.keys, b.masks, N, K, mixed=True,
                                  count=n, sorted_input=sorted_input,
                                  device="cpu", free=free, piece_rows=256,
                                  host_layout=False)
    assert BucketedDict.build_device(
        b.keys[:n], b.masks[:n], N, K, mixed=True, sorted_input=sorted_input,
        device="cpu", free=free, piece_rows=256).route == "host"


def test_run_raises_rather_than_lay_out_on_the_host(monkeypatch):
    """bigdict_run lays the table out on the device or raises: where only
    the host route fits, run() raises naming the budget."""
    monkeypatch.setattr(bigdict_run, "CHUNK", 1 << 12)
    monkeypatch.setattr(devdict, "check_device_budget", lambda *a, **kw: None)
    monkeypatch.setattr(lookup, "layout_route", lambda *a, **kw: "host")
    monkeypatch.setattr(lookup, "_free_bytes", lambda device, free: 10**6)
    with pytest.raises(RuntimeError, match="0.0 GB are free on cpu, and the "
                       "host layout was not allowed"):
        bigdict_run.run(2, 0.01, 0.015, device="cpu")


@pytest.mark.parametrize("ngenomes,mbp,peak", [(4, 26.0, 12.013 * 2**30),
                                               (100, 1.04, 13.610 * 2**30)])
def test_builder_budget_counts_its_merge(monkeypatch, ngenomes, mbp, peak):
    """The device builder's budget check counts its arrays, a flush's
    buffered keys and merge_bytes of the largest merge they allow, at
    least the peak the card measured for tools/bigdict_run.py's builder
    (NVIDIA H100 80GB HBM3: 12.013 GiB at 4 x 26 Mbp, 13.610 GiB at 100 x
    1.04 Mbp); the layout_bytes figure it counted before (5.516 / 8.516
    GiB, the arrays included) fell short.  merge_bytes is (76 + 8W) B per
    concatenated row."""
    from panagram_tpu_torch.ops.lookup import layout_bytes

    assert devdict.merge_bytes(10, 1) == 840
    assert devdict.merge_bytes(10, 4) == 1080
    seen = []

    class Stop(Exception):
        pass

    def check(table, device, what, layout=0, free=None):
        seen.append((table, what, layout))
        raise Stop

    monkeypatch.setattr(devdict, "check_device_budget", check)
    hint = int(ngenomes * mbp * 1e6 * 1.05)
    with pytest.raises(Stop):
        devdict.DeviceDictBuilder(K, ngenomes, capacity_hint=hint,
                                  device="cpu")
    ((table, what, need),) = seen
    W = (ngenomes + 31) // 32
    cap, buffered = 1 << 27, 8 << 22
    assert (table, what) == (0, "device dictionary builder")
    assert need == (8 + 4 * W) * cap + 8 * buffered \
        + devdict.merge_bytes(cap + buffered, W)
    assert need >= peak > layout_bytes(cap, W, "sort")
