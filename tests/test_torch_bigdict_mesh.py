"""The port's tools/bigdict_mesh.py against the JAX tool's own steps, on the
CPU at small sizes, and the mesh repairs that a 1e8-key shard needs.

bigdict_mesh.run(device="cpu") spawns Gloo ranks (parallel.mesh.launch).
At a small size, on 1 and on 4 ranks, its host dictionary, shard geometry
and anchored bytes, popcounts and column sums are held to panagram_tpu's
sharded_build_dictionary, sharded_anchor_chunk, unpack_rle2 and
rle2_colsums on the 8-device virtual CPU mesh of tests/conftest.py, over
the same genomes (the tool's generator, seed 11).  The mid-size leg (~1e6
keys on 8 ranks) is held to the oracle that reads the genomes.  Every
comparison is of integers or bytes, so exact (tolerance 0).  The rank
functions live at module level, so spawned ranks import this module; it
imports no jax at its top, so they do not import it either.
"""

import contextlib
import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from panagram_tpu_torch.ops import lookup
from panagram_tpu_torch.ops.dictionary import merge_sets_bytes
from panagram_tpu_torch.ops.ref_impl import canonical_kmers_np, truth_rows
from panagram_tpu_torch.parallel import mesh as pmesh
from panagram_tpu_torch.parallel import shard
from panagram_tpu_torch.tools import bigdict_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 21
# the small case: 4 genomes of 30 kbp (~1.2e5 keys), 25 kbp anchored in
# chunks of 2^12 positions per rank (7 chunks on one rank, 2 on four)
GENOMES, MBP, ANCHOR_MBP, CPD = 4, 0.03, 0.025, 1 << 12
LAUNCH_TIMEOUT = 240
# the mid-size leg, run(4, 0.26, devices=8, anchor_mbp=2.0): its own limit
MID_LIMIT_S = 180


def _small(S):
    """run() of the small case on S ranks with its printed lines."""
    old, bigdict_mesh.CHUNK_PER_DEV = bigdict_mesh.CHUNK_PER_DEV, CPD
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            r = bigdict_mesh.run(GENOMES, MBP, S, ANCHOR_MBP, K, device="cpu",
                                 timeout=LAUNCH_TIMEOUT)
    finally:
        bigdict_mesh.CHUNK_PER_DEV = old
    return r, out.getvalue()


@pytest.fixture(scope="module")
def ours():
    return {S: _small(S) for S in (1, 4)}


def _jax_steps(S):
    """The JAX tool's steps (tools/bigdict_mesh.py:71-158) on a mesh of S
    virtual CPU devices, in process, with CPD positions per device."""
    import panagram_tpu  # noqa: F401  (x64)
    from panagram_tpu.ops.anchor import rle2_colsums, unpack_rle2
    from panagram_tpu.ops.ref_impl import canonical_kmers_np as jax_canon
    from panagram_tpu.parallel import (
        make_halo_chunks,
        make_mesh,
        sharded_build_dictionary,
    )
    from panagram_tpu.parallel.shard import sharded_anchor_chunk

    glen = int(MBP * 1e6)
    rng = np.random.default_rng(11)
    genomes = [rng.integers(0, 4, glen, dtype=np.uint8)
               for _ in range(GENOMES)]
    sets = []
    for codes in genomes:
        canon, valid = jax_canon(codes, K)
        sets.append(np.unique(canon[valid]))
    mesh = make_mesh(S)
    sbd, pan = sharded_build_dictionary(sets, mesh, ngenomes=GENOMES, k=K,
                                        return_host_dict=True)
    nk_want = int(ANCHOR_MBP * 1e6)
    seq_codes = genomes[0][:nk_want + K - 1]
    by_parts, popc_parts = [], []
    colsums = np.zeros(GENOMES, np.int64)
    pos = 0
    while pos < nk_want:
        span = min(S * CPD, nk_want - pos)
        chunks, nk = make_halo_chunks(seq_codes[pos:pos + span + K - 1], S, K,
                                      chunk_per_dev=CPD)
        combined, counts, C = sharded_anchor_chunk(mesh, sbd, chunks,
                                                   capacity=CPD)
        comb, cnts = np.asarray(combined), np.asarray(counts)
        for dd in range(comb.shape[0]):
            real = min(max(nk - dd * C, 0), C)
            if real == 0:
                break
            by, popc = unpack_rle2(comb[dd], int(cnts[dd]), C,
                                   sbd.nbytes_row)
            by_parts.append(by[:real].copy())
            popc_parts.append(popc[:real].copy())
            colsums += rle2_colsums(comb[dd], int(cnts[dd]), C, GENOMES)
        pos += span
    return {"geometry": (sbd.nbits, sbd.cap, sbd.stride, sbd.n_shards),
            "keys": pan.keys, "masks": pan.masks,
            "bytes": np.concatenate(by_parts)[:nk_want],
            "popc": np.concatenate(popc_parts)[:nk_want],
            "colsums": colsums}


@pytest.fixture(scope="module")
def theirs():
    return {S: _jax_steps(S) for S in (1, 4)}


@pytest.mark.parametrize("S", [1, 4])
def test_dictionary_and_geometry_match_jax(ours, theirs, S):
    """The writer's host dictionary (mixed keys in unsigned order, OR'd
    masks) and each shard's geometry are panagram_tpu's."""
    r, _ = ours[S]
    want = theirs[S]
    assert (r.nbits, r.cap, r.stride, r.n_shards) == want["geometry"]
    assert r.shard_bytes == (1 << r.nbits) * r.stride * 4
    assert r.keys.dtype == want["keys"].dtype == np.uint64
    assert np.array_equal(r.keys, want["keys"])
    assert r.masks.dtype == want["masks"].dtype
    assert np.array_equal(r.masks, want["masks"])
    assert r.D == r.host_D == len(want["keys"])


@pytest.mark.parametrize("S", [1, 4])
def test_anchor_matches_jax(ours, theirs, S):
    """The anchored bytes, popcounts and column sums (several chunks, the
    last rank's rows cut to the real positions) are panagram_tpu's."""
    r, _ = ours[S]
    want = theirs[S]
    assert r.nk == int(ANCHOR_MBP * 1e6)
    assert np.array_equal(r.bytes, want["bytes"])
    assert np.array_equal(r.popc, want["popc"])
    assert np.array_equal(r.colsums, want["colsums"])


@pytest.mark.parametrize("S", [1, 4])
def test_cpu_run_prints_no_budget_claim(ours, S):
    """On the CPU nothing checks a device budget: the line says so and
    prints the model beside the shard; the peaks are each rank's own
    sampled resident set (not its parent's, which a spawned rank's maxrss
    holds);
    the JAX tool's lines come in its order; no rank launches a kernel."""
    r, out = ours[S]
    assert not r.budget_checked
    assert "fits its model" not in out
    lines = out.splitlines()
    order = ["generating", "sharded build: D=", "per-shard table:",
             "budget model per shard:", "rank peaks:",
             "dictionary parity vs host oracle OK", "sharded anchor:",
             "anchored byte parity", "RESULT D="]
    at = [next(i for i, line in enumerate(lines) if line.startswith(p))
          for p in order]
    assert at == sorted(at) and lines[-1].startswith("RESULT D=")
    budget = lines[at[3]]
    assert "no device budget checked" in budget
    assert f"table {r.model['table'] / 2**30:.2f} GiB" in budget
    assert r.model["layout"] == lookup.layout_bytes(
        -(-r.D // S), 1, "bucket", n_buckets=1 << r.nbits)
    assert [what for _, what in r.peaks] == ["host peak RSS"] * S
    assert all(0 < b < 2**31 for b, _ in r.peaks)
    assert len(r.launches) == S
    assert not any(v for launches in r.launches for v in launches.values())


def test_mid_size_leg_on_8_ranks():
    """The mid-size leg: 4 x 0.26 Mbp (~1.04e6 keys) on 8 Gloo ranks, the
    whole genome 0 anchored in one chunk, within MID_LIMIT_S seconds.
    run() holds it to the host oracle; here the anchor is held again to
    the genomes' own sets (truth_rows, which reads no dictionary)."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        r = bigdict_mesh.run(4, 0.26, 8, 2.0, K, device="cpu",
                             timeout=MID_LIMIT_S)
    wall = time.perf_counter() - t0
    assert wall < MID_LIMIT_S, wall
    assert r.D == r.host_D == 1_039_920
    assert (r.n_shards, r.nbits, r.cap, r.stride) == (8, 15, 21, 64)
    rng = np.random.default_rng(11)
    genomes = [rng.integers(0, 4, 260_000, dtype=np.uint8) for _ in range(4)]
    from panagram_tpu_torch.ops.ref_impl import genome_sets

    canon, valid = canonical_kmers_np(genomes[0], K)
    rows = truth_rows(genome_sets(genomes, K), canon, valid)
    assert r.nk == len(canon) == 260_000 - K + 1
    assert np.array_equal(r.bytes[:, 0], rows[:, 0].astype(np.uint8))
    assert np.array_equal(r.popc, np.bitwise_count(rows[:, 0]))
    assert np.array_equal(r.colsums, [int(((rows[:, 0] >> g) & 1).sum())
                                      for g in range(4)])


def test_union_dict_is_build_dict_np():
    """The tool's oracle dictionary (np.sort and a diff, threaded
    searchsorted) is ref_impl.build_dict_np's (np.unique), 40 genomes (two
    mask words) with shared and empty sets."""
    from panagram_tpu_torch.ops.ref_impl import build_dict_np, union_dict

    rng = np.random.default_rng(3)
    pool = rng.integers(0, 1 << 62, 4000, dtype=np.uint64)
    sets = [np.unique(rng.choice(pool, n)) for n in rng.integers(0, 900, 40)]
    sets[7] = np.zeros(0, np.uint64)
    keys, masks = union_dict(sets)
    want_keys, want_masks = build_dict_np(sets)
    assert keys.dtype == np.uint64 and masks.shape == (len(keys), 2)
    assert np.array_equal(keys, want_keys)
    assert np.array_equal(masks, want_masks)


def test_main_prints_the_result_line(capsys):
    """main() with the JAX tool's flags plus --device cpu ends with the
    RESULT line."""
    assert bigdict_mesh.main(["--mbp", "0.01", "--genomes", "3",
                              "--devices", "2", "--anchor-mbp", "0.005",
                              "--device", "cpu"]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("RESULT D=") and " shards=2 " in last


def test_tool_imports_no_jax():
    """With jax and panagram_tpu unimportable, the tool imports and runs
    its main on CPU ranks."""
    code = (
        "import sys\n"
        "for m in ('jax', 'panagram_tpu'): sys.modules[m] = None\n"
        "from panagram_tpu_torch.tools import bigdict_mesh\n"
        "bigdict_mesh.main(['--mbp', '0.01', '--genomes', '2', '--devices',\n"
        "                   '2', '--anchor-mbp', '0.01', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'panagram_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESULT D=" in res.stdout


def test_run_defaults_to_the_card(monkeypatch):
    """run's device defaults to cuda: without a card main([]) raises before
    any work, and with fewer cards than --devices run raises naming the
    count, also before any work."""
    import inspect

    assert inspect.signature(bigdict_mesh.run).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bigdict_mesh.main([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(np.random, "default_rng", None)   # no work
    with pytest.raises(RuntimeError, match="8 ranks .* 1 are visible"):
        bigdict_mesh.run(4, 26.0, 8, device="cuda")


def test_ranks_receive_memory_map_paths(monkeypatch):
    """The ranks get paths to .npy files that map (mmap_mode="r"), never
    the arrays; the temporary directory goes when the run fails."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_launch(fn, args, size, device_type, timeout=None):
        paths, ngenomes, k, apath, workdir, cpd = args
        assert fn is bigdict_mesh._rank and (size, device_type) == (2, "cpu")
        assert not any(isinstance(a, np.ndarray) for a in args)
        for p in paths + [apath]:
            assert isinstance(p, str) and p.startswith(workdir)
            assert isinstance(np.load(p, mmap_mode="r"), np.memmap)
        seen.update(workdir=workdir, n=len(paths), cpd=cpd, k=k)
        raise Stop

    monkeypatch.setattr(pmesh, "launch", fake_launch)
    with pytest.raises(Stop), contextlib.redirect_stdout(io.StringIO()):
        bigdict_mesh.run(3, 0.01, 2, 0.01, K, device="cpu")
    assert seen["n"] == 3 and seen["k"] == K
    assert seen["cpd"] == bigdict_mesh.CHUNK_PER_DEV
    assert not os.path.exists(seen["workdir"])


# ------------------------------------------- the mesh repairs at 1e8 --


def _small_sets():
    rng = np.random.default_rng(5)
    return [np.unique(rng.integers(0, 1 << 42, n, dtype=np.uint64))
            for n in (3000, 2000, 2500)]


def _record_budget(mesh, free):
    """sharded_build_dictionary with each check_device_budget call recorded
    and, where free is given, the device's free memory set to it."""
    calls = []
    check = shard.check_device_budget

    def recorded(table_bytes, device, what="dictionary", layout=0,
                 free=None):
        calls.append((what, table_bytes, layout))
        return check(table_bytes, device, what, layout, free)

    shard.check_device_budget = recorded
    if free is not None:
        lookup._free_bytes = lambda device, f: free
    sbd = shard.sharded_build_dictionary(_small_sets(), mesh, 3, 11)
    return calls, sbd.checked_bytes, sbd.nbits, sbd.stride


def test_sharded_build_checks_routing_merge_and_layout():
    """Each rank checks its budget before the routing of its slice
    (_ROUTE_BYTES_PER_PAIR per pair), the merge of the pairs it received
    (merge_sets_bytes) and the layout; checked_bytes is the most any of
    them counted."""
    sets = _small_sets()
    total = sum(len(s) for s in sets)
    results = pmesh.launch(_record_budget, (None,), 2, "cpu",
                           timeout=LAUNCH_TIMEOUT)
    received = 0
    reserve = lookup.ANCHOR_RESERVE_BYTES
    for r in results:
        calls, checked, nbits, stride = r.value
        (route, _, r_bytes), (merge, _, m_bytes) = calls[:2]
        n_local = min(-(-total // 2), total - r.rank * -(-total // 2))
        assert route.endswith(f"routing {n_local} pairs")
        assert r_bytes == shard._ROUTE_BYTES_PER_PAIR * n_local
        T = int(merge.split("merging ")[1].split()[0])
        assert m_bytes == merge_sets_bytes(T, 1)
        received += T
        what, table, layout = calls[-1]
        assert what.startswith("sharded dict (2 shards)")
        assert table == (1 << nbits) * stride * 4
        assert layout == lookup.layout_bytes(-(-total // 2), 1, "bucket",
                                             n_buckets=1 << nbits)
        assert checked == max(b + t for _, t, b in calls) + reserve
    assert received == total


def test_sharded_build_refuses_before_routing():
    """A card whose free memory does not hold the routing of a rank's
    slice refuses the build by name before anything is uploaded."""
    with pytest.raises(Exception, match="routing .* pairs: needs"):
        pmesh.launch(_record_budget, (lookup.ANCHOR_RESERVE_BYTES,), 1,
                     "cpu", timeout=LAUNCH_TIMEOUT)


def test_merge_and_bucket_budgets():
    """merge_sets_bytes counts the sort's 52 B per pair, or the end's
    (20 + 4W) when the masks are wide; check_hbm_budget counts the range
    shard's bucket layout."""
    assert merge_sets_bytes(1000, 1) == 52_000
    assert merge_sets_bytes(1000, 20) == 100_000
    D, W, S = 10_000_000, 1, 8
    per = -(-D // S)
    nbits, _, stride = lookup.table_geometry(per, W)
    need = ((1 << nbits) * stride * 4 + lookup.layout_bytes(per, W, "bucket")
            + lookup.ANCHOR_RESERVE_BYTES)
    assert lookup.check_hbm_budget(D, W, n_shards=S, device_layout="bucket",
                                   device="cpu", free=need) is None
    with pytest.raises(RuntimeError, match="needs"):
        lookup.check_hbm_budget(D, W, n_shards=S, device_layout="bucket",
                                device="cpu", free=need - 1)
