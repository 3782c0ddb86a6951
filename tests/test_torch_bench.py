"""bench_torch.py (the port's bench.py) and the port's tools/scale_run.py,
on the CPU at bench.py's --quick sizes.

bench.py's problem made by the port (genomes, dictionary, bucket table)
is held to panagram_tpu's numpy oracle and to bench.py's own output; the
port's stream over the quick anchor to panagram_tpu's stream on JAX's CPU
backend.  Every comparison is of integers or bytes, so exact (tolerance
0).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from panagram_tpu.ops import anchor as jax_anchor
from panagram_tpu.ops import lookup as jl
from panagram_tpu.ops.ref_impl import build_dict_np, canonical_kmers_np
from panagram_tpu_torch.index import Index as PortIndex
from panagram_tpu_torch.ops import anchor
from panagram_tpu_torch.tools import scale_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_torch  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def quick():
    return bench_torch.make_problem(True, "cpu")


def test_make_problem_matches_the_oracle(quick):
    """The port's counting and merge on the device give build_dict_np's
    keys and masks over canonical_kmers_np's sets of the same genomes, and
    the table panagram_tpu's geometry."""
    assert (quick.k, quick.ngenomes, quick.seq_len, quick.chunk) == (
        21, 30, 1 << 20, 1 << 18)
    assert len(quick.genomes) == 30
    assert all(len(g) == 1 << 18 for g in quick.genomes)
    sets = []
    for g in quick.genomes:
        canon, valid = canonical_kmers_np(g, quick.k)
        sets.append(np.unique(canon[valid]))
    keys, masks = build_dict_np(sets)
    assert quick.pan.keys.dtype == np.uint64
    assert np.array_equal(quick.pan.keys, keys)
    assert np.array_equal(quick.pan.masks, masks)
    jbd = jl.BucketedDict.build(keys, masks, 30, quick.k)
    assert tuple(quick.bd.table.shape) == jbd.table.shape
    assert quick.bd.stride == jbd.stride
    assert (quick.bd.nbits, quick.bd.cap) == (jbd.nbits, jbd.cap)
    assert quick.table.device.type == "cpu"
    reps = -(-quick.seq_len // len(quick.genomes[0]))
    assert np.array_equal(quick.anchor_codes,
                          np.tile(quick.genomes[0], reps)[:quick.seq_len])


def test_generator_matches_bench_py(quick):
    """bench.py --quick (JAX on the CPU) prints the dictionary and table
    that the port's problem has."""
    res = subprocess.run(
        [sys.executable, "bench.py", "--quick"], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    m = re.search(r"dict (\d+) keys x (\d+) words", res.stderr)
    assert m, res.stderr[-3000:]
    assert (int(m[1]), int(m[2])) == (len(quick.pan), quick.pan.nwords)
    m = re.search(r"bucketed \((\d+), (\d+)\) stride (\d+)", res.stderr)
    assert m, res.stderr[-3000:]
    assert (int(m[1]), int(m[2])) == tuple(quick.bd.table.shape)
    assert int(m[3]) == quick.bd.stride
    assert (len(quick.pan), tuple(quick.bd.table.shape)) == (
        534_537, (131_072, 64))


def test_stream_matches_panagram_tpu(quick):
    """The first 2^17 positions of the quick anchor in 2^15-position chunks:
    the port's stream_anchor_chunks and panagram_tpu's give the same
    chunks, bytes, popcounts and column sums."""
    k, n, chunk = quick.k, 1 << 17, 1 << 15
    codes = quick.anchor_codes[:n + k - 1]
    jbd = jl.BucketedDict.build(quick.pan.keys, quick.pan.masks, 30, k)
    (jt,) = jbd.device_arrays()
    buf = np.full(chunk + k - 1, 255, np.uint8)
    want = [(s, m, by.copy(), p.copy(), c.copy())
            for s, m, by, p, c in jax_anchor.stream_anchor_chunks(
                codes, n, chunk, buf, jt, jbd, quick.nbytes, 30, k,
                state={})]
    got = [(s, m, by.copy(), p.copy(), c.copy())
           for s, m, by, p, c in anchor.stream_anchor_chunks(
               codes, n, chunk, buf, quick.table, quick.bd, quick.nbytes,
               30, k, state={})]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            assert a.shape == b.shape and np.array_equal(a, b)
    assert int(np.concatenate([g[3] for g in got]).sum()) > 0


def test_bench_torch_quick_on_the_cpu():
    """python bench_torch.py --quick --device cpu exits 0 and prints
    bench.py's line last, exactly its five keys, after its stderr lines."""
    res = subprocess.run(
        [sys.executable, "bench_torch.py", "--quick", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "device_compute_kmers_per_s"}
    assert line["metric"] == "anchor_kmers_per_s"
    assert line["unit"] == "kmers/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["device_compute_kmers_per_s"] > 0
    for want in ("dict 534537 keys x 1 words",
                 "bucketed (131072, 64) stride 64", "copy-back dense",
                 "device parity vs oracle OK",
                 "cpu baseline bytes equal the stream's"):
        assert want in res.stderr, want
    assert re.search(r"best rep wall [0-9.]+ s: pack [0-9.]+ s, copy "
                     r"[0-9.]+ s", res.stderr), res.stderr[-3000:]


def test_bench_torch_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        bench_torch.main(["--quick", "--device", "cuda"])


def test_scale_run_tool(tmp_path, capsys):
    """tools/scale_run.py's flags and stage lines, on the CPU: a 4-genome
    build through build_index(device_dict=True) whose index opens in read
    mode."""
    work = tmp_path / "scale"
    scale_run.main(["--genomes", "4", "--mbp", "0.02", "--anchors", "2",
                    "--workdir", str(work), "--keep", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== scale run: 4 genomes x 0.02 Mbp, k=31, 2 anchors ===" in out
    for line in ("total wall:", "dictionary (count+merge on device):",
                 "anchoring (2 genomes):", "index at "):
        assert line in out, line
    stages = re.findall(r"^  (\S+) +[0-9.]+ s$", out, re.M)
    assert stages == ["anchor.g00", "anchor.g01", "dict", "layout",
                      "mash.triangle"]
    idx = PortIndex(str(work / "idx"))
    assert idx.genome_names == [f"g{g:02d}" for g in range(4)]
    assert idx.query_bitmap("g00", "chr1", 0, 1000).values.shape == (1000, 4)
