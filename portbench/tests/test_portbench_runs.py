"""Whole runs of every cell at a tiny size: on the CPU (the kernels' plain
versions) here, and on the card where one exists; the command line's
refusals."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests.tiny import CELLS, SPEC, run_tiny


def expect_metrics(name, trace, cuda):
    names = [m["name"] for m in run.cell_metrics(SPEC, name, trace)]
    if not cuda:
        names = [n for n in names if n not in (
            "peak_device_gib", "anchor.copy_share", "anchor_chunk_roofline")
                 and not n.startswith("device.")]
    return set(names)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_cpu(name, trace):
    r = run_tiny(name, torch.device("cpu"), trace=trace)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == expect_metrics(name, trace, False)
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 == c["limit"] for c in r["checks"].values())
    assert ("breakdown" in r) == trace


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    for trace in (False, True):
        r = run_tiny(name, dev, trace=trace)
        assert r["correct"], r["checks"]
        assert set(r["metrics"]) >= expect_metrics(name, trace, False)
        assert r["device"]["platform"] == "gpu"
        if trace:
            assert r["device"]["busy_s"] > 0
            assert r["breakdown"]["device_ops"]


def command(cwd, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "portbench.run", *args],
                          cwd=cwd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=300)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = command(run.ROOT, "--workload", CELLS[0], "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA card" in p.stderr


def test_command_fails_without_the_program(tmp_path):
    """A directory of BENCHMARK.json and portbench/ alone gives no result."""
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(tmp_path, "--workload", CELLS[0], "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""



@pytest.mark.parametrize("name", [c for c in CELLS if ".anchor_" in c])
def test_anchor_chunk_is_the_index_rule(name, monkeypatch):
    """An anchor cell streams in the chunk the index build gives its
    chromosomes (Genome._anchor_chunk, over the configuration's own
    genome), and follows the program when the rule changes."""
    from panagram_tpu_torch import index
    from portbench.kinds import anchor

    _cell, cfg, _mix = run.cell_spec(SPEC, name)
    positions = cfg["genome_bp"] - cfg["k"] + 1
    want = 1 << max(18, (positions - 1).bit_length())
    assert anchor.program_chunk(positions) == min(index.ANCHOR_CHUNK, want)
    monkeypatch.setattr(index, "ANCHOR_CHUNK", 1 << 19)
    assert anchor.program_chunk(positions) == 1 << 19
