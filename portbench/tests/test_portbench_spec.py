"""BENCHMARK.json against the benchmark's rules, and the harness finding
every configuration, mix and metric by the name it is given."""

import json
import os
import re

import pytest

from portbench import run
from portbench.tests.tiny import CELLS, SPEC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
E2E = ["anchor_kmers_per_s", "build_mbp_per_s", "peak_device_gib", "setup_s"]


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes():
    assert set(SPEC) == TOP
    path = os.path.join(run.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/")
    assert len(SPEC["command"]) <= 32 and all(map(text_ok, SPEC["command"]))


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    assert [m["name"] for m in SPEC["end_to_end"]] == E2E
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text_ok(m["layer"])
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        # every cell that reports the metric reports what it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"])
        assert text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(r) for r in c["reduced"])
        assert c["file"].startswith("portbench/")
        cfg = run.load_json(os.path.join(run.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(r in cfg for r in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert NAME.match(w["traffic"]) and text_ok(w["why"])
        assert w["chips"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    """Configuration and mix come from their files; every metric the cell
    reports has a reader; each cell reports setup_s, one more end-to-end
    metric and one per-layer metric."""
    cell, cfg, mix = run.cell_spec(SPEC, name)
    assert cfg["name"] == cell["config"] and mix["kind"] in ("anchor", "build")
    e2e = [m["name"] for m in run.cell_metrics(SPEC, name, False)]
    layer = [m["name"] for m in run.cell_metrics(SPEC, name, True)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(run.reader(m))


def test_every_metric_file_is_listed():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(run.HERE, "metrics"))
             if f.endswith(".py")}
    assert files == names


def test_a_new_mix_is_a_new_file(tmp_path, monkeypatch):
    """A cell of a new mix needs its file and BENCHMARK.json's entry, and
    no edit to the harness."""
    monkeypatch.setattr(run, "HERE", str(tmp_path))
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "later.json").write_text(json.dumps(
        {"kind": "anchor", "sample_positions": 1}))
    spec = dict(SPEC, workloads=SPEC["workloads"] + [
        {"name": "pan30_k31.later", "config": "pan30_k31",
         "traffic": "later", "chips": 1, "why": "x"}])
    _cell, cfg, mix = run.cell_spec(spec, "pan30_k31.later")
    assert mix["sample_positions"] == 1 and cfg["genomes"] == 30


def test_unknown_cell():
    with pytest.raises(KeyError):
        run.cell_spec(SPEC, "pan30_k31.nothing")
