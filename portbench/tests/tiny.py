"""Cells of BENCHMARK.json cut to a size the CPU runs in a second, for the
tests: the same files, kinds, builders and reference, fewer and shorter
genomes, and the program's largest anchor chunk (index.ANCHOR_CHUNK, the
cap of Genome._anchor_chunk) lowered so that a pass still holds several
chunks, the last of them part padding."""

from __future__ import annotations

import os
from unittest import mock

from portbench import run

SPEC = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]


def tiny(name: str):
    """(cfg, mix, anchor chunk) of cell `name` at a test's size: W and k
    kept, the lengths cut."""
    _cell, cfg, mix = run.cell_spec(SPEC, name)
    cfg = dict(cfg)
    if cfg["genomes"] <= 32:
        cfg.update(genomes=6, genome_bp=4096)
        chunk = 1536
    else:
        cfg.update(genome_bp=2000)
        chunk = 768
    mix = dict(mix)
    if "sample_positions" in mix:
        mix.update(sample_positions=64)
    if "orders" in mix:
        mix.update(orders=8)
    return cfg, mix, chunk


def run_tiny(name: str, device, seconds: float = 0.3, trace: bool = False,
             system=None, seed: int = 2**31 + 12345) -> dict:
    from panagram_tpu_torch import index

    cfg, mix, chunk = tiny(name)
    with mock.patch.object(index, "ANCHOR_CHUNK", chunk):
        return run.run_cell(name, cfg, mix,
                            run.cell_metrics(SPEC, name, trace), seed,
                            seconds, trace, device, system=system)
