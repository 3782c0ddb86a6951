"""Cells of BENCHMARK.json cut to a size the CPU runs in a second, for the
tests: the same files, kinds, builders and reference, fewer and shorter
genomes, and the program's largest anchor chunk (index.ANCHOR_CHUNK, the
cap of Genome._anchor_chunk) lowered so that a pass still holds several
chunks, the last of them part padding."""

from __future__ import annotations

import importlib
import os
from unittest import mock

import numpy as np

from portbench import kinds, run

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


# the tiny multi-chromosome genome: three chromosomes, streamed in chunks
# of CHROMOSOME_CHUNK positions (3, 2 and 3 chunks)
CHROMOSOME_BP = [1500, 900, 1200]
CHROMOSOME_CHUNK = 512


def tiny_chromosomes():
    """(cfg, mix): pan30_k31's configuration and anchor mix at a test's
    size, its 6 genomes of three chromosomes each from
    founder_chromosomes."""
    cfg, mix, _chunk = tiny("pan30_k31.anchor_member")
    del cfg["genome_bp"]
    cfg.update(generator="founder_chromosomes", chromosome_bp=CHROMOSOME_BP)
    return cfg, mix


class JoinedBuilder:
    """The configuration's builder over each genome's chromosomes joined
    by an N, which no k-mer spans: the same k-mer sets, for a builder
    that takes a genome as one array."""

    @staticmethod
    def build(genomes, cfg, device, span=None):
        from portbench.kinds.anchor import chromosomes

        n = np.full(1, 4, np.uint8)
        joined = [np.concatenate([x for c in chromosomes(g) for x in (c, n)])
                  for g in genomes]
        real = importlib.import_module(f"portbench.builders.{cfg['builder']}")
        return real.build(joined, cfg, device, span)


def run_chromosomes(device, seconds: float = 0.3, trace: bool = False,
                    system=None, seed: int = 2**31 + 54321) -> dict:
    """A whole anchor run of the tiny multi-chromosome genomes."""
    from panagram_tpu_torch import index

    cfg, mix = tiny_chromosomes()
    name = "pan30_k31.anchor_member"
    with mock.patch.object(index, "ANCHOR_CHUNK", CHROMOSOME_CHUNK), \
            mock.patch.object(kinds, "builder", lambda _cfg: JoinedBuilder):
        return run.run_cell(name, cfg, mix,
                            run.cell_metrics(SPEC, name, trace), seed,
                            seconds, trace, device, system=system)
