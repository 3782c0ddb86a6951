"""Founder-structured genomes: 4 founders at 1% divergence from one random
base, then each genome a founder (g % 4) with 0.1% private variation.

``founder_genomes`` is a frozen copy of ``founder_genomes`` in
panagram_tpu_torch/tools/scale_run.py at commit 299c73b (the generator of
tools/scale_run.py and bench.py): the same calls on `rng`, in the same
order, so the same rng gives the same genomes.
"""

from __future__ import annotations

import numpy as np

FOUNDERS = 4
DIVERGENCE = 0.01
PRIVATE = 0.001


def founder_genomes(ngenomes: int, bp: int, rng):
    """Yields `ngenomes` founder-structured genomes of `bp` bases (codes
    uint8 in 0..3)."""
    base = rng.integers(0, 4, bp, dtype=np.uint8)
    founders = []
    for _ in range(4):
        mut = base.copy()
        pos = rng.choice(bp, bp // 100, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        founders.append(mut)
    for g in range(ngenomes):
        mut = founders[g % 4].copy()
        pos = rng.choice(bp, bp // 1000, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        yield mut


def make(cfg: dict, rng) -> list:
    """The configuration's genomes; its founder parameters must be the
    copy's."""
    got = (cfg["founders"], cfg["founder_divergence"], cfg["private_variation"])
    if got != (FOUNDERS, DIVERGENCE, PRIVATE):
        raise ValueError(f"founder generator: founders, divergence and private "
                         f"variation are {(FOUNDERS, DIVERGENCE, PRIVATE)}, "
                         f"the configuration asks for {got}")
    return list(founder_genomes(cfg["genomes"], cfg["genome_bp"], rng))
