"""Founder-structured genomes of several chromosomes: the frozen founder
model of founder.py applied to each chromosome on its own, at the lengths
of the configuration's `chromosome_bp` list.

Draw order, all from the one generator it is given: chromosome 1 whole
(its base, its 4 founders, then genomes 0 .. N-1, as founder.py draws
them), then chromosome 2 whole, and so on.  Genome g is the list of its
chromosomes' codes, in the list's order.  As founder.make does, it
refuses founder parameters other than the frozen model's.
"""

from __future__ import annotations

from portbench.genomes import founder


def make(cfg: dict, rng) -> list:
    """The configuration's genomes, each a list of chromosome code arrays
    (uint8 in 0..3) of the lengths in cfg["chromosome_bp"]."""
    per_chromosome = [founder.make(dict(cfg, genome_bp=bp), rng)
                      for bp in cfg["chromosome_bp"]]
    return [list(chrs) for chrs in zip(*per_chromosome)]
