"""Cell kinds, one module per name a traffic mix's `kind` gives.  Each
holds a `Cell(cfg, mix, seed, device, log)` with:

* `setup()`: generation, the program's state, warm-up of every shape;
* `window(seconds, mark)`: the measured work, a `Window`;
* `free()`: drops the program's state but what the check reads;
* `check(least_bytes)`: the reference's judgement, a `Check`.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass
class Window:
    """What the window did, on the host's clock."""

    seconds: float                 # from its start to the end of its last step
    attempted: int                 # passes or builds
    positions: int = 0             # k-mer positions the stream yielded
    bases: int = 0                 # genome bases built
    pass_walls: list = dataclasses.field(default_factory=list)
    phase: dict = dataclasses.field(default_factory=dict)   # program's timers
    spans: dict = dataclasses.field(default_factory=dict)   # harness's spans


@dataclasses.dataclass
class Check:
    """The comparison with the reference: each number with its limit."""

    numbers: dict                  # name -> (value, limit)
    failed: int                    # attempted steps with a wrong answer
    least_bytes: int | None = None   # the window's anchor chunks' least bytes

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values())


def rng(seed: int, stream: int):
    """The numpy generator of one stream of draws from the run's seed."""
    return np.random.default_rng([seed, stream])


def genomes(cfg: dict) -> list:
    """The configuration's genomes: its generator at the seed of its own
    data set (`genome_seed`, as its source draws them), the same in every
    run, so that only the order of the work follows the run's seed."""
    gen = importlib.import_module(f"portbench.genomes.{cfg['generator']}")
    return gen.make(cfg, np.random.default_rng(cfg["genome_seed"]))


def builder(cfg: dict):
    """The configuration's dictionary builder module."""
    return importlib.import_module(f"portbench.builders.{cfg['builder']}")
