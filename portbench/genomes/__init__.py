"""Genome generators, one module per name a configuration's `generator`
gives: `make(cfg, rng)` returns the genomes' codes (uint8 arrays)."""
