"""Build cells: the index build's device stages, back to back.

Each build counts every genome's k-mer set on the card, merges the sets
into the presence-mask dictionary and lays the dictionary out as the
bucket table, through the configuration's builder, then drops the table
before the next build.  Builds take the genomes in orders drawn from the
seed, so that no two neighbouring builds see the same input and each
build's masks are its own.  The window runs from its start to the end of
the build that ends after its close.

The check compares every build's dictionary (keys and masks) with the
reference's, and reads the last build's table back through the program's
probe (ops.lookup.bucket_query_sorted) for every key and as many keys that
are not in the dictionary: the table's layout is the program's to change,
what it answers is not.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import kinds
from portbench.reference import kmers as ref
from portbench.trace import no_mark

# queries per probe call of the table check
PROBE_BATCH = 1 << 22


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        self.cfg, self.mix, self.seed, self.device, self.log = (
            cfg, mix, seed, device, log)
        self.k = cfg["k"]
        self.n = cfg["genomes"]

    def setup(self):
        cfg = self.cfg
        self.builder = kinds.builder(cfg)
        t = time.perf_counter()
        self.genomes = kinds.genomes(cfg)
        r = kinds.rng(self.seed, 2)
        self.orders = [r.permutation(self.n) for _ in range(self.mix["orders"])]
        self.log(f"setup: generation {time.perf_counter() - t:.3f} s "
                 f"({len(self.genomes)} genomes x {cfg['genome_bp']} bp)")
        t = time.perf_counter()
        for _ in range(self.mix["warmup_builds"]):
            self.builder.build(self.genomes, cfg, self.device)
            self.sync()
        self.log(f"setup: warm-up {time.perf_counter() - t:.3f} s "
                 f"({self.mix['warmup_builds']} builds)")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, mark=no_mark) -> kinds.Window:
        spans: dict = {}

        @contextlib.contextmanager
        def span(name):
            t = time.perf_counter()
            with mark(name):
                yield
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t

        self.dicts, self.last, walls = [], None, []
        t0 = time.perf_counter()
        end = t0 + seconds
        b = 0
        while b == 0 or time.perf_counter() < end:
            o = b % len(self.orders)
            # the previous build's table goes before this build starts
            self.last = bd = table = pan = None
            tb = time.perf_counter()
            with mark("build"):
                bd, table, pan = self.builder.build(
                    [self.genomes[g] for g in self.orders[o]], self.cfg,
                    self.device, span=span)
            walls.append(time.perf_counter() - tb)
            self.dicts.append((b, o, pan.keys, pan.masks))
            self.last = (bd, table, o)
            b += 1
        bases = b * sum(len(g) for g in self.genomes)
        return kinds.Window(seconds=time.perf_counter() - t0, attempted=b,
                            bases=bases, pass_walls=walls, spans=spans)

    def free(self):
        """The last table stays for the check's probe."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, least_bytes: bool) -> kinds.Check:
        from panagram_tpu_torch.ops import lookup

        dev, k = self.device, self.k
        sets = [ref.kmer_set(torch.from_numpy(g).to(dev), k)
                for g in self.genomes]
        keys = ref.union_keys(sets)
        keys_np = keys.cpu().numpy().view(np.uint64)
        want = {}
        bad = {"bad_keys": 0, "bad_masks": 0, "bad_table": 0}
        failed = set()
        for b, o, got_keys, got_masks in self.dicts:
            if o not in want:
                want[o] = ref.masks(keys, sets, self.orders[o]).cpu().numpy()
            nk = 0 if np.array_equal(got_keys, keys_np) else max(
                len(keys_np), len(got_keys))
            nm = (int((got_masks.view(np.int32) != want[o]).any(1).sum())
                  if got_masks.shape == want[o].shape else len(want[o]))
            bad["bad_keys"] += nk
            bad["bad_masks"] += nm
            if nk or nm:
                failed.add(b)
        bd, table, o = self.last
        self.last = None
        # keys that are no genome's: the k-mers of fresh random sequence
        # less the dictionary's
        g = torch.Generator(device="cpu").manual_seed(self.seed % (1 << 63))
        codes = torch.randint(0, 4, (len(keys_np) + k - 1,), generator=g,
                              dtype=torch.uint8).to(dev)
        words, _ = ref.kmer_words(codes, k)
        at = torch.searchsorted(keys, words).clamp_(max=keys.shape[0] - 1)
        absent = torch.unique(words[keys[at] != words])
        queries = torch.cat([keys, absent])
        expect = torch.cat([torch.from_numpy(want[o]).to(dev),
                            torch.zeros(absent.shape[0], want[o].shape[1],
                                        dtype=torch.int32, device=dev)])
        for s in range(0, queries.shape[0], PROBE_BATCH):
            got = lookup.bucket_query_sorted(queries[s:s + PROBE_BATCH],
                                             table, bd.nbits, bd.cap,
                                             bd.nwords)
            bad["bad_table"] += int(
                (got != expect[s:s + PROBE_BATCH]).any(1).sum())
        if bad["bad_table"]:
            failed.add(len(self.dicts) - 1)
        return kinds.Check({name: (v, 0) for name, v in bad.items()},
                           len(failed))
