"""Anchor cells: member genomes streamed through the program's anchor stream,
ops.anchor.stream_anchor_chunks, against the configuration's table.

A pass anchors one member genome, one chromosome of `genome_bp` bases, as
the `index` build anchors each anchor genome: the stream packs it on the
host in chunks of the size the build's own rule gives that chromosome
(Genome._anchor_chunk), runs each chunk's kernels on the card and copies
its bitmap bytes, popcounts and column sums back.

Passes go round the genomes in an order drawn from the seed, back to back,
from the window's start until the pass that ends after its close.  Of
each chunk the harness keeps its column sums and, at `sample_positions`
positions drawn from the seed, its bitmap bytes and popcounts; the check
compares every column sum and every kept answer with the reference's.
"""

from __future__ import annotations

import collections
import time
import types

import numpy as np
import torch

from portbench import kinds
from portbench.reference import kmers as ref
from portbench.roofline import anchor_chunk_least_bytes
from portbench.trace import no_mark

# sample rows drawn per run (a chunk takes row (pass * 64 + chunk) % ROWS)
SAMPLE_ROWS = 64


def program_chunk(positions: int) -> int:
    """The chunk the `index` build streams a chromosome of `positions`
    k-mer positions in: the program's own rule, Genome._anchor_chunk, over
    an anchor genome of that one chromosome."""
    from panagram_tpu_torch.index import Genome

    return Genome._anchor_chunk(
        types.SimpleNamespace(chrs=[("chr1", 0, positions)]))


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        self.cfg, self.mix, self.seed, self.device, self.log = (
            cfg, mix, seed, device, log)
        self.k = cfg["k"]
        self.n = cfg["genomes"]
        self.nbytes = (self.n + 7) // 8

    def setup(self):
        from panagram_tpu_torch.ops import anchor

        # looked up here, so a test can put a broken stream in its place
        self.stream = anchor.stream_anchor_chunks
        cfg, mix = self.cfg, self.mix
        t = time.perf_counter()
        self.genomes = kinds.genomes(cfg)
        self.log(f"setup: generation {time.perf_counter() - t:.3f} s "
                 f"({len(self.genomes)} genomes x {cfg['genome_bp']} bp)")
        t = time.perf_counter()
        self.bd, self.table, _ = kinds.builder(cfg).build(
            self.genomes, cfg, self.device)
        self.sync()
        self.log(f"setup: build {time.perf_counter() - t:.3f} s "
                 f"(table 2^{self.bd.nbits} x {self.bd.stride}, "
                 f"route {self.bd.route})")
        self.chunk = program_chunk(cfg["genome_bp"] - self.k + 1)
        r = kinds.rng(self.seed, 2)
        self.order = r.permutation(len(self.genomes))
        self.sample = r.integers(0, 1 << 32, (SAMPLE_ROWS,
                                              mix["sample_positions"]),
                                 dtype=np.uint64)
        self.log(f"setup: chunk {self.chunk} positions (the index's rule)")
        t = time.perf_counter()
        for i in range(mix["warmup_passes"]):
            self._pass(i, {}, [], no_mark)
        self.recs = []
        self.log(f"setup: warm-up {time.perf_counter() - t:.3f} s "
                 f"({mix['warmup_passes']} passes)")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pass(self, i: int, phase: dict, recs: list, mark) -> int:
        """Pass i: genome order[i % N] through the stream;
        returns the positions yielded."""
        e = int(self.order[i % len(self.genomes)])
        codes = self.genomes[e]
        nk = len(codes) - self.k + 1
        total = 0
        gen = self.stream(codes, nk, self.chunk, None, self.table, self.bd,
                          self.nbytes, self.n, self.k, phase=phase)
        c = 0
        while True:
            with mark("stream"):
                item = next(gen, None)
            if item is None:
                break
            with mark("consume"):
                start, m, by, popc, cs = item
                j = (i * 64 + c) % SAMPLE_ROWS
                idx = ((self.sample[j] * np.uint64(m)) >> np.uint64(32)
                       ).astype(np.intp)
                recs.append((i, e, c, start, m, j, by[idx], popc[idx],
                             cs.copy()))
                total += m
            c += 1
        return total

    def window(self, seconds: float, mark) -> kinds.Window:
        phase = {"pack": 0.0, "copy": 0.0}
        walls, recs, positions = [], [], 0
        t0 = time.perf_counter()
        end = t0 + seconds
        i = 0
        while i == 0 or time.perf_counter() < end:
            tp = time.perf_counter()
            positions += self._pass(i, phase, recs, mark)
            walls.append(time.perf_counter() - tp)
            i += 1
        w = kinds.Window(seconds=time.perf_counter() - t0, attempted=i,
                         positions=positions, pass_walls=walls, phase=phase)
        self.recs = recs
        return w

    def free(self):
        del self.bd, self.table
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, least_bytes: bool) -> kinds.Check:
        """Every kept answer against the reference's: the chunks' order and
        lengths, each chunk's column sums, the sampled positions' bytes and
        popcounts."""
        dev, k, n, nb = self.device, self.k, self.n, self.nbytes
        sets = [ref.kmer_set(torch.from_numpy(g).to(dev), k)
                for g in self.genomes]
        keys = ref.union_keys(sets)
        mask = ref.masks(keys, sets)
        del sets
        groups = collections.defaultdict(list)
        chunks_of = collections.Counter()
        for rec in self.recs:
            groups[rec[1], rec[2]].append(rec)
            chunks_of[rec[0], rec[1]] += 1
        bad = {"bad_chunks": 0, "bad_colsums": 0, "bad_bytes": 0,
               "bad_popcounts": 0}
        failed = set()
        for (i, e), got in chunks_of.items():
            want = -(-(len(self.genomes[e]) - k + 1) // self.chunk)
            if got != want:
                bad["bad_chunks"] += abs(want - got)
                failed.add(i)
        lb = 0
        for (e, c), recs in groups.items():
            codes = self.genomes[e]
            start = c * self.chunk
            m = min(self.chunk, len(codes) - k + 1 - start)
            if m <= 0:
                bad["bad_chunks"] += len(recs)
                failed.update(r[0] for r in recs)
                continue
            win = torch.from_numpy(codes[start:start + m + k - 1]).to(dev)
            words, valid = ref.kmer_words(win, k)
            rows = ref.rows(words, valid, keys, mask)
            full = ref.row_bytes(rows)
            cs = ref.column_sums(rows, n).cpu().numpy()
            if least_bytes:
                d = torch.unique(words[valid])
                at = torch.searchsorted(keys, d).clamp_(max=keys.shape[0] - 1)
                hits = int((keys[at] == d).sum())
                lb += len(recs) * anchor_chunk_least_bytes(
                    m, k, d.shape[0], hits, n)
            del words, valid, rows
            ok = [r for r in recs if (r[3], r[4]) == (start, m)]
            for r in recs:
                if (r[3], r[4]) != (start, m):
                    bad["bad_chunks"] += 1
                    failed.add(r[0])
            if not ok:
                continue
            idx = [((self.sample[r[5]] * np.uint64(m)) >> np.uint64(32)
                    ).astype(np.intp) for r in ok]
            at = torch.from_numpy(np.concatenate(idx)).to(dev)
            by = full[at, :nb].cpu().numpy()
            pc = ref.popcount(full[at]).cpu().numpy()
            del full
            s = 0
            for r, ix in zip(ok, idx):
                i, rb, rp, rc = r[0], r[6], r[7], r[8]
                e_by, e_pc = by[s:s + len(ix)], pc[s:s + len(ix)]
                s += len(ix)
                nbad = [int((rc.astype(np.int64) != cs).sum()),
                        int((rb != e_by).any(1).sum()),
                        int((rp != e_pc).sum())]
                bad["bad_colsums"] += nbad[0]
                bad["bad_bytes"] += nbad[1]
                bad["bad_popcounts"] += nbad[2]
                if any(nbad):
                    failed.add(i)
        return kinds.Check({name: (v, 0) for name, v in bad.items()},
                           len(failed), lb if least_bytes else None)

