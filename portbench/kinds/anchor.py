"""Anchor cells: member genomes streamed through the program's anchor stream,
ops.anchor.stream_anchor_chunks, against the configuration's table.

A pass anchors one member genome as the `index` build anchors an anchor
genome (Genome.run_anchor): its chromosomes in order, one stream call
each, every call in the one chunk that the build's own rule gives the
whole genome (Genome._anchor_chunk over all its chromosomes).  The stream
stages each chunk on the host, runs its kernels on the card and copies its
bitmap bytes, popcounts and column sums back.  A generator's genome is a
list of chromosome code arrays, or one array: a genome of one chromosome.

Passes go round the genomes in an order drawn from the seed, back to back,
from the window's start until the pass that ends after its close.  Of
each chunk the harness keeps its column sums and, at `sample_positions`
positions drawn from the seed, its bitmap bytes and popcounts; the check
compares every column sum and every kept answer with the reference's.

The check holds one genome's k-mer set at a time, or as many as fit in
SETS_SHARE of the device's free memory, never their union: each checked
chunk's distinct words are searched in each set, which sets that genome's
bit.  The union of 30 plant genomes' sets, 3.6e9 keys before the merge,
would not fit on one card beside its sort.
"""

from __future__ import annotations

import collections
import os
import time
import types

import numpy as np
import torch

from portbench import kinds
from portbench.reference import kmers as ref
from portbench.roofline import anchor_chunk_least_bytes
from portbench.trace import no_mark

# sample rows drawn per run (a pass's c-th chunk, over all its chromosomes,
# takes row (pass * 64 + c) % ROWS)
SAMPLE_ROWS = 64
# the share of the device's free memory, at the check's start, that the
# genomes' sets held at once may take (each bounded by 8 bytes a position)
SETS_SHARE = 0.5
# positions of checked chunks whose distinct words are searched together
BATCH_POSITIONS = 1 << 26
# stream calls the warm-up makes at least: each call takes the next of
# torch's 32 pooled CUDA streams, and the caching allocator keeps each
# stream's blocks apart, so a call on a stream that has not yet served one
# waits for new device memory; twice round the pool
WARM_CALLS = 64


def chromosomes(genome) -> list:
    """A generator's genome as its list of chromosome code arrays."""
    return [genome] if isinstance(genome, np.ndarray) else list(genome)


def program_chunk(positions) -> int:
    """The chunk the `index` build streams an anchor genome in, whose
    chromosomes have `positions` k-mer positions (a number: one
    chromosome): the program's own rule, Genome._anchor_chunk, on a
    stand-in whose `chrs` holds every chromosome."""
    from panagram_tpu_torch.index import Genome

    if np.ndim(positions) == 0:
        positions = [positions]
    return Genome._anchor_chunk(types.SimpleNamespace(
        chrs=[(f"chr{h + 1}", h, int(p)) for h, p in enumerate(positions)]))


def free_bytes(device) -> int:
    """The device's free memory: the card's, or the host's available."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def genome_set(chrs, k: int, device):
    """Sorted distinct canonical k-mer words over all of a genome's
    chromosomes."""
    sets = [ref.kmer_set(torch.from_numpy(c).to(device), k) for c in chrs]
    return sets[0] if len(sets) == 1 else torch.unique(torch.cat(sets))


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
        self.prepare(kinds.genomes(cfg))
        self.log(f"setup: generation {time.perf_counter() - t:.3f} s "
                 f"({len(self.genomes)} genomes x "
                 f"{sum(map(len, self.chrs[0]))} bp in "
                 f"{len(self.chrs[0])} chromosome(s))")
        t = time.perf_counter()
        self.bd, self.table, _ = kinds.builder(cfg).build(
            self.genomes, cfg, self.device)
        self.sync()
        self.log(f"setup: build {time.perf_counter() - t:.3f} s "
                 f"(table 2^{self.bd.nbits} x {self.bd.stride}, "
                 f"route {self.bd.route})")
        self.log(f"setup: chunk {sorted(set(self.chunks))} positions "
                 f"(the index's rule)")
        t = time.perf_counter()
        passes = [int(self.order[i % self.n])
                  for i in range(mix["warmup_passes"])]
        # and a pass of each chunk the mix's warm-up passes leave cold
        for e in range(self.n):
            if self.chunks[e] not in {self.chunks[p] for p in passes}:
                passes.append(e)
        # then passes in the window's order up to WARM_CALLS stream calls
        calls = [sum(len(c) >= self.k for c in chrs) for chrs in self.chrs]
        while sum(calls[e] for e in passes) < WARM_CALLS and any(calls):
            passes.append(int(self.order[len(passes) % self.n]))
        for i, e in enumerate(passes):
            self._pass(i, e, {}, [], no_mark)
        self.recs, self.warm_passes = [], len(passes)
        self.log(f"setup: warm-up {time.perf_counter() - t:.3f} s "
                 f"({len(passes)} passes)")

    def prepare(self, genomes: list):
        """The generated genomes, their chromosomes and chunks, and the
        draws from the seed: the order of passes, the sample rows."""
        self.genomes = genomes
        self.chrs = [chromosomes(g) for g in genomes]
        k = self.k
        self.chunks = [program_chunk([max(len(c) - k + 1, 0) for c in chrs])
                       for chrs in self.chrs]
        r = kinds.rng(self.seed, 2)
        self.order = r.permutation(len(genomes))
        self.sample = r.integers(0, 1 << 32, (SAMPLE_ROWS,
                                              self.mix["sample_positions"]),
                                 dtype=np.uint64)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sample_at(self, j: int, m: int) -> np.ndarray:
        """Sample row j's positions in a chunk of m positions."""
        return ((self.sample[j] * np.uint64(m)) >> np.uint64(32)
                ).astype(np.intp)

    def _pass(self, i: int, e: int, phase: dict, recs: list, mark) -> int:
        """Pass i: genome e's chromosomes through the stream, one call
        each, in order; returns the positions yielded."""
        total, c = 0, 0
        for h, codes in enumerate(self.chrs[e]):
            nk = len(codes) - self.k + 1
            if nk <= 0:         # as Genome.run_anchor skips a short record
                continue
            gen = self.stream(codes, nk, self.chunks[e], None, self.table,
                              self.bd, self.nbytes, self.n, self.k,
                              phase=phase)
            ch = 0
            while True:
                with mark("stream"):
                    item = next(gen, None)
                if item is None:
                    break
                with mark("consume"):
                    start, m, by, popc, cs = item
                    j = (i * 64 + c) % SAMPLE_ROWS
                    idx = self.sample_at(j, m)
                    recs.append((i, e, h, ch, start, m, j, by[idx],
                                 popc[idx], cs.copy()))
                    total += m
                c += 1
                ch += 1
        return total

    def window(self, seconds: float, mark) -> kinds.Window:
        phase = {"pack": 0.0, "copy": 0.0}
        walls, recs, passes, positions = [], [], [], 0
        t0 = time.perf_counter()
        end = t0 + seconds
        i = 0
        while i == 0 or time.perf_counter() < end:
            e = int(self.order[i % self.n])
            tp = time.perf_counter()
            positions += self._pass(i, e, phase, recs, mark)
            walls.append(time.perf_counter() - tp)
            passes.append(e)
            i += 1
        w = kinds.Window(seconds=time.perf_counter() - t0, attempted=i,
                         positions=positions, pass_walls=walls, phase=phase)
        self.recs, self.passes = recs, passes
        return w

    def free(self):
        del self.bd, self.table
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, least_bytes: bool) -> kinds.Check:
        """Every kept answer against the reference's: each pass's chunks,
        chromosome by chromosome, in number and lengths; each chunk's
        column sums; the sampled positions' bytes and popcounts."""
        k, n, nb = self.k, self.n, self.nbytes
        bad = {"bad_chunks": 0, "bad_colsums": 0, "bad_bytes": 0,
               "bad_popcounts": 0}
        failed = set()
        chunks_of = collections.Counter((r[0], r[2]) for r in self.recs)
        for i, e in enumerate(self.passes):
            for h, codes in enumerate(self.chrs[e]):
                want = -(-max(len(codes) - k + 1, 0) // self.chunks[e])
                got = chunks_of[i, h]
                if got != want:
                    bad["bad_chunks"] += abs(want - got)
                    failed.add(i)
        groups = collections.defaultdict(list)
        for rec in self.recs:
            groups[rec[1:4]].append(rec)
        checked = []        # (records, start, m, codes window, sample rows)
        for (e, h, ch), recs in groups.items():
            codes = self.chrs[e][h]
            start = ch * self.chunks[e]
            m = min(self.chunks[e], len(codes) - k + 1 - start)
            if m <= 0:
                bad["bad_chunks"] += len(recs)
                failed.update(r[0] for r in recs)
                continue
            for r in recs:
                if (r[4], r[5]) != (start, m):
                    bad["bad_chunks"] += 1
                    failed.add(r[0])
            js = sorted({r[6] for r in recs if (r[4], r[5]) == (start, m)})
            checked.append((recs, start, m, codes[start:start + m + k - 1],
                            js))
        answers = self._answers(checked, least_bytes)
        lb = 0
        for (recs, start, m, _win, js), (cs, rows, distinct, hits) in zip(
                checked, answers):
            if least_bytes:
                lb += len(recs) * anchor_chunk_least_bytes(
                    m, k, distinct, hits, n)
            full = ref.row_bytes(rows)
            by = full[:, :nb].cpu().numpy()
            pc = ref.popcount(full).cpu().numpy()
            cs = cs.cpu().numpy()
            at = {j: s * len(self.sample[j]) for s, j in enumerate(js)}
            for r in recs:
                if (r[4], r[5]) != (start, m):
                    continue
                s, ns = at[r[6]], len(self.sample[r[6]])
                rb, rp, rc = r[7], r[8], r[9]
                nbad = [int((rc.astype(np.int64) != cs).sum()),
                        int((rb != by[s:s + ns]).any(1).sum()),
                        int((rp != pc[s:s + ns]).sum())]
                bad["bad_colsums"] += nbad[0]
                bad["bad_bytes"] += nbad[1]
                bad["bad_popcounts"] += nbad[2]
                if any(nbad):
                    failed.add(r[0])
        return kinds.Check({name: (v, 0) for name, v in bad.items()},
                           len(failed), lb if least_bytes else None)

    def _answers(self, checked: list, least_bytes: bool) -> list:
        """The reference's answers for each checked chunk: (column sums
        int64 [N], the presence rows int32 [S, W] of its sample rows'
        positions, its distinct canonical k-mers, how many of them some
        genome holds; the last two with least_bytes only).

        Genome g's set is searched for every distinct word of the chunks,
        a batch of chunks at a time, and a hit sets bit g.  The sets are
        held in groups that fit in SETS_SHARE of the free memory (one
        genome where one does not); each group makes the chunks' words
        anew."""
        dev, k, n = self.device, self.k, self.n
        if not checked:
            return []
        nrows = [len(js) * self.mix["sample_positions"]
                 for *_, js in checked]
        soff = np.concatenate([[0], np.cumsum(nrows)]).astype(int)
        colsums = torch.zeros(len(checked), n, dtype=torch.int64, device=dev)
        rows = torch.zeros(int(soff[-1]), (n + 31) // 32, dtype=torch.int32,
                           device=dev)
        counts = torch.zeros(2, len(checked), dtype=torch.int64, device=dev)
        batches, size = [[]], 0
        for ci, (_recs, _start, m, _win, _js) in enumerate(checked):
            if batches[-1] and size + m > BATCH_POSITIONS:
                batches.append([])
                size = 0
            batches[-1].append(ci)
            size += m
        budget = SETS_SHARE * free_bytes(dev)
        groups, held = [[]], 0
        for g, chrs in enumerate(self.chrs):
            need = 8 * sum(max(len(c) - k + 1, 0) for c in chrs)
            if groups[-1] and held + need > budget:
                groups.append([])
                held = 0
            groups[-1].append(g)
            held += need
        anyhit = [None] * len(batches)   # per batch: q's words some set holds
        for group in groups:
            sets = [(g, genome_set(self.chrs[g], k, dev)) for g in group]
            for b, batch in enumerate(batches):
                c0, c1 = batch[0], batch[-1] + 1
                q, cnt, seg, sinv = self._distinct(checked[c0:c1])
                if least_bytes and anyhit[b] is None:
                    anyhit[b] = torch.zeros_like(q, dtype=torch.bool)
                for g, s in sets:
                    if s.numel() == 0:
                        continue
                    at = torch.searchsorted(s, q).clamp_(max=s.numel() - 1)
                    hit = s[at] == q
                    del at
                    colsums[c0:c1, g].index_add_(0, seg, cnt * hit)
                    rows[soff[c0]:soff[c1], g // 32] |= (
                        hit[sinv].to(torch.int32) * ref._bit(g % 32))
                    if least_bytes:
                        anyhit[b] |= hit
                if least_bytes and group is groups[-1]:
                    counts[0, c0:c1].index_add_(0, seg, (q >= 0).long())
                    counts[1, c0:c1].index_add_(0, seg, anyhit[b].long())
                    anyhit[b] = None
                del q, cnt, seg, sinv
            del sets
        counts = counts.cpu().tolist()
        return [(colsums[ci], rows[soff[ci]:soff[ci + 1]], counts[0][ci],
                 counts[1][ci]) for ci in range(len(checked))]

    def _distinct(self, chunks: list):
        """(q, cnt, seg, sinv) of checked chunks: each chunk's distinct
        canonical words, with -1 for the windows that hold an N (no set
        holds it), concatenated; how many positions read each; the chunk
        in `chunks` of each; the index in q of each sample row position,
        chunk after chunk."""
        dev, k = self.device, self.k
        qs, cnts, segs, sinvs, off = [], [], [], [], 0
        for ci, (_recs, _start, m, win, js) in enumerate(chunks):
            w, valid = ref.kmer_words(torch.from_numpy(win).to(dev), k)
            d, inv, c = torch.unique(torch.where(valid, w, -1),
                                     return_inverse=True, return_counts=True)
            at = np.concatenate([self.sample_at(j, m) for j in js]
                                + [np.zeros(0, np.intp)])
            sinvs.append(inv[torch.from_numpy(at).to(dev)] + off)
            qs.append(d)
            cnts.append(c)
            segs.append(torch.full_like(d, ci))
            off += d.numel()
            del w, valid, inv
        return (torch.cat(qs), torch.cat(cnts), torch.cat(segs),
                torch.cat(sinvs))
