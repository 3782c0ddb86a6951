#!/usr/bin/env python3
"""Benchmark of panagram_tpu_torch: anchoring throughput, bench.py's
configuration on one CUDA card.

    python3 bench_torch.py [--quick] [--device cuda|cpu]

The counterpart of bench.py.  The problem is bench.py's: 30 founder-
structured genomes of 2^21 bp (seed 0, bench.py's generator), k=21, their
pan-genome dictionary laid out as the bucket table on the device, and a
2^25-bp anchor (genome 0 tiled) streamed in 2^22-position chunks
(--quick: 2^18-bp genomes, a 2^20-bp anchor, 2^18-position chunks;
PANAGRAM_TPU_BENCH_CHUNK_LOG2 sets the chunk).  The set-up is untimed.

Timed, as bench.py times them:
- the streamed chunk loop, ops.anchor.stream_anchor_chunks: the host's
  copy of each chunk's codes into a pinned buffer, its upload, the
  pack_bases kernel and the four anchor kernels per chunk, the dense
  copy-back of bytes, popcounts and column sums.  One warm-up pass, then
  the best of 3 passes (1 with --quick), each over the whole anchor.  The
  first 2^17 streamed positions must equal the numpy oracle before any
  pass is timed.  PANAGRAM_BENCH_TRACE=1 prints each chunk's wait.
- the device-compute rate: one ops.anchor.anchor_chunk_fast on one
  chunk's packed bases, already on the device, from dispatch to
  completion (no transfer inside), best of 3.
- the baseline: native.anchor_cpu.CpuAnchorer, the C++ host anchorer on
  os.cpu_count() threads, over the whole anchor (--quick: 2^18 bp) into
  pre-touched buffers, best of the same reps.  Its bytes must equal the
  stream's.  The stream is the chunk loop alone: no BGZF, no histograms,
  no embeddings, which the index build's anchor stages add.

A check that fails raises, so the script exits non-zero and prints no
line.  Everything but the line goes to stderr; the last line of stdout is
bench.py's JSON:
  {"metric": "anchor_kmers_per_s", "value": N, "unit": "kmers/s",
   "vs_baseline": N / cpu_kmers_per_s, "device_compute_kmers_per_s": N}
--device cpu runs the kernels' plain torch versions, for the tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

K = 21
NGENOMES = 30
ORACLE_POSITIONS = 1 << 17


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


@dataclasses.dataclass
class Problem:
    """bench.py's problem, laid out on the device."""

    k: int
    ngenomes: int
    seq_len: int           # anchor bases
    chunk: int             # positions per streamed chunk
    genomes: list          # codes uint8 per genome
    anchor_codes: np.ndarray
    pan: object            # ops.dictionary.PanKmerDict
    bd: object             # ops.lookup.BucketedDict
    table: torch.Tensor    # bd's table on the device
    nbytes: int            # bitmap bytes per position


def make_problem(quick: bool, device) -> Problem:
    """The genomes, their dictionary and bucket table on `device`, and the
    anchor, at bench.py's sizes, from bench.py's generator (seed 0).  Each
    genome's distinct k-mer set is counted on the device (ops.count), not
    by np.unique."""
    from panagram_tpu_torch.ops.count import distinct_kmers_chunked
    from panagram_tpu_torch.ops.dictionary import build_dictionary
    from panagram_tpu_torch.ops.lookup import BucketedDict
    from panagram_tpu_torch.tools.scale_run import founder_genomes

    seq_len = 1 << (20 if quick else 25)
    dict_genome_len = 1 << (18 if quick else 21)
    chunk = 1 << int(os.environ.get("PANAGRAM_TPU_BENCH_CHUNK_LOG2",
                                    18 if quick else 22))
    genomes = list(founder_genomes(NGENOMES, dict_genome_len,
                                   np.random.default_rng(0)))
    sets = [distinct_kmers_chunked([g], K, device=device) for g in genomes]
    pan = build_dictionary(sets, K, NGENOMES, device=device)
    bd = BucketedDict.build_device(pan.keys, pan.masks, NGENOMES, K,
                                   device=device)
    (table,) = bd.device_arrays(device=device)
    reps = -(-seq_len // dict_genome_len)
    anchor_codes = np.tile(genomes[0], reps)[:seq_len]
    return Problem(K, NGENOMES, seq_len, chunk, genomes, anchor_codes, pan,
                   bd, table, pan.nbytes_row)


def main(argv=None) -> dict:
    """Runs the benchmark, prints its line last on stdout and returns the
    line as a dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="bench.py's --quick sizes")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: --device cuda needs a CUDA card, and "
                           "torch.cuda.is_available() is false")

    from panagram_tpu_torch.native.anchor_cpu import CpuAnchorer
    from panagram_tpu_torch.ops.anchor import (
        anchor_chunk_fast,
        stream_anchor_chunks,
    )
    from panagram_tpu_torch.ops.codec import pack_bases_np
    from panagram_tpu_torch.ops.ref_impl import anchor_np, masks_to_bytes_np

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    where = (f"{card_line()} ({torch.cuda.get_device_name(dev)})" if cuda
             else "cpu, the kernels' plain versions")
    _log(f"bench: device={dev} [{where}] quick={args.quick}")
    t0 = time.perf_counter()
    p = make_problem(args.quick, dev)
    k, nbytes, bd = p.k, p.nbytes, p.bd
    _log(f"bench: dict {len(p.pan)} keys x {p.pan.nwords} words")
    _log(f"bench: bucketed {tuple(bd.table.shape)} stride {bd.stride}")
    _log(f"bench: set-up {time.perf_counter() - t0:.3f} s (untimed)")
    # panagram_tpu's run-length wire protocols are struck: the port copies
    # the dense bytes back
    _log("bench: copy-back dense")

    nk = p.seq_len - k + 1
    state: dict = {}
    trace = os.environ.get("PANAGRAM_BENCH_TRACE") == "1"
    buf = np.full(p.chunk + k - 1, 255, np.uint8)

    def run_once(phase: dict, keep: np.ndarray | None = None) -> int:
        total = 0
        for start, m, by, _popc, _cs in stream_anchor_chunks(
                p.anchor_codes, nk, p.chunk, buf, p.table, bd, nbytes,
                p.ngenomes, k, state=state, trace=trace, phase=phase):
            if keep is not None:
                keep[start:start + m] = by
            total += m
        return total

    # warm-up: builds the kernels on first use; its bytes are kept for the
    # baseline's check
    stream_bytes = np.empty((nk, nbytes), np.uint8)
    run_once({}, stream_bytes)
    _log("bench: warmup done")

    # the card against the numpy oracle before any pass is timed
    p_n = min(ORACLE_POSITIONS, nk)
    got = np.concatenate([by.copy() for _s, _m, by, _p, _c in
                          stream_anchor_chunks(
                              p.anchor_codes[: p_n + k - 1], p_n, p.chunk,
                              buf, p.table, bd, nbytes, p.ngenomes, k,
                              state=dict(state))])
    want = anchor_np(p.anchor_codes[: p_n + k - 1], k, p.pan.keys,
                     p.pan.masks)
    if not np.array_equal(got, masks_to_bytes_np(want, nbytes)):
        raise AssertionError("bench_torch: device/oracle bitmap mismatch over "
                             f"the first {p_n} positions")
    _log(f"bench: device parity vs oracle OK ({p_n} positions)")

    # best of 3 on both sides of the ratio: host walls move between runs
    reps = 1 if args.quick else 3
    device_rate, best = 0.0, None
    for _ in range(reps):
        phase: dict = {}
        t0 = time.perf_counter()
        total = run_once(phase)
        dt = time.perf_counter() - t0
        _log(f"bench: device rep {total / dt / 1e6:.2f} Mkmers/s (wall "
             f"{dt:.6f} s, pack {phase['pack']:.6f} s, copy "
             f"{phase['copy']:.6f} s)")
        if total / dt > device_rate:
            device_rate, best = total / dt, (dt, phase)
    dt, phase = best
    _log(f"bench: device {device_rate / 1e6:.2f} Mkmers/s; best rep wall "
         f"{dt:.6f} s: pack {phase['pack']:.6f} s, copy {phase['copy']:.6f} s")

    # the device's compute alone: one chunk from dispatch to completion,
    # its packed bases already on the device
    packed, nmask, L = pack_bases_np(p.anchor_codes[: p.chunk + k - 1])
    packed = torch.from_numpy(packed).to(dev)
    nmask = torch.from_numpy(nmask).to(dev)
    sync()

    def compute_once():
        anchor_chunk_fast(packed, nmask, p.table, L, k, bd.nbits, bd.cap,
                          bd.nwords, nbytes)
        sync()

    compute_once()
    compute_rate = 0.0
    for _ in range(max(reps, 3)):
        t0 = time.perf_counter()
        compute_once()
        compute_rate = max(compute_rate,
                           (L - k + 1) / (time.perf_counter() - t0))
    _log(f"bench: device-compute-only {compute_rate / 1e6:.2f} Mkmers/s "
         "(anchor_chunk_fast, one chunk, no transfers)")

    # the baseline: the C++ host anchorer (no fallback: its import raises
    # OSError when the library does not build)
    ncores = os.cpu_count() or 1
    cpu_len = (1 << 18 if args.quick else p.seq_len) - k + 1
    ca = CpuAnchorer(p.pan.keys, p.pan.masks)
    cpu_b = np.zeros((cpu_len, nbytes), np.uint8)
    cpu_p = np.zeros(cpu_len, np.int32)
    cpu_rate = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        ca.anchor(p.anchor_codes[: cpu_len + k - 1], k, nbytes,
                  threads=ncores, out=(cpu_b, cpu_p))
        cpu_rate = max(cpu_rate, cpu_len / (time.perf_counter() - t0))
    _log(f"bench: cpu baseline (C++ hash, {ncores} threads) "
         f"{cpu_rate / 1e6:.2f} Mkmers/s")
    if not np.array_equal(cpu_b, stream_bytes[:cpu_len]):
        raise AssertionError("bench_torch: the host anchorer's bytes differ "
                             f"from the stream's over {cpu_len} positions")
    _log(f"bench: cpu baseline bytes equal the stream's ({cpu_len} "
         "positions)")

    line = {
        "metric": "anchor_kmers_per_s",
        "value": round(device_rate),
        "unit": "kmers/s",
        "vs_baseline": round(device_rate / cpu_rate, 3),
        "device_compute_kmers_per_s": round(compute_rate),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
