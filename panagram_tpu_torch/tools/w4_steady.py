"""Steady anchoring rate over multi-chunk sequences, tools/w4_steady.py's:

    python -m panagram_tpu_torch.tools.w4_steady [--idx DIR] [--mbp 8]
        [--reps 3] [--chunk 21] [--device cuda]

The 100-genome scale row anchors 2-Mbp genomes, one 2^21-position chunk
each, so its per-genome wall is mostly fixed costs.  This tool measures
the rate the stream sustains once chunks pipeline: it loads an index's
dictionary (`--idx`, default the idx that tools/scale_run.py --keep leaves
under the temporary directory), lays it out on the device once
(BucketedDict.build_device, sorted input for a mixed dictionary), then
streams `--reps` + 1 sequences of `--mbp` Mbp through
ops.anchor.stream_anchor_chunks in 2^`--chunk`-position chunks (match the
producing run) and prints each sequence's wall, the first apart, and the
best steady one in Mbp/s.  The sequences are one random base
(np.random.default_rng(3)) with L/1000 positions mutated per sequence, as
the JAX tool makes them.

Against a founder dictionary nearly every query of such a sequence misses,
so probe_sorted scans each row to its first empty slot: each rep's line
prints the hit share (positions with any genome) and the column sums over
positions, so that a reader knows which regime was timed.  The JAX tool's
prewarm_anchor_programs call (a TPU-rig compile workaround) has no
counterpart.  --device cpu runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

DEFAULT_IDX = os.path.join(tempfile.gettempdir(), "panagram_scale", "idx")


def sequences(L: int, reps: int):
    """The JAX tool's reps + 1 sequences of L bases (codes uint8): one
    random base from np.random.default_rng(3), and per sequence L // 1000
    positions of it drawn again, in the tool's order of calls."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, L, dtype=np.uint8)
    for _ in range(reps + 1):
        codes = base.copy()
        pos = rng.choice(L, L // 1000, replace=False)
        codes[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        yield codes


@dataclasses.dataclass
class SteadyRun:
    """What one run measured (run())."""

    D: int
    ngenomes: int
    k: int
    nwords: int
    layout_s: float
    table_shape: tuple
    reps: list      # per sequence: wall, kmers, hits, colsums int64 [N],
    #                 pack, copy (s)
    best_mbp_s: float
    bd: object      # the laid-out ops.lookup.BucketedDict


def run(idx: str = DEFAULT_IDX, mbp: float = 8.0, reps: int = 3,
        chunk: int = 21, *, device="cuda") -> SteadyRun:
    """The JAX tool's run on `device`, printing its lines: the dictionary
    of the index at `idx` laid out once, then reps + 1 sequences of `mbp`
    Mbp streamed in 2^chunk-position chunks; the first is reported apart
    and the best of the others in Mbp/s."""
    from panagram_tpu_torch.ops.anchor import stream_anchor_chunks
    from panagram_tpu_torch.ops.dictionary import PanKmerDict
    from panagram_tpu_torch.ops.lookup import BucketedDict, pad_pow2
    from panagram_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    d = PanKmerDict.load(os.path.join(idx, "kmc", "pandict.npz"))
    N, k, W = d.ngenomes, d.k, d.masks.shape[1]
    nbytes = (N + 7) // 8
    size = 1 << chunk
    name = f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""
    print(f"device={dev}{name} dict D={len(d.keys)} N={N} k={k} W={W}",
          flush=True)

    t0 = time.perf_counter()
    is_mixed = d.key_space == "mixed"
    pk, pm = pad_pow2(d.keys, d.masks)
    bd = BucketedDict.build_device(pk, pm, N, k, mixed=is_mixed,
                                   count=len(d.keys), sorted_input=is_mixed,
                                   device=dev)
    (table,) = bd.device_arrays(device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    layout_s = time.perf_counter() - t0
    print(f"layout: {layout_s:.1f}s table {tuple(table.shape)}", flush=True)

    L = int(mbp * 1e6)
    nkmers = L - k + 1
    buf = np.empty(size + k - 1, np.uint8)
    state: dict = {}
    out = []
    for rep, codes in enumerate(sequences(L, reps)):
        phase: dict = {}
        t0 = time.perf_counter()
        total = hits = 0
        colsum = np.zeros(N, np.int64)
        for _start, m, _by, popc, cs in stream_anchor_chunks(
                codes, nkmers, size, buf, table, bd, nbytes, N, k,
                state=state, phase=phase):
            total += m
            hits += int(np.count_nonzero(popc))
            colsum += cs
        dt = time.perf_counter() - t0
        out.append({"wall": dt, "kmers": total, "hits": hits,
                    "colsums": colsum, "pack": phase["pack"],
                    "copy": phase["copy"]})
        tag = "first (kernel build/load join)" if rep == 0 else "steady"
        print(f"rep {rep}: {dt:.2f}s = {L / dt / 1e6:.2f} Mbp/s "
              f"({total / dt / 1e6:.1f} M kmers/s) [{tag}]; hit share "
              f"{hits / total:.6f}, column sums over positions "
              f"{colsum.sum() / total:.6f}", flush=True)
    best = min(r["wall"] for r in out[1:]) if reps else out[0]["wall"]
    print(f"W={W} steady: {L / best / 1e6:.2f} Mbp/s best of {reps} "
          f"({mbp} Mbp sequences, chunk 2^{chunk})", flush=True)
    return SteadyRun(D=len(d.keys), ngenomes=N, k=k, nwords=W,
                     layout_s=layout_s, table_shape=tuple(table.shape),
                     reps=out, best_mbp_s=L / best / 1e6, bd=bd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--idx", default=DEFAULT_IDX)
    ap.add_argument("--mbp", type=float, default=8.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=21,
                    help="log2 chunk (match the producing run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                    "plain versions)")
    args = ap.parse_args(argv)
    run(args.idx, args.mbp, args.reps, args.chunk, device=args.device)
    return 0


if __name__ == "__main__":
    main()
