"""Big-dictionary run, tools/bigdict_run.py's: build and anchor against
>= 1e8 keys on one card.

    python -m panagram_tpu_torch.tools.bigdict_run [--mbp 26] [--genomes 4]
        [--anchor-mbp 32] [--k 21] [--device cuda]

`--genomes` random genomes of `--mbp` Mbp (np.random.default_rng(0), one
rng.integers(0, 4, glen, dtype=np.uint8) per genome, in order, so they
are the JAX tool's genomes; random sequence is nearly all-distinct at
k=21) stream through the device dictionary builder
(ops.devdict.DeviceDictBuilder), one genome at a time with the key count
synced after each.  At the defaults the union is ~1.04e8 mixed keys.
The builder's sorted arrays are laid out as the bucket table on the
device (DeviceDictBuilder.bucketed: 2^25 buckets x 64 u32 = 8 GiB at the
defaults, 2^25 x 128 at 100 genomes; where no device route fits beside
the table it raises naming the budget, and never lays out on the host),
the builder is freed, and an
`--anchor-mbp` anchor (genome 0 tiled) streams through
ops.anchor.stream_anchor_chunks in 2^22-position chunks: one warm-up pass,
then the best of 3.  main asserts at least 1e8 keys, as the JAX tool does.
--device cpu runs the kernels' plain versions.

The JAX tool's prewarm_anchor_programs call, which overlapped its
programs' compiles with the count on its TPU rig, has no counterpart: the
kernels build once, at first use.  Its "rle v..." line named the run-length
transfer protocol; this engine copies the dense bytes back ("copy-back
dense").
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

# positions per builder and anchor chunk (the JAX tool's; the tests set
# smaller ones)
CHUNK = 1 << 22
PASSES = 3               # timed anchor passes after the warm-up


@dataclasses.dataclass
class BigDictRun:
    """What one run measured and made (run())."""

    D: int                  # keys of the dictionary (the builder's count)
    k: int
    ngenomes: int
    nwords: int
    nbytes: int             # bitmap bytes per position
    genomes: list           # codes uint8 per genome
    anchor_codes: np.ndarray
    walls: dict             # s: "count_merge", "layout", per genome "merge"
    builder_walls: dict     # DeviceDictBuilder.walls
    capacity: int           # rows of the builder's arrays
    route: str              # the route that laid the table out
    nbits: int
    cap: int
    stride: int
    table_bytes: int
    peaks: dict             # peak device bytes: "builder", "layout" and
    #                         "layout_base" (allocated before the layout);
    #                         None on the CPU
    passes: list            # per timed pass: kmers_per_s, wall, pack, copy
    best: float             # best pass, k-mers/s
    bytes: np.ndarray       # the warm-up pass's bitmap bytes [P, nbytes]
    popc: np.ndarray        # its popcounts [P]
    colsums: list           # its (start, m, colsums int64 [ngenomes]) per chunk
    bd: object              # the laid-out ops.lookup.BucketedDict

    @property
    def nkmers(self) -> int:
        return len(self.popc)

    @property
    def best_pass(self) -> dict:
        return max(self.passes, key=lambda p: p["kmers_per_s"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def run(genomes: int = 4, mbp: float = 26.0, anchor_mbp: float = 32.0,
        k: int = 21, *, device="cuda", min_keys: int = 0) -> BigDictRun:
    """The JAX tool's run on `device`, printing its lines: count and merge
    `genomes` random genomes of `mbp` Mbp through the device builder (the
    key count synced after each), assert at least `min_keys` keys (main:
    1e8, before the layout, as the JAX tool), lay the table out on the
    device from the builder's arrays, free the builder, then anchor genome
    0 tiled to `anchor_mbp` Mbp: one warm-up pass (its outputs kept) and
    PASSES timed ones, in chunks of CHUNK positions (the builder's too)."""
    from panagram_tpu_torch.ops.anchor import stream_anchor_chunks
    from panagram_tpu_torch.ops.devdict import DeviceDictBuilder
    from panagram_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    glen = int(mbp * 1e6)
    n = genomes
    chunk = CHUNK
    name = f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""
    print(f"device={dev}{name}  {n} genomes x {glen / 1e6:g} Mbp k={k}",
          flush=True)

    rng = np.random.default_rng(0)
    _reset_peak(dev)
    t0 = time.perf_counter()
    b = DeviceDictBuilder(k, n, chunk, capacity_hint=int(n * glen * 1.05),
                          device=dev)
    codes_list, merge_s = [], []
    for g in range(n):
        codes = rng.integers(0, 4, glen, dtype=np.uint8)
        codes_list.append(codes)
        tg = time.perf_counter()
        b.add_sequence(g, codes)
        cnt = b.synced_count()
        merge_s.append(time.perf_counter() - tg)
        print(f"  merged genome {g}: {cnt:,} keys ({merge_s[-1]:.1f}s)",
              flush=True)
    t_count = time.perf_counter() - t0
    D = b.synced_count()
    builder_peak = _peak(dev)
    print(f"count+merge: {D:,} keys in {t_count:.1f}s "
          f"({n * glen / t_count / 1e6:.1f} Mbp/s)", flush=True)
    assert D >= min_keys, f"expected >= {min_keys:,} keys, got {D:,}"

    # the builder keeps its arrays sorted in mixed space, so the layout
    # takes the sorted-input route (no grouping sort); where neither device
    # route fits it raises naming the budget, as the JAX tool keeps keys
    # and table off the host
    W = b.nwords
    _reset_peak(dev)
    layout_base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" \
        else None
    t0 = time.perf_counter()
    bd = b.bucketed(host_layout=False)
    (table,) = bd.device_arrays(device=dev)
    _sync(dev)
    t_layout = time.perf_counter() - t0
    layout_peak = _peak(dev)
    builder_walls = dict(b.walls)
    capacity = b.keys.shape[0]
    del b
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    table_bytes = table.numel() * 4
    print(f"bucket table: 2^{bd.nbits} x {bd.stride} u32 = "
          f"{table_bytes / 1e9:.1f} GB ({table_bytes / 2**30:.2f} GiB) "
          f"resident on device after {t_layout:.1f}s (sorted-input device "
          f"layout, route {bd.route})", flush=True)

    nbytes = (n + 7) // 8
    alen = int(anchor_mbp * 1e6)
    reps = -(-alen // glen)
    anchor_codes = np.tile(codes_list[0], reps)[:alen]
    nk = alen - k + 1
    buf = np.full(chunk + k - 1, 255, np.uint8)
    state: dict = {}

    def one_pass(phase: dict, keep=None) -> int:
        total = 0
        for s, m, by, popc, cs in stream_anchor_chunks(
                anchor_codes, nk, chunk, buf, table, bd, nbytes, n, k,
                state=state, phase=phase):
            if keep is not None:
                keep[0][s:s + m] = by
                keep[1][s:s + m] = popc
                keep[2].append((s, m, cs.copy()))
            total += m
        return total

    # panagram_tpu's run-length wire protocols are struck: the port copies
    # the dense bytes back
    print("anchor warmup (copy-back dense)...", flush=True)
    keep = (np.empty((nk, nbytes), np.uint8), np.empty(nk, np.int32), [])
    one_pass({}, keep)
    passes = []
    for _ in range(PASSES):
        phase: dict = {}
        t0 = time.perf_counter()
        total = one_pass(phase)
        dt = time.perf_counter() - t0
        passes.append({"kmers_per_s": total / dt, "wall": dt,
                       "pack": phase["pack"], "copy": phase["copy"]})
        print(f"  anchor rep: {total / dt / 1e6:.1f} Mkmers/s (wall {dt:.6f} "
              f"s, pack {phase['pack']:.6f} s, copy {phase['copy']:.6f} s)",
              flush=True)
    best = max(p["kmers_per_s"] for p in passes)
    print(f"RESULT: {D:,}-key dict on one card; table "
          f"{table_bytes / 1e9:.1f} GB; count+merge {t_count:.1f}s; layout "
          f"{t_layout:.1f}s; anchor {best / 1e6:.1f} Mkmers/s", flush=True)
    return BigDictRun(
        D=D, k=k, ngenomes=n, nwords=W, nbytes=nbytes, genomes=codes_list,
        anchor_codes=anchor_codes,
        walls={"count_merge": t_count, "layout": t_layout, "merge": merge_s},
        builder_walls=builder_walls, capacity=capacity, route=bd.route,
        nbits=bd.nbits, cap=bd.cap, stride=bd.stride, table_bytes=table_bytes,
        peaks={"builder": builder_peak, "layout": layout_peak,
               "layout_base": layout_base},
        passes=passes, best=best, bytes=keep[0], popc=keep[1],
        colsums=keep[2], bd=bd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mbp", type=float, default=26.0,
                    help="Mbp per genome")
    ap.add_argument("--genomes", type=int, default=4)
    ap.add_argument("--anchor-mbp", type=float, default=32.0)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                    "plain versions)")
    args = ap.parse_args(argv)
    run(args.genomes, args.mbp, args.anchor_mbp, args.k, device=args.device,
        min_keys=100_000_000)
    return 0


if __name__ == "__main__":
    main()
