"""Kernel times on the card's own clock:

    python -m panagram_tpu_torch.tools.kernel_times [--sweep] [--profile [FILE]]

builds a main-path-sized chunk (2^22 positions, k=31, a 1.3e7-key table;
W=1 with 30 genomes, then W=2 with 40), checks each of the four anchor
kernels against its plain version and times it, then times one whole
``ops.anchor.anchor_chunk_fast`` with its inputs on the card and prints it as
one JSON line, ``{"chunk": {...}}``, beside the sum of its kernels: the
difference is the library operations between the kernels (the queries'
sort, two gathers, the inverse scatter) and any wait of the host.  It
needs a CUDA device.  ``--sweep`` times pack_mix under grid caps of 2 to
32 blocks per SM and at a k without an instance of its own; ``--profile`` lists the device time of every operation
of one chunk with torch.profiler (the 30 largest; all of them into FILE).
To time two versions of a kernel or of
the chunk side by side, run it from a copy of the tree that holds the
other version (with this file) and from this tree, in the order old, new,
new, old on one card.

The timers, which chip_smoke.py uses too:

``one_call_ms``  one call between two CUDA events.  The host's work for the
    call (allocating the outputs, the ctypes call, the launch) happens while
    the card waits, so it sits inside the reading; at a few hundredths of a
    millisecond it can be most of it.  Kept to show what it read.
``warm_ms``  many calls queued behind a blocker (``torch.cuda._sleep``), so
    the host has queued all of them before the first one starts and the
    events around them read the card's time alone.  The same buffers again
    and again: the 50 MB L2 may hold them.  A call that makes the host
    wait for the card cannot be queued ahead: the timer then raises.
``cold_ms``  each call between its own pair of events, all queued behind
    the blocker, with more than the L2's size read and written between the
    calls (and outside the pairs).  The reading of an empty pair, taken the
    same way, is returned beside it and subtracted from nothing: a kernel
    between two events need not pay the whole of that gap, so the reading
    as it stands is the one a bound is held against.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

import numpy as np
import torch

SLEEP_CYCLES = 20_000_000     # ~10 ms of the card's clock
FLUSH_BYTES = 128 << 20       # over twice the 50 MB L2
K = 31
CHUNK = 1 << 22               # positions per anchor chunk
DICT_KEYS = 13_000_000        # the table of a 30 x 5 Mbp pan-genome
GENOMES = (30, 40)            # W = 1 and W = 2
ANCHOR_KERNELS = ("pack_mix", "probe_sorted", "fused_popcount_colsums",
                  "masks_to_bytes")
SWEEP_BLOCKS_PER_SM = (2, 4, 8, 16, 32)
SMS = 132


def _event():
    return torch.cuda.Event(enable_timing=True)


def one_call_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of fn(), each call between two CUDA events with
    the card idle before it, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = _event(), _event()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _behind_blocker(enqueue):
    """Call enqueue() while the card sleeps, and return what it returns once
    the card has run it all.  Repeats with a longer sleep until the host
    was done queueing before the card woke."""
    cycles = SLEEP_CYCLES
    while True:
        start, woke = _event(), _event()
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        woke.record()
        t0 = time.perf_counter()
        out = enqueue()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < start.elapsed_time(woke):
            return out
        cycles *= 2
        if cycles > 1 << 34:
            raise RuntimeError(f"the host needs {host_ms:.1f} ms to queue the "
                               "run; no blocker is long enough")


def warm_ms(fn, launches: int = 50, runs: int = 5) -> float:
    """Median over `runs` of the card's milliseconds per call of `launches`
    calls of fn() queued back to back."""
    for _ in range(2):
        fn()

    def enqueue():
        a, b = _event(), _event()
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        return a, b

    times = []
    for _ in range(runs):
        a, b = _behind_blocker(enqueue)
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


class Flush:
    """Pushes everything out of the L2: adds one to FLUSH_BYTES of device
    memory, then reads them again, so that the lines left in the cache are
    clean and the next kernel pays for no write-back."""

    def __init__(self, device):
        self.buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32,
                               device=device)

    def __call__(self):
        self.buf.add_(1)
        self.buf.sum()


def cold_ms(fn, flush: Flush, reps: int = 20) -> tuple[float, float]:
    """(the card's milliseconds between the events around one fn() that
    finds the L2 flushed, the reading of an empty event pair)."""
    fn()

    def enqueue(call):
        pairs = []
        for _ in range(reps):
            flush()
            a, b = _event(), _event()
            a.record()
            call()
            b.record()
            pairs.append((a, b))
        return pairs

    def median(call):
        pairs = _behind_blocker(lambda: enqueue(call))
        return float(np.median([a.elapsed_time(b) for a, b in pairs]))

    return median(fn), median(lambda: None)


def chunk_inputs(dev, ngenomes: int, rng) -> types.SimpleNamespace:
    """One main-path-sized chunk on the card: CHUNK positions of random
    bases with 2% N, packed, and the bucket table of a dictionary of
    DICT_KEYS keys that holds half of the chunk's k-mers, with random masks
    over ngenomes bits."""
    from ..ops.codec import pack_bases_np, pack_kmers, u64_np
    from ..ops.lookup import BucketedDict

    L = CHUNK + K - 1
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.choice(L, L // 50, replace=False)] = 255
    canon, valid = pack_kmers(torch.from_numpy(codes).to(dev), K)
    keys = u64_np(torch.unique(canon[valid]))
    keys = keys[rng.random(len(keys)) < 0.5]
    keys = np.unique(np.concatenate(
        [keys, rng.integers(0, 1 << 62, max(DICT_KEYS - len(keys), 0),
                            dtype=np.uint64)]))
    W = (ngenomes + 31) // 32
    masks = rng.integers(1, 1 << 32, (len(keys), W), dtype=np.uint64)
    masks[:, -1] &= np.uint64((1 << (ngenomes - 32 * (W - 1))) - 1)
    bd = BucketedDict.build_device(keys, masks.astype(np.uint32), ngenomes, K,
                                   device=dev)
    packed, nmask, _ = pack_bases_np(codes)
    return types.SimpleNamespace(
        L=L, k=K, W=W, ngenomes=ngenomes, nbytes=(ngenomes + 7) // 8, bd=bd,
        nkeys=len(keys), p=torch.from_numpy(packed).to(dev),
        n=torch.from_numpy(nmask).to(dev))


def kernel_cases(inp) -> types.SimpleNamespace:
    """The four anchor kernels at the chunk's shapes: cases {name: (kernel
    call, plain call)}, shapes {name: the arguments of kernels.bound_bytes}
    (for probe_sorted the table rows these queries touch are counted on the
    card), the probe plan and the share of positions that hit."""
    from ..ops import kernels
    from ..ops.lookup import plan_probe

    p, n, L, bd, W, nbytes = inp.p, inp.n, inp.L, inp.bd, inp.W, inp.nbytes
    hi, lo = kernels.pack_mix(p, n, L, K, CHUNK)
    plan = plan_probe(hi, lo, bd.nbits)
    pargs = (plan.qhi, plan.qlo, plan.blo, bd.table, bd.nbits, bd.cap,
             bd.nwords, plan.span, plan.tile_q)
    rows = kernels.probe_sorted(*pargs)
    torch.cuda.synchronize()
    valid = ~((plan.qhi == -1) & (plan.qlo == -1))
    touched = torch.unique(kernels.probe_rows(
        plan.qhi, plan.blo, bd.nbits, plan.span, plan.tile_q)[valid]).numel()
    shapes = {
        "pack_mix": dict(L=L, k=K, Ppad=CHUNK),
        "probe_sorted": dict(Q=CHUNK, nwords=W, tile_q=plan.tile_q,
                             stride=bd.stride, rows_touched=touched),
        "fused_popcount_colsums": dict(P=CHUNK, W=W, ngenomes=32 * W),
        "masks_to_bytes": dict(P=CHUNK, W=W, nbytes=nbytes),
    }
    cases = {
        "pack_mix": (lambda: kernels.pack_mix(p, n, L, K, CHUNK),
                     lambda: kernels.pack_mix_plain(p, n, L, K, CHUNK)),
        "probe_sorted": (lambda: (kernels.probe_sorted(*pargs),),
                         lambda: (kernels.probe_sorted_plain(*pargs),)),
        "fused_popcount_colsums": (
            lambda: kernels.fused_popcount_colsums(rows, 32 * W),
            lambda: kernels.fused_popcount_colsums_plain(rows, 32 * W)),
        "masks_to_bytes": (lambda: (kernels.masks_to_bytes(rows, nbytes),),
                           lambda: (kernels.masks_to_bytes_plain(rows, nbytes),)),
    }
    return types.SimpleNamespace(
        cases=cases, shapes=shapes, plan=plan, rows=rows, touched=touched,
        queries=int(valid.sum()),
        hit_frac=float((rows != 0).any(dim=1).float().mean()))


def chunk_call(inp):
    """() -> one whole anchor_chunk_fast on the card's inputs."""
    from ..ops.anchor import anchor_chunk_fast

    bd = inp.bd
    return lambda: anchor_chunk_fast(inp.p, inp.n, bd.table, inp.L, inp.k,
                                     bd.nbits, bd.cap, bd.nwords, inp.nbytes)


def host_syncs(fn) -> bool:
    """Whether fn() makes the host wait for the card (a read-back, a
    nonzero, a synchronize): torch's sync debug mode raises on the first."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return False


def chunk_times(inp, flush: Flush, kernel_ms: dict) -> dict:
    """Times of one whole anchor_chunk_fast beside the sums of its four kernels
    (kernel_ms: {name: {"warm_ms", "cold_ms"}}).  `host_ms` is the host's
    own time inside one call with the card idle before it: the enqueue
    alone when the call never waits for the card, else the wait as well.
    warm_ms and cold_ms are None when the host waits inside the call, so
    that nothing can be queued ahead; `one_call_ms` (the call between two
    events, the host's time inside) reads either kind."""
    fn = chunk_call(inp)
    out = {"genomes": inp.ngenomes, "positions": CHUNK, "k": inp.k,
           "host_syncs": host_syncs(fn), "one_call_ms": one_call_ms(fn)}
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out["host_ms"] = float(np.median(host))
    out["warm_ms"] = out["cold_ms"] = None
    if not out["host_syncs"]:
        out["warm_ms"] = warm_ms(fn, launches=20)
        out["cold_ms"], _ = cold_ms(fn, flush)
    for which in ("warm_ms", "cold_ms"):
        total = sum(kernel_ms[name][which] for name in ANCHOR_KERNELS)
        out["kernels_" + which] = total
        whole = out[which] if out[which] is not None else out["one_call_ms"]
        out["around_kernels_" + which] = whole - total
    return out


def profile_chunk(inp, reps: int = 3) -> list[tuple[str, int, float]]:
    """torch.profiler over `reps` whole chunks: (operation or kernel name,
    calls per chunk, device microseconds per chunk), largest first; empty
    when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn = chunk_call(inp)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device kernels and copies only: an operator's row repeats the time
        # of the kernels it launched
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                rows.append((e.key, e.count // reps, us / reps))
    return sorted(rows, key=lambda r: -r[2])


def main(argv=None) -> int:
    from ..ops import kernels

    p = argparse.ArgumentParser(prog="panagram_tpu_torch.tools.kernel_times",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", action="store_true",
                   help="time pack_mix under several grid caps")
    p.add_argument("--profile", nargs="?", const="", metavar="FILE",
                   help="list one chunk's device time by operation, in "
                        "full into FILE")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    print(f"device={torch.cuda.get_device_name(dev)}", flush=True)
    flush = Flush(dev)
    rng = np.random.default_rng(1)
    ok = True
    print(f"chunk of 2^{CHUNK.bit_length() - 1} positions, k={K}; ms per "
          "call: warm (back to back) / cold (L2 flushed; the empty event "
          "pair is not subtracted)", flush=True)
    for N in GENOMES:
        inp = chunk_inputs(dev, N, rng)
        kc = kernel_cases(inp)
        times = {}
        for name, (kern, plain) in kc.cases.items():
            same = all(torch.equal(a, b) for a, b in zip(kern(), plain()))
            ok &= same
            warm = warm_ms(kern)
            cold, empty = cold_ms(kern, flush)
            times[name] = {"warm_ms": warm, "cold_ms": cold}
            print(f"  {name:24s} W={inp.W} N={N}: {warm:.5f} / {cold:.5f} ms "
                  f"(empty pair {empty:.5f}); equals its plain version: "
                  f"{same}", flush=True)
        print(json.dumps({"chunk": chunk_times(inp, flush, times)}),
              flush=True)
        if args.sweep and N == GENOMES[0]:
            hi = torch.empty(CHUNK, dtype=torch.int32, device=dev)
            lo = torch.empty_like(hi)
            for per_sm in SWEEP_BLOCKS_PER_SM:
                def capped(cap=per_sm * SMS):
                    kernels._pack_mix_into(inp.p, inp.n, inp.L, K, hi, lo, cap)
                print(f"  pack_mix, grid cap {per_sm:2d} blocks per SM: "
                      f"{warm_ms(capped):.5f} / {cold_ms(capped, flush)[0]:.5f}"
                      " ms", flush=True)
            # k = 30 has no instance of its own: what k as a constant buys

            def runtime_k():
                kernels._pack_mix_into(inp.p, inp.n, inp.L - 1, K - 1, hi, lo)
            print(f"  pack_mix, k={K - 1} (the instance that reads k): "
                  f"{warm_ms(runtime_k):.5f} / "
                  f"{cold_ms(runtime_k, flush)[0]:.5f} ms", flush=True)
        if args.profile is not None and N == GENOMES[0]:
            rows = profile_chunk(inp)
            if not rows:
                print("  torch.profiler showed no device time", flush=True)
            lines = [f"  {us:10.1f} us  x{n:<3d} {name[:110]}"
                     for name, n, us in rows]
            print(f"  one chunk by torch.profiler, device time per chunk "
                  f"(sum {sum(r[2] for r in rows):.1f} us):", flush=True)
            print("\n".join(lines[:30]), flush=True)
            if args.profile:
                with open(args.profile, "w") as f:
                    f.write("\n".join(lines) + "\n")
        del inp, kc
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
