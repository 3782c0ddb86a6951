"""Kernel times on the card's own clock:

    python -m panagram_tpu_torch.tools.kernel_times

times masks_to_bytes and fused_popcount_colsums at the anchor path's shapes
([2^22, 1] with 30 genomes, [2^22, 2] with 40) after checking each against
its plain version.  It needs a CUDA device.  To time two versions of a
kernel side by side, run it from a copy of the tree that holds the other
version's csrc/ and from this tree, in the order old, new, new, old on one
card.

The timers, which chip_smoke.py uses too:

``one_call_ms``  one call between two CUDA events.  The host's work for the
    call (allocating the outputs, the ctypes call, the launch) happens while
    the card waits, so it sits inside the reading; at a few hundredths of a
    millisecond it can be most of it.  Kept to show what it read.
``warm_ms``  many calls queued behind a blocker (``torch.cuda._sleep``), so
    the host has queued all of them before the first one starts and the
    events around them read the card's time alone.  The same buffers again
    and again: the 50 MB L2 may hold them.
``cold_ms``  each call between its own pair of events, all queued behind
    the blocker, with more than the L2's size read and written between the
    calls (and outside the pairs).  The reading of an empty pair, taken the
    same way, is returned beside it and subtracted from nothing: a kernel
    between two events need not pay the whole of that gap, so the reading
    as it stands is the one a bound is held against.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

SLEEP_CYCLES = 20_000_000     # ~10 ms of the card's clock
FLUSH_BYTES = 128 << 20       # over twice the 50 MB L2
ROWS_LOG2 = 22
CASES = ((1, 30), (2, 40))    # (mask words, genomes)


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


def mask_rows(P: int, W: int, ngenomes: int, device, seed: int = 0):
    """Random mask rows int32 [P, W] with no bit at or past ngenomes."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows = torch.randint(-(1 << 31), 1 << 31, (P, W), generator=g,
                         device=device, dtype=torch.int64)
    top = (1 << (ngenomes - 32 * (W - 1))) - 1
    rows[:, -1] &= top
    return rows.to(torch.int32)


def main(argv=None) -> int:
    from ..ops import kernels

    p = argparse.ArgumentParser(prog="panagram_tpu_torch.tools.kernel_times",
                                description=__doc__.split("\n\n")[0])
    p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    print(f"device={torch.cuda.get_device_name(dev)}", flush=True)
    P = 1 << ROWS_LOG2
    flush = Flush(dev)
    cases = {
        "masks_to_bytes": (
            lambda rows, N: (kernels.masks_to_bytes(rows, (N + 7) // 8),),
            lambda rows, N: (kernels.masks_to_bytes_plain(rows, (N + 7) // 8),)),
        "fused_popcount_colsums": (kernels.fused_popcount_colsums,
                                   kernels.fused_popcount_colsums_plain),
    }
    ok = True
    print(f"rows [2^{ROWS_LOG2}, W]; ms per call: warm (back to back) / "
          "cold (L2 flushed; the empty event pair is not subtracted)",
          flush=True)
    for W, N in CASES:
        rows = mask_rows(P, W, N, dev)
        for name, (kern, plain) in cases.items():
            same = all(torch.equal(a, b)
                       for a, b in zip(kern(rows, N), plain(rows, N)))
            ok &= same
            warm = warm_ms(lambda: kern(rows, N))
            cold, empty = cold_ms(lambda: kern(rows, N), flush)
            print(f"  {name:24s} W={W} N={N}: {warm:.5f} / {cold:.5f} ms "
                  f"(empty pair {empty:.5f}); equals its plain version: "
                  f"{same}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
