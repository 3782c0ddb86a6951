"""Spans and counters of the anchor stream and the build, on the
profiler's clock.

The one timing mechanism of these paths.  ``span(name)`` marks a step and
``count(name, n)`` counts its work; both record only while a recording is
open::

    with spans.recording() as rec:
        ...                      # run the program
    rec.totals()                 # per span name and per counter

While no recording is open a span costs one flag check: it enters no
``torch.profiler.record_function``, records no CUDA event and allocates
nothing (one shared null context).  The exception is a span given
``phase``: it still adds its seconds to ``phase[key]``, on the host clock,
or with ``device`` on a CUDA device from a pair of timing events around
it, read once the work is known complete (``settle``).

While a recording is open a span also keeps its name, start and end
(``time.perf_counter_ns``), its parent span and its thread (each thread
has its own stack); enters ``record_function(name)``, so that its range
lands in a running profiler's trace as a ``user_annotation`` on the
profiler's clock; and with ``device`` on a CUDA device records a pair of
timing events on the current stream, taken from a pool.  Event pairs are
read only where their stream's work is already complete: by ``settle``,
which the anchor stream calls once it has waited for a chunk's results,
and at the recording's close.  The recorder adds no host synchronisation
to the hot path.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_REC = None                      # the open Recording, or None
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()         # guards _POOL and _PENDING
_POOL: dict = {}                 # CUDA device index -> free timing events
_PENDING: list = []   # [record | None, device, start, end, phase, key]


class SpanRecord:
    """One span of a recording; times in perf_counter nanoseconds,
    device_s the card's seconds between its events (None: no pair, or not
    read yet)."""

    __slots__ = ("id", "name", "parent", "thread", "start_ns", "end_ns",
                 "device_s")

    def __init__(self, id: int, name: str, parent, thread: int,
                 start_ns: int):
        self.id, self.name, self.parent, self.thread = id, name, parent, thread
        self.start_ns, self.end_ns, self.device_s = start_ns, None, None


class Recording:
    """The spans and counters recorded while it is open, in memory."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, name: str, n: int):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def totals(self) -> dict:
        """{"spans": {name: {"count", "host_s", "self_s", "device_s"}},
        "counters": {name: value}}: host_s the spans' summed length,
        self_s that less the time their direct child spans cover,
        device_s the summed seconds of their event pairs (None where no
        pair was recorded or read).  Spans still open are left out."""
        child = {}
        for r in self.spans:
            if r.end_ns is not None and r.parent is not None:
                child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
        out: dict = {}
        for r in self.spans:
            if r.end_ns is None:
                continue
            t = out.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                        "self_s": 0.0, "device_s": None})
            host = (r.end_ns - r.start_ns) / 1e9
            t["count"] += 1
            t["host_s"] += host
            t["self_s"] += host - child.get(r.id, 0) / 1e9
            if r.device_s is not None:
                t["device_s"] = (t["device_s"] or 0.0) + r.device_s
        with self._lock:
            counters = dict(self.counters)
        return {"spans": out, "counters": counters}


class _Span:
    __slots__ = ("name", "cuda", "phase", "key", "rec", "row", "rf", "ev",
                 "t0")

    def __init__(self, name, cuda, phase, key, rec):
        self.name, self.cuda, self.phase, self.key, self.rec = (
            name, cuda, phase, key, rec)

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.cuda:
            self.ev = _event_pair()
            self.ev[1].record()
        self.t0 = time.perf_counter_ns()
        if rec is not None:
            stack = rec._stack()
            self.row = SpanRecord(next(rec._ids), self.name,
                                  stack[-1].id if stack else None,
                                  threading.get_ident(), self.t0)
            stack.append(self.row)
            rec.spans.append(self.row)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.cuda:
            self.ev[2].record()
            with _LOCK:
                _PENDING.append([self.row if self.rec is not None else None,
                                 *self.ev, self.phase, self.key])
        elif self.phase is not None:
            self.phase[self.key] += (t1 - self.t0) / 1e9
        if self.rec is not None:
            self.row.end_ns = t1
            self.rec._stack().pop()
            self.rf.__exit__(*exc)
        return False


def _event_pair():
    """(device index, start, end): two timing events for the current CUDA
    device, from the pool."""
    dev = torch.cuda.current_device()
    with _LOCK:
        free = _POOL.setdefault(dev, [])
        if len(free) >= 2:
            return dev, free.pop(), free.pop()
    return (dev, torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def span(name: str, *, device=False, phase: dict | None = None,
         key: str | None = None):
    """A context manager around one step named `name`.  device=True (the
    caller's device is CUDA) times it on the card too, between events on
    the current stream.  `phase`, with `key`, gains the span's seconds,
    recording or not: the card's with device=True, else the host's."""
    rec = _REC
    if rec is None and phase is None:
        return _NULL
    return _Span(name, bool(device), phase, key, rec)


def count(name: str, n: int):
    """Add n to counter `name` of the open recording; nothing without one."""
    if _REC is not None:
        _REC.add(name, n)


def settle(wait: bool = False):
    """Read the pending event pairs whose end is complete, into their
    records and phases, and return their events to the pool.  The anchor
    stream calls it where it has just waited for the card anyway;
    wait=True waits for every pending pair first (the recording's close)."""
    if not _PENDING:
        return
    with _LOCK:
        keep = []
        for item in _PENDING:
            row, dev, e0, e1, phase, key = item
            if wait:
                e1.synchronize()
            elif not e1.query():
                keep.append(item)
                continue
            s = e0.elapsed_time(e1) / 1e3
            if row is not None:
                row.device_s = s
            if phase is not None:
                phase[key] += s
            _POOL.setdefault(dev, []).extend((e0, e1))
        _PENDING[:] = keep


@contextlib.contextmanager
def recording():
    """Open a Recording for the program's spans and counters; at its close
    every pending event pair is read."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    rec = _REC = Recording()
    try:
        yield rec
    finally:
        _REC = None
        settle(wait=True)
