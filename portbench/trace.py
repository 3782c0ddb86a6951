"""The traced run's device timeline: torch.profiler over the window, reduced
to what the per-layer metrics and the breakdown read.

The profiler records the host's operators, the harness's own labels
(``record_function``) and, on a CUDA device, every kernel, copy and
memset with its start and end.  ``Trace.reduce`` exports the chrome
trace to the temporary directory, reads it back and deletes it, and keeps
only the window's part: the window is the span of the harness's
``portbench.window`` label.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

WINDOW_LABEL = "portbench.window"
# chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# labels that the harness sets around its own steps
HOST_CATS = ("user_annotation", "cpu_op")
NAME_CHARS = 100
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    """The traced window, all times in seconds."""

    window_s: float          # the window's length on the trace's clock
    busy_s: float            # union of device intervals (kernels, copies, memsets)
    kernel_s: float          # sum of kernel and memset durations (copies apart)
    device_ops: list         # [name, seconds] of the device ops that took most
    idle_gaps: list          # [host label, seconds] of the longest device gaps


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _label(host, starts, longest: float, t: float) -> str:
    """The harness's innermost label and the innermost host operator that
    cover time t: 'label > op', or 'label > host' where no operator runs
    (Python and numpy work).  `host` is sorted by start, `starts` its
    starts, `longest` its longest duration."""
    lab, op = None, None
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        ev = host[i]
        if ev["ts"] < t - longest:
            break
        if ev["ts"] + ev["dur"] < t:
            continue
        if ev["cat"] == "user_annotation":
            lab = lab or ev
        else:
            op = op or ev
    name = lab["name"] if lab else "outside labels"
    return f"{name} > {op['name'] if op else 'host'}"[:NAME_CHARS]


def reduce_events(events: list) -> TraceSummary | None:
    """The TraceSummary of chrome-trace events, None where the window's
    label is missing."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_LABEL]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= w0 or s >= w1:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((e["cat"], e["name"], max(s, w0), min(s + d, w1)))
        elif e.get("cat") in HOST_CATS and e["name"] != WINDOW_LABEL:
            host.append({"cat": e["cat"], "name": e["name"], "ts": s,
                         "dur": d})
    busy, merged = _union([(s, t) for _c, _n, s, t in dev])
    kernel = sum(t - s for c, _n, s, t in dev if c != "gpu_memcpy")
    by_name: dict = {}
    for _c, n, s, t in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    host.sort(key=lambda ev: ev["ts"])
    starts = [ev["ts"] for ev in host]
    longest = max((ev["dur"] for ev in host), default=0.0)
    idle = [[_label(host, starts, longest, g0 + g / 2), g / 1e6]
            for g, g0 in gaps]
    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, kernel_s=kernel / 1e6,
        device_ops=[[n[:NAME_CHARS], v / 1e6] for n, v in ops],
        idle_gaps=idle)


class Trace:
    """torch.profiler around the window; `mark(name)` labels a step."""

    def __init__(self, device):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._record = torch.profiler.record_function

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def mark(self, name: str):
        return self._record(name)

    def reduce(self) -> TraceSummary | None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return reduce_events(events)


def no_mark(_name: str):
    """The untraced run's label: nothing."""
    return contextlib.nullcontext()
