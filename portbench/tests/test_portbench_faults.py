"""The comparison refuses a broken timed path and the control.

Each fault is planted in the program underneath a whole run at a tiny size
(the run skips the harness's look for a card): a step that returns its
state unchanged, half of the batch left out, an answer altered where it is
produced.  One card, so no exchange between cards to leave out.  The
control (portbench/control.py) puts the reference in the program's place
with forward k-mers only."""

import numpy as np
import pytest
import torch

from portbench import control
from portbench.tests.tiny import CELLS, run_tiny

ANCHOR = [c for c in CELLS if ".anchor_" in c]
BUILD = [c for c in CELLS if c.endswith(".build")]


def stale(real):
    """The first call's outputs, ever after."""
    first = []

    def f(*a, **kw):
        out = real(*a, **kw)
        if not first:
            first.append(tuple(x.clone() if hasattr(x, "clone") else x
                               for x in out))
        return tuple(x.clone() if hasattr(x, "clone") else x
                     for x in first[0])
    return f


def half_chunk(real):
    """Bytes and popcounts of the chunk's second half left out."""
    def f(*a, **kw):
        by, popc, cs = real(*a, **kw)
        h = by.shape[0] // 2
        by[h:] = 0
        popc[h:] = 0
        return by, popc, cs
    return f


def altered_chunk(real):
    """Genome 0's bit flipped in every 16th position, as produced (bytes,
    popcount and column sum agree with each other)."""
    def f(*a, **kw):
        by, popc, cs = real(*a, **kw)
        old = (by[::16, 0] & 1).to(torch.int32)
        by[::16, 0] ^= 1
        popc[::16] += 1 - 2 * old
        cs[0] += int((1 - 2 * old).sum())
        return by, popc, cs
    return f


@pytest.mark.parametrize("fault", [stale, half_chunk, altered_chunk])
@pytest.mark.parametrize("name", ANCHOR)
def test_anchor_fault_is_refused(name, fault, monkeypatch):
    from panagram_tpu_torch.ops import anchor

    monkeypatch.setattr(anchor, "_anchor_chunk_padded",
                        fault(anchor._anchor_chunk_padded))
    r = run_tiny(name, torch.device("cpu"))
    assert not r["correct"] and r["failed"] > 0


def stale_dict(real):
    first = []

    def f(*a, **kw):
        if not first:
            first.append(real(*a, **kw))
        return first[0]
    return f


def half_dict(real):
    """Half of the genomes' sets left out of the merge."""
    def f(sets, *a, **kw):
        h = len(sets) // 2
        return real(list(sets[:h]) + [np.zeros(0, np.uint64)] * (len(sets) - h),
                    *a, **kw)
    return f


def altered_dict(real):
    def f(*a, **kw):
        pan = real(*a, **kw)
        pan.masks[len(pan.masks) // 2, 0] ^= 1
        return pan
    return f


@pytest.mark.parametrize("fault", [stale_dict, half_dict, altered_dict])
@pytest.mark.parametrize("name", BUILD)
def test_build_fault_is_refused(name, fault, monkeypatch):
    from panagram_tpu_torch.ops import dictionary

    monkeypatch.setattr(dictionary, "build_dictionary",
                        fault(dictionary.build_dictionary))
    r = run_tiny(name, torch.device("cpu"))
    assert not r["correct"] and r["failed"] > 0


def test_layout_fault_is_refused(monkeypatch):
    """A table that lost a key: the probe of every key finds it missing."""
    from panagram_tpu_torch.ops import lookup

    real = lookup.BucketedDict.build_device.__func__

    def broken(cls, keys, masks, *a, **kw):
        bd = real(cls, keys, masks, *a, **kw)
        t = bd.table.view(-1)
        t[:] = torch.where(torch.arange(t.numel()) == 0, -1, t)
        return bd
    monkeypatch.setattr(lookup.BucketedDict, "build_device",
                        classmethod(broken))
    r = run_tiny(BUILD[0], torch.device("cpu"))
    assert not r["correct"] and r["checks"]["bad_table"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused(name):
    r = run_tiny(name, torch.device("cpu"), system=control.control)
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert run_tiny(name, torch.device("cpu"))["correct"]
