"""ops.count's spill readback: the page-locked landing on a CUDA device,
its fallback, and the CPU path it leaves as it was.

CPU tests; the card's cases are in tests/test_torch_gpu.py.  This module
imports no jax.
"""

import numpy as np
import pytest
import torch

from panagram_tpu_torch import spans
from panagram_tpu_torch.ops import count

K = 21


def _codes(n, seed=3):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _refuse(shape, dtype):
    raise RuntimeError("no page-locked memory")


def _plain(shape, dtype):
    """A stand-in for a page-locked block where there is no CUDA."""
    return torch.empty(shape, dtype=dtype)


@pytest.mark.parametrize("fn", ["distinct", "counted"])
def test_cpu_path_lands_nothing_page_locked(fn):
    """On the CPU device no spill is counted as page-locked, and the result
    is a writeable uint64 array."""
    codes = _codes(5000)
    with spans.recording() as rec:
        if fn == "distinct":
            got = count.distinct_kmers_chunked([codes], K, 1024, device="cpu")
        else:
            got = count.counted_kmers_chunked([codes, codes], K, 2, 1024,
                                              device="cpu")
    tot = rec.totals()
    assert "count.readback.pinned" not in tot["counters"]
    assert tot["spans"]["count.readback"]["count"] >= 1
    assert got.dtype == np.uint64 and got.flags.writeable and len(got)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_readback_falls_back_when_no_page_locked_block(monkeypatch, dtype):
    """A refused page-locked allocation lands the copy pageable: the same
    array, writeable, and no count.readback.pinned."""
    monkeypatch.setattr(count, "_pinned_empty", _refuse)
    x = torch.arange(-5, 1000, 7, dtype=dtype)
    with spans.recording() as rec:
        got, same = count._readback([x, x], True)
    assert rec.totals()["counters"] == {}
    assert got.dtype == x.numpy().dtype and got.flags.writeable
    assert np.array_equal(got, x.numpy()) and np.array_equal(same, got)


def test_readback_without_an_accelerator_falls_back():
    """Where torch has no pinned allocator, asking for page-locked memory
    raises RuntimeError, and the readback lands pageable instead."""
    if torch.cuda.is_available():
        pytest.skip("torch here has a pinned allocator")
    x = torch.arange(64, dtype=torch.int64)
    with spans.recording() as rec:
        (got,) = count._readback([x], True)
    assert rec.totals()["counters"] == {}
    assert np.array_equal(got, np.arange(64))


def test_readback_lands_in_its_own_block(monkeypatch):
    """The landing path copies into the block it was given, counts one
    count.readback.pinned a spill, and the array keeps its block alive: a
    second readback of the same size leaves the first array as it was."""
    monkeypatch.setattr(count, "_pinned_empty", _plain)
    a = torch.arange(1000, dtype=torch.int64) * 3
    b = -torch.arange(1000, dtype=torch.int64)
    with spans.recording() as rec:
        (first,) = count._readback([a], True)
        second, counts = count._readback([b, a[:10]], True)
    assert rec.totals()["counters"] == {"count.readback.pinned": 2}
    assert isinstance(first.base, torch.Tensor)
    assert np.array_equal(counts, np.arange(10) * 3)
    assert first.flags.writeable and first.dtype == np.int64
    assert not np.shares_memory(first, a.numpy())
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, np.arange(1000) * 3)
    assert np.array_equal(second, -np.arange(1000))


@pytest.mark.parametrize("chunks", [3, 13])
def test_landing_path_keeps_the_sets(monkeypatch, chunks):
    """Both counting functions return the same arrays through the landing
    path (one spill and several) as through the CPU's view, with one
    count.readback.pinned per count.readback."""
    chunk = 512
    codes = _codes(chunks * chunk + K - 1, seed=chunks)
    reads = [codes[s:s + 150] for s in range(0, len(codes) - 150, 75)]
    want = (count.distinct_kmers_chunked([codes], K, chunk, device="cpu"),
            count.counted_kmers_chunked(reads, K, 2, chunk, device="cpu"))

    real = count._readback
    monkeypatch.setattr(count, "_pinned_empty", _plain)
    monkeypatch.setattr(count, "_readback", lambda xs, pinned: real(xs, True))
    with spans.recording() as rec:
        got = (count.distinct_kmers_chunked([codes], K, chunk, device="cpu"),
               count.counted_kmers_chunked(reads, K, 2, chunk, device="cpu"))
    tot = rec.totals()
    for g, w in zip(got, want):
        assert g.dtype == np.uint64 and g.flags.writeable
        assert np.array_equal(g, w) and len(w)
    spills = tot["spans"]["count.readback"]["count"]
    # the distinct count's spills and at least one of the counted count's
    assert spills >= -(-chunks // count.SPILL_CHUNKS) + 1
    assert tot["counters"]["count.readback.pinned"] == spills
