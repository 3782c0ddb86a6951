"""The port's device bucket layout against panagram_tpu's, on the CPU.

BucketedDict.build_device, layout_rows and the chunked layout of
panagram_tpu_torch.ops.lookup run with device="cpu"; panagram_tpu's run on
the CPU backend, and its packed-row tables convert through
BucketedDict.from_jax_state.  Inputs come from numpy with a fixed seed, and
tables are integer, so every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panagram_tpu.ops import lookup as jl
from panagram_tpu_torch.ops import lookup
from panagram_tpu_torch.ops.codec import from_u64_np

torch.set_num_threads(2)

K = 21
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _dict(rng, n, ngenomes):
    """n distinct canonical keys (< 2^62) and random masks over ngenomes
    bits."""
    keys = np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))
    W = (ngenomes + 31) // 32
    masks = rng.integers(1, 1 << 32, (len(keys), W), dtype=np.uint64)
    masks[:, -1] &= np.uint64((1 << (ngenomes - 32 * (W - 1))) - 1)
    masks[:, -1] |= np.uint64(1)
    return keys, masks.astype(np.uint32)


def _mixed_padded(keys, masks):
    """Keys mixed and sorted in unsigned order, then SENTINEL-padded to the
    next power of two (the device dictionary builder's arrays)."""
    m = jl.mix64_np(keys)
    order = np.argsort(m)
    D, W = masks.shape
    P = 1 << int(np.ceil(np.log2(D + 1)))
    mp = np.full(P, SENT, np.uint64)
    mp[:D] = m[order]
    maskp = np.zeros((P, W), np.uint32)
    maskp[:D] = masks[order]
    return mp, maskp


def _port_table(bd) -> np.ndarray:
    return bd.table.numpy().view(np.uint32)


def _jax_table(jbd) -> np.ndarray:
    return lookup.BucketedDict.from_jax_state(
        np.asarray(jbd.table), jbd.nbits, jbd.cap, jbd.stride, jbd.ngenomes,
        jbd.k, jbd.nwords).table


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("ngenomes", [30, 100])
@pytest.mark.parametrize("space", ["canonical", "mixed_sorted"])
def test_build_device_matches_jax(rng, ngenomes, space):
    keys, masks = _dict(rng, 3000, ngenomes)
    if space == "canonical":
        args = dict(mixed=False)
        jbd = jl.BucketedDict.build_device(keys, masks, ngenomes, K)
        kin, min_ = keys, masks
    else:
        kin, min_ = _mixed_padded(keys, masks)
        args = dict(mixed=True, count=len(keys), sorted_input=True)
        jbd = jl.BucketedDict.build_device(kin, min_, ngenomes, K, **args)
    bd = lookup.BucketedDict.build_device(kin, min_, ngenomes, K,
                                          device="cpu", **args)
    assert (bd.nbits, bd.cap, bd.stride, bd.nwords) == \
        (jbd.nbits, jbd.cap, jbd.stride, jbd.nwords)
    assert bd.table.dtype == torch.int32
    assert bd.table.shape == (1 << bd.nbits, bd.stride)
    assert np.array_equal(_port_table(bd), _jax_table(jbd))
    # tensors in, as the device dictionary builder passes them
    again = lookup.BucketedDict.build_device(
        from_u64_np(kin, "cpu"), _i32(min_), ngenomes, K, device="cpu",
        **args)
    assert torch.equal(again.table, bd.table)


def test_build_device_retries_to_jax_nbits(rng, monkeypatch):
    """A geometry with too few buckets overflows; both layouts retry with
    one more bucket bit at a time and stop at the same table."""
    keys, masks = _dict(rng, 3000, 30)

    def tight(D, W, mean_load=None):
        return 4, 21, 64

    monkeypatch.setattr(jl, "table_geometry", tight)
    monkeypatch.setattr(lookup, "table_geometry", tight)
    jbd = jl.BucketedDict.build_device(keys, masks, 30, K)
    bd = lookup.BucketedDict.build_device(keys, masks, 30, K, device="cpu")
    assert bd.nbits == jbd.nbits > 4
    assert np.array_equal(_port_table(bd), _jax_table(jbd))


@pytest.mark.parametrize("ngenomes", [1, 100])
@pytest.mark.parametrize("pre_sorted", [True, False])
def test_layout_rows_matches_jax(rng, ngenomes, pre_sorted):
    keys, masks = _dict(rng, 3000, ngenomes)
    mp, maskp = _mixed_padded(keys, masks)
    if not pre_sorted:
        perm = rng.permutation(len(mp))
        mp, maskp = mp[perm], maskp[perm]
    W = maskp.shape[1]
    nbits, cap, stride = lookup.table_geometry(len(keys), W)
    want, wov = jl.layout_rows(jnp.asarray(mp), jnp.asarray(maskp),
                               jnp.zeros((), jnp.int32), 1 << nbits, cap,
                               stride, bucket_in_key=True,
                               pre_sorted=pre_sorted)
    got, ov = lookup.layout_rows(from_u64_np(mp, "cpu"), _i32(maskp), None,
                                 1 << nbits, cap, stride, bucket_in_key=True,
                                 pre_sorted=pre_sorted)
    assert int(ov) == int(wov) == 0
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_layout_rows_any_bucket_matches_jax(rng):
    """bucket_in_key=False: rows go to a bucket derived otherwise (here the
    low bits of the key), grouped by (bucket, key); with a small capacity
    some buckets overflow and both count the same dropped rows."""
    keys, masks = _dict(rng, 2000, 40)
    mp, maskp = _mixed_padded(keys, masks)
    perm = rng.permutation(len(mp))
    mp, maskp = mp[perm], maskp[perm]
    n_buckets, cap, stride = 256, 7, 64
    bucket = (mp & np.uint64(n_buckets - 1)).astype(np.int32)
    want, wov = jl.layout_rows(jnp.asarray(mp), jnp.asarray(maskp),
                               jnp.asarray(bucket), n_buckets, cap, stride)
    got, ov = lookup.layout_rows(from_u64_np(mp, "cpu"), _i32(maskp),
                                 torch.from_numpy(bucket), n_buckets, cap,
                                 stride)
    assert int(ov) == int(wov) > 0
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("ngenomes", [1, 100])
def test_chunked_layout_matches_single_pass_and_jax(rng, monkeypatch,
                                                    ngenomes):
    keys, masks = _dict(rng, 4000, ngenomes)
    mp, maskp = _mixed_padded(keys, masks)
    W = maskp.shape[1]
    nbits, cap, stride = lookup.table_geometry(len(keys), W)
    km, mm = from_u64_np(mp, "cpu"), _i32(maskp)
    single, ov = lookup._layout_device(km, mm, nbits, cap, stride,
                                       pre_sorted=True)
    assert lookup.chunked_layout_pieces(len(keys), nbits, 500) >= 8
    chunked, ov_c = lookup._layout_device_chunked(km, mm, nbits, cap, stride,
                                                  piece_rows=500)
    assert int(ov) == ov_c == 0
    assert torch.equal(single, chunked)
    monkeypatch.setenv("PANAGRAM_TPU_LAYOUT_PIECE_ROWS", "500")
    want, wov = jl._layout_device_chunked(jnp.asarray(mp), jnp.asarray(maskp),
                                          nbits, cap, stride, len(keys))
    assert int(wov) == 0
    assert np.array_equal(chunked.numpy().view(np.uint32),
                          np.asarray(want).reshape(-1))


def test_layout_route_by_free_memory(rng):
    """single / chunked / host / refusal under given free figures, and the
    same table from every route that lays out."""
    D, W = int(1e8), 1
    nbits, _, stride = lookup.table_geometry(D, W)
    table = (1 << nbits) * stride * 4
    fixed = table + lookup.ANCHOR_RESERVE_BYTES
    single = fixed + lookup.layout_bytes(D, W, "sorted")
    chunked = fixed + lookup.layout_bytes(D, W, "chunked")
    assert chunked < single
    route = lookup.layout_route
    assert route(D, W, "cpu", True) == "single"          # CPU: not checked
    assert route(D, W, "cpu", True, free=single) == "single"
    assert route(D, W, "cpu", True, free=single - 1) == "chunked"
    assert route(D, W, "cpu", False, free=single) == "host"
    assert route(D, W, "cpu", False,
                 free=fixed + lookup.layout_bytes(D, W, "sort")) == "single"
    assert route(D, W, "cpu", True, free=chunked - 1) == "host"
    assert route(D, W, "cpu", True, free=fixed) == "host"
    with pytest.raises(RuntimeError, match="free on cpu"):
        route(D, W, "cpu", True, free=fixed - 1)

    keys, masks = _dict(rng, 3000, 30)
    mp, maskp = _mixed_padded(keys, masks)
    nb, _, st = lookup.table_geometry(len(keys), 1)
    fixed = (1 << nb) * st * 4 + lookup.ANCHOR_RESERVE_BYTES
    tables = []
    for free, want in ((None, "single"),
                       (fixed + lookup.layout_bytes(len(keys), 1, "chunked",
                                                    piece_rows=256),
                        "chunked"),
                       (fixed, "host")):
        assert route(len(keys), 1, "cpu", True, free, piece_rows=256) == want
        bd = lookup.BucketedDict.build_device(
            mp, maskp, 30, K, mixed=True, count=len(keys),
            sorted_input=True, device="cpu", free=free, piece_rows=256)
        tables.append(bd.table)
    assert all(torch.equal(t, tables[0]) for t in tables[1:])
    with pytest.raises(RuntimeError, match="bucketed dict"):
        lookup.BucketedDict.build_device(mp, maskp, 30, K, mixed=True,
                                         count=len(keys), sorted_input=True,
                                         device="cpu", free=fixed - 1)


def test_layout_bytes_counts_the_port_transients():
    """layout_bytes counts what layout_rows, _layout_piece and _piece_bounds
    allocate (not panagram_tpu's byte model, which under-counts the port's
    single pass), as two phases: the sorts and slot computation before the
    table exists, counted beside it only where they exceed it, then the
    scatter beside it.  The per-key constants at 1e8 keys, W=1 (2^24
    buckets of 64 u32, 42.9 B/key of table) and at W=4, a table small
    enough for the sort to outgrow it, and the route boundary, where a free
    figure just under the single pass's need now takes the chunked route
    (panagram_tpu's model, (8 + 4W + 12) B/key, would have taken the single
    pass and run out)."""
    D, W = 10**8, 1
    B = 1 << 24
    small = 16 << 20    # small tensors and allocator rounding
    nbits, _, stride = lookup.table_geometry(D, W)
    assert (nbits, stride) == (24, 64)
    table = (B * stride + 3) * 4
    slots = 24 * D + 2 * 8 * (B + 1)
    assert slots < table                  # the slot computation is hidden
    assert lookup.layout_bytes(D, W, "sorted") == small + 12 * D + 20 * D
    # the sort's 48 B/key exceed the table by a little; the scatter beside
    # the table and the sorted copies weigh more
    assert 48 * D - table < 32 * D
    assert lookup.layout_bytes(D, W, "sort") == small + 12 * D + 32 * D
    assert lookup.layout_bytes(D, W, "bucket") == small + 20 * D + 32 * D
    # 8 passes of 1.25e7 rows (+1/64) over 2^21 buckets each
    n = 12_500_000 * 65 // 64
    assert lookup.layout_bytes(D, W, "chunked") == \
        small + 12 * D + 32 * n + 2 * 8 * ((1 << 21) + 1)
    # a table of 2^20 buckets: the sort before it counts, less the table
    small_table = ((1 << 20) * stride + 3) * 4
    assert lookup.layout_bytes(D, W, "sort", n_buckets=1 << 20) == \
        small + 12 * D + 48 * D - small_table
    assert lookup.layout_bytes(D, W, "bucket", n_buckets=1 << 20) == \
        small + 20 * D + 64 * D - small_table
    # a small layout still takes two passes, of half its rows (+1/64)
    assert lookup.layout_bytes(1000, W, "chunked", n_buckets=1 << 8) == \
        small + 12 * 1000 + 32 * 507 + 2 * 8 * ((1 << 7) + 1)
    Dw = 10**6
    nw, _, sw = lookup.table_geometry(Dw, 4)
    assert (nw, sw) == (18, 128)
    assert lookup.layout_bytes(Dw, 4, "sorted") == small + 24 * Dw + 20 * Dw
    assert lookup.layout_bytes(Dw, 4, "sort") == small + 24 * Dw + 44 * Dw

    fixed = B * stride * 4 + lookup.ANCHOR_RESERVE_BYTES
    need = fixed + lookup.layout_bytes(D, W, "sorted")
    route = lookup.layout_route
    assert route(D, W, "cpu", True, free=need) == "single"
    assert route(D, W, "cpu", True, free=need - 1) == "chunked"
    jax_model = fixed + (8 + 4 * W + 12) * D
    assert jax_model < need
    assert route(D, W, "cpu", True, free=jax_model) == "chunked"
