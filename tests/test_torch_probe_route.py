"""The merge probe's default route, the dictionary merge with narrow genome
ids, and scipy's import before the first stage timer, on the CPU.

The Pallas probe runs in interpret mode (panagram_tpu's
bucket_query_sorted); the port's wrappers, given CPU tensors, run their
plain versions.  Inputs come from numpy with a fixed seed; everything is
integer, so every comparison is exact (tolerance 0).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panagram_tpu.ops import lookup as jl
from panagram_tpu.ops.dictionary import build_dictionary as jax_build_dictionary
from panagram_tpu_torch.ops import dictionary, kernels, lookup
from panagram_tpu_torch.ops.codec import SENTINEL, from_u64_np, split64

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U64 = np.uint64
ONES = U64(0xFFFFFFFFFFFFFFFF)
TILE = lookup.TILE_Q


@pytest.fixture(scope="module")
def tables():
    """One 30-genome dictionary as panagram_tpu's device table and as the
    port's, with its keys."""
    rng = np.random.default_rng(42)
    keys = np.unique(rng.integers(0, 1 << 62, 8000, dtype=U64))
    masks = rng.integers(1, 1 << 31, (len(keys), 1)).astype(np.uint32)
    jbd = jl.BucketedDict.build(keys, masks, 30, 21)
    (jt,) = jbd.device_arrays()
    bd = lookup.BucketedDict.from_jax_state(
        np.asarray(jt), jbd.nbits, jbd.cap, jbd.stride, 30, 21, 1).to("cpu")
    assert (1 << bd.nbits) > 8
    return keys, jbd, jt, bd


def _skewed_queries(case: str, keys, nbits: int, rng) -> np.ndarray:
    """Mixed u64 queries, a multiple of TILE of them, all-ones = padding."""
    hits = lookup.mix64_np(keys[:1500])
    misses = rng.integers(0, 1 << 64, 500, dtype=U64)
    if case == "n_windows":
        # a gappy assembly: most windows hold an N, and all of those are
        # the one mixed value of the SENTINEL
        gap = np.full(3 * TILE - 2000, lookup.mix64_np(np.array([ONES]))[0])
        m = np.concatenate([hits, gap, misses])
    elif case == "one_bucket":
        # most queries in the bucket of one key: the same top nbits, the
        # rest random, and that bucket's own keys among them
        top = hits[0] >> U64(64 - nbits) << U64(64 - nbits)
        crowd = top | (rng.integers(0, 1 << 64, 2 * TILE, dtype=U64)
                       >> U64(nbits))
        m = np.concatenate([hits, crowd, misses])
        m = np.concatenate([m, np.full(-len(m) % TILE, ONES)])
    elif case == "padding_tiles":
        # 100 real queries and nearly four tiles of padding
        m = np.concatenate([hits[:80], misses[:20],
                            np.full(4 * TILE - 100, ONES)])
    else:
        raise KeyError(case)
    assert len(m) % TILE == 0
    return rng.permutation(m)


@pytest.mark.parametrize("case", ["n_windows", "one_bucket", "padding_tiles"])
def test_default_route_equals_gather_and_pallas_under_skew(tables, case,
                                                           monkeypatch):
    """Row for row the default route equals the gather probe and
    panagram_tpu's Pallas merge probe, and it reads nothing back: no
    nonzero, no item, no int() or bool() of a tensor."""
    keys, jbd, jt, bd = tables
    rng = np.random.default_rng(len(case))
    m = _skewed_queries(case, keys, bd.nbits, rng)
    want = np.asarray(jl.bucket_query_sorted(
        jnp.asarray(m), jt, jbd.nbits, jbd.cap, jbd.nwords, pre_mixed=True))
    assert want.any()
    hi, lo = split64(from_u64_np(m, "cpu"))
    gather = lookup.bucket_query_pairs(hi, lo, bd.table, bd.nbits, bd.cap,
                                       bd.nwords)
    assert np.array_equal(gather.numpy().view(np.uint32), want)

    reads = {"n": 0}

    def counted(real):
        def f(*a, **k):
            reads["n"] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(torch, "nonzero", counted(torch.nonzero))
    for name in ("nonzero", "item", "tolist", "__int__", "__bool__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name,
                            counted(getattr(torch.Tensor, name)))
    got = lookup.bucket_query_sorted_pre(hi, lo, None, bd.table, bd.nbits,
                                         bd.cap, bd.nwords, len(m))
    assert reads["n"] == 0
    # the patch counts: an explicit window does read back
    narrow = lookup.bucket_query_sorted_pre(hi, lo, None, bd.table, bd.nbits,
                                            bd.cap, bd.nwords, len(m), span=8)
    assert reads["n"] > 0
    monkeypatch.undo()
    assert torch.equal(got, gather) and torch.equal(narrow, gather)
    plan = lookup.plan_probe(hi, lo, bd.nbits)
    assert plan.span == 1 << bd.nbits and not bool(plan.blo.any())
    assert not bool(plan.out_span.any())


@pytest.mark.parametrize("nbits", [31, 32])
def test_probe_sorted_takes_a_whole_table_window_at_31_and_32_bits(nbits):
    """span = 2^nbits passes the wrapper's argument check at the widest
    tables (a 32-bit count would not hold 2^32); one row more does not.
    The tensors are on the meta device, which has neither kernel nor plain
    version, so a call that passes the check ends there."""
    B = 1 << nbits
    q = torch.zeros(TILE, dtype=torch.int32, device="meta")
    blo = torch.zeros(1, dtype=torch.int32, device="meta")
    table = torch.empty(B, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.probe_sorted(q, q, blo, table, nbits, 2, 1, B, TILE)
    with pytest.raises(ValueError, match="probe_sorted: nbits="):
        kernels.probe_sorted(q, q, blo, table, nbits, 2, 1, B + 1, TILE)
    assert kernels._SIGNATURES["pg_probe_sorted"][9] is kernels._I64


# --------------------------------------------------------------------------
# the dictionary merge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ngenomes", [3, 34, 40, 100])
def test_merge_with_narrow_ids_matches_jax(ngenomes):
    """build_dictionary (int32 genome ids, int32 mask words added by
    index_add_) against panagram_tpu's, with the largest canonical key
    (2^62 - 1) and key 0 shared by the first, the 32nd and the last genome
    (bit 31 of a word is the sign bit of the int32 that carries it)."""
    rng = np.random.default_rng(ngenomes)
    pool = np.unique(rng.integers(0, 1 << 62, 3000, dtype=U64))
    edge = np.array([0, (1 << 62) - 1], U64)
    sets = []
    for g in range(ngenomes):
        s = pool[rng.random(len(pool)) < 0.4]
        if g in (0, 31, ngenomes - 1):
            s = np.union1d(s, edge)
        sets.append(s)
    sets[1] = np.zeros(0, U64)
    want = jax_build_dictionary(sets, 31, ngenomes=ngenomes)
    got = dictionary.build_dictionary(sets, 31, ngenomes=ngenomes,
                                      device="cpu")
    assert got.keys.dtype == np.uint64 and got.masks.dtype == np.uint32
    assert got.masks.shape == (len(want.keys), (ngenomes + 31) // 32)
    assert got.masks.flags.c_contiguous
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.masks, want.masks)
    assert got.keys[-1] == (1 << 62) - 1 and got.keys[0] == 0


def test_merge_sets_orders_any_u64_and_consumes_its_inputs():
    """Mixed keys span the whole u64 range and may hold the SENTINEL: the
    merge orders them unsigned (SENTINEL last) and empties the list it is
    given, so that the caller holds no second reference."""
    rng = np.random.default_rng(9)
    W = 2
    base = np.concatenate([rng.integers(0, 1 << 64, 500, dtype=U64),
                           np.array([0, 1 << 63, (1 << 63) - 1, ONES], U64)])
    keys = np.concatenate([base[rng.random(len(base)) < 0.5]
                           for _ in range(40)] + [np.array([ONES], U64)])
    gids = np.concatenate([np.full(n, g, np.int32) for g, n in enumerate(
        np.diff(np.r_[0, np.cumsum([len(keys) // 41] * 40), len(keys)]))])
    # a (key, genome) pair occurs once: drop repeats
    _, first = np.unique(np.stack([keys, gids.astype(U64)]), axis=1,
                         return_index=True)
    keys, gids = keys[np.sort(first)], gids[np.sort(first)]
    want_keys = np.unique(keys)
    want = np.zeros((len(want_keys), W), np.uint32)
    row = np.searchsorted(want_keys, keys)
    np.bitwise_or.at(want, (row, gids // 32),
                     (np.uint32(1) << (gids % 32).astype(np.uint32)))

    pairs = [from_u64_np(keys, "cpu"), torch.from_numpy(gids.copy())]
    out_keys, masks = dictionary._merge_sets(pairs, W)
    assert pairs == []
    assert masks.dtype == torch.int32 and out_keys.dtype == torch.int64
    assert int(out_keys[-1]) == SENTINEL
    assert np.array_equal(out_keys.numpy().view(U64), want_keys)
    assert np.array_equal(masks.numpy().view(np.uint32), want)


# --------------------------------------------------------------------------
# scipy's import
# --------------------------------------------------------------------------

_PRELOAD_SCRIPT = r"""
import sys
import panagram_tpu_torch
import panagram_tpu_torch.pipeline
assert not [m for m in sys.modules if m.split(".")[0] == "scipy"], "at import"
from panagram_tpu_torch import index
from panagram_tpu_torch.pipeline import build_index

seen = []
real = index.Genome.run_anchor

def run_anchor(self, *a, **k):
    seen.append(("scipy.linalg" in sys.modules, "scipy.spatial" in sys.modules))
    return real(self, *a, **k)

index.Genome.run_anchor = run_anchor
work = sys.argv[1]
import numpy as np
rng = np.random.default_rng(0)
rows = []
for g in range(2):
    seq = "".join(rng.choice(list("ACGT"), 3000))
    open(f"{work}/g{g}.fa", "w").write(f">chr1\n{seq}\n")
    rows.append(f"g{g}\t{work}/g{g}.fa\n")
open(f"{work}/samples.tsv", "w").write("name\tfasta\n" + "".join(rows))
build_index(f"{work}/samples.tsv", prefix=f"{work}/idx", k=15, device="cpu",
            anchor_genomes=["g0"])
assert seen == [(True, True)], seen
build_index(f"{work}/samples.tsv", prefix=f"{work}/idx_none", k=15,
            device="cpu", anchor_genomes=[])
print("ok")
"""


def test_scipy_loads_before_the_first_anchor_stage_not_at_import(tmp_path):
    """In a fresh interpreter: importing the package and its pipeline loads
    no scipy module; when the first run_anchor of a build_index is entered,
    scipy.linalg and scipy.spatial are loaded already."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _PRELOAD_SCRIPT, str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
