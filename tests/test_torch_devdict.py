"""The port's device-resident dictionary builder against panagram_tpu's, on
the CPU.

panagram_tpu_torch.ops.devdict runs with device="cpu" (pack_mix's plain
torch version); panagram_tpu.ops.devdict runs on the CPU backend.  Inputs
come from numpy with a fixed seed, and keys and masks are integer, so
every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panagram_tpu.io.fasta import seq_to_codes
from panagram_tpu.ops import devdict as jdd
from panagram_tpu.ops.codec import pack_bases_np
from panagram_tpu.ops.lookup import mix64_np
from panagram_tpu.ops.ref_impl import build_dict_np, genome_kmer_set
from panagram_tpu_torch.ops import devdict, kernels, lookup
from panagram_tpu_torch.ops.codec import from_u64_np, u64_np
from tests.conftest import random_seq

torch.set_num_threads(2)

K = 13
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _sorted_padded(rng, n, pad):
    """n distinct random u64 keys in unsigned order plus pad SENTINELs."""
    keys = np.unique(rng.integers(0, 1 << 64, n, dtype=np.uint64))
    return np.concatenate([keys, np.full(pad, SENT, np.uint64)])


def test_chunk_mixed_distinct_matches_jax(rng):
    codes = seq_to_codes(random_seq(rng, 3000, n_frac=0.02) + "ACGT" * 200)
    packed, nmask, L = pack_bases_np(codes)
    want = np.asarray(jdd._chunk_mixed_distinct(jnp.asarray(packed),
                                                jnp.asarray(nmask), (L, K)))
    got = devdict._chunk_mixed_distinct(torch.from_numpy(packed),
                                        torch.from_numpy(nmask), L, K)
    assert len(want) == L - K + 1 and (want == SENT).any()
    assert np.array_equal(u64_np(got), want)


def test_union_sorted_matches_jax(rng):
    a = _sorted_padded(rng, 900, 124)
    b = np.concatenate([a[:300], _sorted_padded(rng, 500, 224)])
    b = np.sort(np.unique(b))
    b = np.concatenate([b, np.full(1024 - len(b), SENT, np.uint64)])
    want = np.asarray(jdd._union_sorted(jnp.asarray(a), jnp.asarray(b)))
    got = devdict._union_sorted(from_u64_np(a, "cpu"), from_u64_np(b, "cpu"))
    assert np.array_equal(u64_np(got), want)


@pytest.mark.parametrize("gid,nwords", [(0, 1), (31, 1), (37, 2), (95, 3)])
def test_merge_into_matches_jax(rng, gid, nwords):
    keys = _sorted_padded(rng, 1500, 0)
    live = len(keys)
    keys = np.concatenate([keys, np.full(4096 - live, SENT, np.uint64)])
    masks = np.zeros((4096, nwords), np.uint32)
    masks[:live] = rng.integers(1, 1 << 32, (live, nwords), dtype=np.uint64)
    new = np.unique(np.concatenate([rng.choice(keys[:live], 400),
                                    rng.integers(0, 1 << 64, 600,
                                                 dtype=np.uint64)]))
    new = np.concatenate([new, np.full(1024 - len(new), SENT, np.uint64)])
    wk, wm, wc = jdd._merge_into(jnp.asarray(keys), jnp.asarray(masks),
                                 jnp.asarray(new), nwords, jnp.int32(gid))
    gk, gm, gc = devdict._merge_into(
        from_u64_np(keys, "cpu"),
        torch.from_numpy(masks.view(np.int32)), from_u64_np(new, "cpu"),
        nwords, gid)
    assert int(gc) == int(wc) > live
    assert np.array_equal(u64_np(gk), np.asarray(wk))
    assert np.array_equal(gm.numpy().view(np.uint32), np.asarray(wm))


def _oracle(sets):
    """The numpy dictionary in mixed space: keys in unsigned order."""
    keys, masks = build_dict_np(sets)
    mixed = mix64_np(keys)
    order = np.argsort(mixed)
    return mixed[order], masks[order]


@pytest.mark.parametrize("length,chunk", [(1200, 333), (4000, 256)])
def test_device_dict_to_host_matches_jax(rng, length, chunk):
    """A small chunk makes every genome several chunks; 4000 bp at 256
    positions is ~16 chunks, so a genome flushes twice mid-sequence."""
    seqs = [random_seq(rng, length, n_frac=0.01) for _ in range(5)]
    want_keys, want_masks = _oracle([genome_kmer_set([s], K) for s in seqs])

    jb = jdd.DeviceDictBuilder(K, 5, chunk=chunk)
    b = devdict.DeviceDictBuilder(K, 5, chunk=chunk, device="cpu")
    for gid, s in enumerate(seqs):
        jb.add_sequence(gid, seq_to_codes(s))
        b.add_sequence(gid, seq_to_codes(s))
    jd, d = jb.to_host(), b.to_host()
    assert b.walls["flushes"] == jb.walls["flushes"] >= 5
    assert d.key_space == jd.key_space == "mixed"
    assert np.array_equal(d.keys, jd.keys)
    assert np.array_equal(d.masks, jd.masks)
    assert np.array_equal(d.keys, want_keys)
    assert np.array_equal(d.masks, want_masks)
    assert all(v == 0 for v in kernels.launches.values())  # CPU: plain


def test_device_dict_bucketed_matches_jax(rng):
    seqs = [random_seq(rng, 1500, n_frac=0.01) for _ in range(3)]
    jb = jdd.DeviceDictBuilder(K, 40, chunk=512, capacity_hint=1 << 12)
    b = devdict.DeviceDictBuilder(K, 40, chunk=512, capacity_hint=1 << 12,
                                  device="cpu")
    for gid, s in zip((0, 17, 39), seqs):
        jb.add_genome(gid, [seq_to_codes(s)])
        b.add_genome(gid, [seq_to_codes(s)])
    jbd, bd = jb.bucketed(), b.bucketed()
    assert b.keys.shape[0] >= 1 << 12 > b.count
    assert (bd.nbits, bd.cap, bd.stride, bd.nwords) == \
        (jbd.nbits, jbd.cap, jbd.stride, jbd.nwords) and bd.nwords == 2
    want = lookup.BucketedDict.from_jax_state(
        np.asarray(jbd.table), jbd.nbits, jbd.cap, jbd.stride, 40, K, 2).table
    assert np.array_equal(bd.table.numpy().view(np.uint32), want)
