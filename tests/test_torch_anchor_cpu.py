"""The port's host anchorer (native/anchor_cpu) against panagram_tpu's
CpuAnchorer and the numpy oracle, on the CPU.

Inputs come from numpy with a fixed seed; outputs are bytes and integer
popcounts, so every comparison is exact (tolerance 0).
"""

import importlib.util
import os

import numpy as np
import pytest

from panagram_tpu.native.anchor_cpu import CpuAnchorer as JaxCpuAnchorer
from panagram_tpu.ops.ref_impl import (
    anchor_np,
    build_dict_np,
    genome_kmer_set,
    masks_to_bytes_np,
    popcount_np,
)
from panagram_tpu_torch import _build
from panagram_tpu_torch.io.fasta import seq_to_codes
from panagram_tpu_torch.native import anchor_cpu
from panagram_tpu_torch.native.anchor_cpu import CpuAnchorer
from tests.conftest import random_seq

K = 21


def _case(seed, N, length=3000):
    rng = np.random.default_rng(seed)
    seqs = [random_seq(rng, length, n_frac=0.01) for _ in range(N)]
    keys, masks = build_dict_np([genome_kmer_set([s], K) for s in seqs])
    # a query with N runs: its windows over them must come out as zeros
    query = seqs[0][:1000] + "N" * 40 + seqs[N // 2][500:2000] \
        + random_seq(rng, 300, n_frac=0.1)
    return keys, masks, seq_to_codes(query)


@pytest.mark.parametrize("N", [34, 97, 256])
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_cpu_anchorer_matches_jax_and_the_oracle(N, threads):
    """34 genomes (W=2) up to 256 (W=8), each byte width up to 4W."""
    keys, masks, codes = _case(N, N)
    W = masks.shape[1]
    ca, ja = CpuAnchorer(keys, masks), JaxCpuAnchorer(keys, masks)
    assert ca.nwords == W == (N + 31) // 32
    want = anchor_np(codes, K, keys, masks)
    for nbytes in sorted({(N + 7) // 8, 4 * W}):
        by, popc = ca.anchor(codes, K, nbytes, threads=threads)
        jby, jpopc = ja.anchor(codes, K, nbytes, threads=threads)
        assert by.dtype == np.uint8 and popc.dtype == np.int32
        assert np.array_equal(by, jby) and np.array_equal(popc, jpopc)
        assert np.array_equal(by, masks_to_bytes_np(want, nbytes))
        assert np.array_equal(popc, popcount_np(want))
    assert (popc == 0).sum() >= 40 + K - 1      # the N run's windows


def test_cpu_anchorer_writes_into_out_buffers_and_checks_them():
    keys, masks, codes = _case(1, 34)
    ca = CpuAnchorer(keys, masks)
    P, nbytes = len(codes) - K + 1, 5
    out = (np.full((P, nbytes), 7, np.uint8), np.full(P, -9, np.int32))
    by, popc = ca.anchor(codes, K, nbytes, threads=3, out=out)
    assert by is out[0] and popc is out[1]
    want_b, want_p = JaxCpuAnchorer(keys, masks).anchor(codes, K, nbytes)
    assert np.array_equal(by, want_b) and np.array_equal(popc, want_p)
    for bad in ((np.empty((P, nbytes + 1), np.uint8), out[1]),
                (out[0], np.empty(P, np.int64)),
                (np.empty((nbytes, P), np.uint8).T, out[1])):
        with pytest.raises(ValueError, match="out= wants"):
            ca.anchor(codes, K, nbytes, out=bad)
    for k, nb in ((0, 5), (33, 5), (K, 33)):
        with pytest.raises(ValueError, match=f"k={k}, nbytes={nb}"):
            ca.anchor(codes, k, nb)


def test_cpu_anchorer_defaults_to_every_core(monkeypatch):
    """threads=None runs os.cpu_count() workers; a short sequence gives
    empty outputs."""
    keys, masks, codes = _case(2, 5)
    seen = []
    real = anchor_cpu._lib.acpu_anchor

    class Spy:
        def __call__(self, *args):
            seen.append(args[-1])
            return real(*args)

    monkeypatch.setattr(anchor_cpu._lib, "acpu_anchor", Spy())
    ca = CpuAnchorer(keys, masks)
    by, popc = ca.anchor(codes, K, 1)
    assert seen == [os.cpu_count() or 1]
    assert np.array_equal(by, masks_to_bytes_np(
        anchor_np(codes, K, keys, masks), 1))
    by, popc = ca.anchor(codes[:K - 1], K, 1)
    assert by.shape == (0, 1) and popc.shape == (0,) and seen == [seen[0]]


def test_cpu_anchorer_refuses_more_than_eight_words():
    with pytest.raises(ValueError, match="up to 256 genomes"):
        CpuAnchorer(np.arange(4, dtype=np.uint64), np.zeros((4, 9), np.uint32))


def test_library_is_built_in_the_ports_build_dir():
    """Built from native/anchor_cpu.cpp into panagram_tpu_torch/_built/,
    not panagram_tpu/native/."""
    assert anchor_cpu.LIB_PATH == os.path.join(_build.BUILD_DIR,
                                               "libanchor_cpu.so")
    assert os.path.dirname(anchor_cpu.SOURCE).endswith(
        os.path.join("panagram_tpu_torch", "native"))
    assert os.path.isfile(anchor_cpu.LIB_PATH)
    assert "panagram_tpu" + os.sep + "native" not in anchor_cpu.LIB_PATH


def test_import_raises_naming_why_without_a_compiler(monkeypatch):
    """No fallback: when the library cannot be built, the import raises
    OSError with the reason the build failed."""
    def no_gxx(*args, **kwargs):
        raise RuntimeError("no host C++ compiler: g++ is not on PATH")

    monkeypatch.setattr(_build, "build_host_library", no_gxx)
    spec = importlib.util.spec_from_file_location(
        "panagram_tpu_torch.native._anchor_cpu_again", anchor_cpu.__file__)
    with pytest.raises(OSError, match="g\\+\\+ is not on PATH"):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
