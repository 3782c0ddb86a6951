"""kernels.pack_bases, the device packing of the anchor stream: its plain
version against codec.pack_bases_np, and the stream that stages raw codes
and packs them on the device against the chunk packed on the host.

CPU tests (the kernel itself: `-m gpu` in tests/test_torch_gpu.py).  Inputs
come from numpy with a fixed seed; everything is integer, so every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from panagram_tpu_torch.ops import anchor, count, dictionary, kernels
from panagram_tpu_torch.ops.codec import pack_bases_np
from panagram_tpu_torch.ops.lookup import BucketedDict

K = 21


def _codes(rng, n):
    """Bases with N (4) and other codes >= 4 (5-255) mixed in."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    at = rng.random(n)
    codes[at < 0.1] = 4
    codes[at > 0.95] = rng.integers(5, 256, int((at > 0.95).sum()))
    return codes


def _want(codes, nvalid, L):
    """pack_bases_np of the stream's old staging buffer: the codes, 255 from
    nvalid on."""
    buf = np.full(L, 255, np.uint8)
    buf[:nvalid] = codes[:nvalid]
    packed, nmask, _ = pack_bases_np(buf)
    return np.concatenate([packed, nmask])


@pytest.mark.parametrize("L", [1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 1000,
                               4096 + 30, 4096 + 37])
@pytest.mark.parametrize("cut", ["all", "less_one", "half", "none"])
def test_pack_bases_plain_matches_pack_bases_np(L, cut):
    """Every byte of pack_bases_np's two arrays at any L, with N and other
    codes >= 4; with nvalid < L the codes past nvalid are junk (ACGT and N
    alike) and must pack as pack_bases_np packs the 255-filled buffer.
    Bytes of `out` past the two arrays stay as they were."""
    rng = np.random.default_rng(7 * L + len(cut))
    nvalid = {"all": L, "less_one": L - 1, "half": L // 2 + 1,
              "none": 0}[cut]
    nvalid = min(max(nvalid, 0), L)
    codes = _codes(rng, L)
    want = _want(codes, nvalid, L)
    out = torch.full((len(want) + 5,), 0xAB, dtype=torch.uint8)
    got = kernels.pack_bases(torch.from_numpy(codes), nvalid, L, out)
    assert got is out
    assert np.array_equal(out[:len(want)].numpy(), want)
    assert (out[len(want):] == 0xAB).all()
    if nvalid == L:
        p, n, _ = pack_bases_np(codes)
        assert np.array_equal(want, np.concatenate([p, n]))


@pytest.mark.parametrize("nvalid", [0, 9, 23])
def test_pack_bases_reads_nothing_past_nvalid(nvalid):
    """codes of only nvalid bytes (the stream uploads m + k - 1 of them)
    pack as the same codes followed by junk would, through pack_bases and
    through pack_chunk's two views."""
    rng = np.random.default_rng(nvalid)
    L = 40
    codes = _codes(rng, L)
    short = torch.from_numpy(codes[:nvalid].copy())
    out = torch.empty(10 + 5, dtype=torch.uint8)
    kernels.pack_bases(short, nvalid, L, out)
    assert np.array_equal(out.numpy(), _want(codes, nvalid, L))
    packed, nmask = kernels.pack_chunk(short, L)
    assert packed.shape == (10,) and nmask.shape == (5,)
    assert np.array_equal(torch.cat([packed, nmask]).numpy(), out.numpy())


@pytest.mark.parametrize("case", ["nvalid_past_L", "nvalid_past_codes",
                                  "negative", "out_short", "dtype",
                                  "device"])
def test_pack_bases_refuses_bad_inputs(case):
    codes = torch.zeros(16, dtype=torch.uint8)
    out = torch.zeros(6, dtype=torch.uint8)
    args = {"nvalid_past_L": (codes, 16, 15, out),
            "nvalid_past_codes": (codes[:8], 9, 16, out),
            "negative": (codes, -1, 16, out),
            "out_short": (codes, 16, 16, out[:5]),
            "dtype": (codes.to(torch.int32), 16, 16, out),
            "device": (codes.to("meta"), 16, 16, out.to("meta"))}[case]
    with pytest.raises(ValueError):
        kernels.pack_bases(*args)


def _pan(n=4, L=7000, seed=3):
    """n related genomes (2% of bases changed each, N runs in the first)
    and their bucket table on the CPU."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, L).astype(np.uint8)
    genomes = []
    for _ in range(n):
        g = base.copy()
        at = rng.choice(L, L // 50, replace=False)
        g[at] = rng.integers(0, 4, len(at)).astype(np.uint8)
        genomes.append(g)
    sets = [count.distinct_kmers_chunked([g], K, device="cpu")
            for g in genomes]
    pan = dictionary.build_dictionary(sets, K, n, device="cpu")
    bd = BucketedDict.build_device(pan.keys, pan.masks, n, K, device="cpu")
    return genomes, bd


@pytest.fixture(scope="module")
def pan():
    return _pan()


@pytest.mark.parametrize("chunk,nk", [
    (2048, 2048 + 300),          # a full chunk, then a short one
    (2048, 2 * 2048 + 77),       # two full, then a short one in slot 0
    (1000, 3 * 1000),            # full chunks only
    (4096, 1500),                # one short chunk
])
def test_stream_packs_on_the_device_as_the_host_did(pan, chunk, nk):
    """The stream's (start, m, bytes, popc, colsums) equal anchor_chunk_fast
    over each chunk packed on the host by pack_bases_np (its codes, 255
    past them), for a sequence with N runs across every chunk boundary,
    where stale codes left in a staging slot by a longer chunk would show."""
    genomes, bd = pan
    n = len(genomes)
    codes = genomes[0][:nk + K - 1].copy()
    for b in range(chunk, nk, chunk):
        codes[b - 10:b + 30] = 4
    codes[nk + K - 8:] = 255
    L = chunk + K - 1
    got = [(s, m, by.copy(), p.copy(), c.copy())
           for s, m, by, p, c in anchor.stream_anchor_chunks(
               codes, nk, chunk, None, bd.table, bd, 1, n, K)]
    assert [(s, m) for s, m, *_ in got] == [
        (s, min(chunk, nk - s)) for s in range(0, nk, chunk)]
    for s, m, by, popc, cs in got:
        buf = np.full(L, 255, np.uint8)
        buf[:m + K - 1] = codes[s:s + m + K - 1]
        packed, nmask, _ = pack_bases_np(buf)
        wb, wp, wc = anchor.anchor_chunk_fast(
            torch.from_numpy(packed), torch.from_numpy(nmask), bd.table, L,
            K, bd.nbits, bd.cap, bd.nwords, 1)
        assert np.array_equal(by, wb[:m].numpy())
        assert np.array_equal(popc, wp[:m].numpy())
        assert np.array_equal(cs, wc[:n].numpy())
    assert any(p.any() for _s, _m, _b, p, _c in got)
