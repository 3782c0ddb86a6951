"""pack_mix: the plain torch version against the Pallas kernel, and a numpy
model of the CUDA kernel's threads against the plain version.

The CUDA kernel (panagram_tpu_torch/csrc/pack_mix.cu) runs only on a card.
Its algorithm is proven here first: ``thread_model`` restates, thread for
thread, what the kernel computes (the streams read as aligned 32-bit words
joined by funnel shifts, the per-thread fast and byte-wise paths, one
bit-reverse-based pair reverse shared by the four positions of a packed
byte, the N-mask test, padding and the partial last group), and must equal
``pack_mix_plain`` bit for bit.  Inputs come from numpy with a fixed seed;
everything is integer, so every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panagram_tpu.ops import pallas_kernels as pk
from panagram_tpu_torch.ops import kernels
from panagram_tpu_torch.ops.codec import pack_bases_np
from panagram_tpu_torch.ops.lookup import TILE_Q

torch.set_num_threads(2)

U64 = np.uint64
U32 = np.uint32
PALLAS_TILE = 16 * 1024       # pack_mix_pallas wants Ppad in multiples of it
BLOCK_POSITIONS = 4 * 256     # positions one block of the CUDA kernel covers


def _codes(rng, L, k):
    """Random bases with 2% N, an N in the first window and in the last."""
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.choice(L, max(L // 50, 1), replace=False)] = 255
    if L >= k:
        codes[k - 1] = 255     # the first window's last base
        codes[L - k] = 255     # the last window's first base
    return codes


def _plain(packed, nmask, L, k, Ppad):
    hi, lo = kernels.pack_mix_plain(torch.from_numpy(packed),
                                    torch.from_numpy(nmask), L, k, Ppad)
    return hi.numpy().view(U32), lo.numpy().view(U32)


# L: a multiple of neither 4 nor 8; of 4 but not 8; of 8; one past a block
# of the CUDA kernel; one short of a Pallas tile
LENGTHS = [2 * PALLAS_TILE + 7, PALLAS_TILE + 4, PALLAS_TILE + 64,
           BLOCK_POSITIONS * 3 + 31, 3 * PALLAS_TILE - 1]


@pytest.mark.parametrize("k", [15, 21, 31])
@pytest.mark.parametrize("L", LENGTHS)
def test_pack_mix_plain_matches_pallas(k, L):
    """At Ppad = P, at the next multiple of TILE_Q and at the Pallas
    kernel's own padding, the plain version gives the Pallas kernel's
    values in positional order and the all-ones pair past P."""
    rng = np.random.default_rng(1000 * k + L)
    packed, nmask, _ = pack_bases_np(_codes(rng, L, k))
    P = L - k + 1
    Pp = -(-P // PALLAS_TILE) * PALLAS_TILE
    mhi, mlo = pk.pack_mix_pallas(jnp.asarray(packed), jnp.asarray(nmask),
                                  L, k, Pp)
    pos = np.asarray(pk.pack_mix_positions(Pp))
    want_hi, want_lo = np.empty(Pp, U32), np.empty(Pp, U32)
    want_hi[pos] = np.asarray(mhi).astype(U32).reshape(-1)
    want_lo[pos] = np.asarray(mlo).astype(U32).reshape(-1)
    assert (want_hi[P:] == 0xFFFFFFFF).all() and (want_lo[P:] == 0xFFFFFFFF).all()
    for Ppad in (P, -(-P // TILE_Q) * TILE_Q, Pp):
        hi, lo = _plain(packed, nmask, L, k, Ppad)
        assert hi.shape == (Ppad,) and lo.shape == (Ppad,)
        assert np.array_equal(hi, want_hi[:Ppad]), Ppad
        assert np.array_equal(lo, want_lo[:Ppad]), Ppad


# --------------------------------------------------------------------------
# the CUDA kernel's threads, in numpy
# --------------------------------------------------------------------------

def _brev64(x):
    """Bit reverse of each u64 (the __brevll instruction)."""
    x = x.astype(U64)
    for m, s in ((0x5555555555555555, 1), (0x3333333333333333, 2),
                 (0x0F0F0F0F0F0F0F0F, 4), (0x00FF00FF00FF00FF, 8),
                 (0x0000FFFF0000FFFF, 16)):
        x = ((x & U64(m)) << U64(s)) | ((x >> U64(s)) & U64(m))
    return (x << U64(32)) | (x >> U64(32))


def _pair_reverse64(x):
    y = _brev64(x)
    low = U64(0x5555555555555555)
    return ((y & low) << U64(1)) | ((y >> U64(1)) & low)


def _pair_reverse8(e):
    y = _brev64(e.astype(U64)) >> U64(56)        # __brev(e) >> 24
    return ((y & U64(0x55)) << U64(1)) | ((y >> U64(1)) & U64(0x55))


def _funnelshift_r(lo, hi, sh):
    """Low 32 bits of (hi:lo) >> sh for 0 <= sh < 32, on u64 carriers."""
    return (((hi << U64(32)) | lo) >> sh) & U64(0xFFFFFFFF)


def _funnelshift_l(lo, hi, sh):
    """High 32 bits of (hi:lo) << sh for 0 <= sh < 32, on u64 carriers."""
    return ((((hi << U64(32)) | lo) << sh) >> U64(32)) & U64(0xFFFFFFFF)


def _gather_bytes(stream, b, count, fill):
    """Little-endian value of bytes [b, b+count) of `stream`; bytes past its
    end read as `fill` (the kernel's byte-wise path)."""
    v = np.zeros(len(b), U64)
    n = len(stream)
    for t in range(count):
        i = b + t
        byte = np.where(i < n, stream[np.minimum(i, n - 1)] if n else 0, fill)
        v |= byte.astype(U64) << U64(8 * t)
    return v


def _mix64(x):
    x = x.copy()
    x ^= x >> U64(30)
    x *= U64(0xBF58476D1CE4E5B9)
    x ^= x >> U64(27)
    x *= U64(0x94D049BB133111EB)
    x ^= x >> U64(31)
    return x


def _words(stream, a, rng):
    """The stream as the kernel sees it: aligned u32 words of a buffer in
    which the stream starts at byte `a`, with random bytes before it and
    after it (what a slice of a larger buffer is surrounded by).  Returns
    (words as u64 carriers, count of words that end inside the stream)."""
    buf = rng.integers(0, 256, a + len(stream) + 16, dtype=np.uint8)
    buf[a:a + len(stream)] = stream
    buf = buf[:len(buf) // 4 * 4]
    return buf.view("<u4").astype(U64), (a + len(stream)) >> 2


def thread_model(packed, nmask, L, k, Ppad, ap=0, an=0, seed=0):
    """(hi, lo) u32 [Ppad] as pack_mix.cu's threads compute them, one
    thread per group of four positions, for streams whose first bytes lie
    `ap` and `an` bytes past a 4-byte boundary.  Also returns how many
    threads took the unchecked word path for each stream."""
    rng = np.random.default_rng(seed)
    P = L - k + 1
    mask2k = U64((1 << (2 * k)) - 1)
    kmask = U64((1 << k) - 1)
    fshift = U64(64 - 2 * k)
    pw, pwords = _words(packed, ap, rng)
    nw, nwords = _words(nmask, an, rng)
    groups = (Ppad + 3) >> 2
    b = np.arange(groups, dtype=np.int64)
    p0 = b << 2

    # D = bytes b..b+7, e = byte b+8
    g = b + ap
    wi = g >> 2
    fast_p = wi + 3 <= pwords
    wis = np.where(fast_p, wi, 0)
    if len(pw) < 3:
        pw = np.concatenate([pw, np.zeros(3, U64)])
    w0, w1, w2 = pw[wis], pw[wis + 1], pw[wis + 2]
    sh = (8 * (g & 3)).astype(U64)
    D = (_funnelshift_r(w1, w2, sh) << U64(32)) | _funnelshift_r(w0, w1, sh)
    e = (w2 >> sh) & U64(0xFF)
    D = np.where(fast_p, D, _gather_bytes(packed, b, 8, 0))
    e = np.where(fast_p, e, _gather_bytes(packed, b + 8, 1, 0))

    # nm: the N-mask bits from position p0 on
    nb = b >> 1
    o = ((b & 1) << 2).astype(U64)
    gn = nb + an
    wj = gn >> 2
    fast_n = wj + 2 <= nwords
    wjs = np.where(fast_n, wj, 0)
    if len(nw) < 2:
        nw = np.concatenate([nw, np.zeros(2, U64)])
    nm = ((nw[wjs + 1] << U64(32)) | nw[wjs]) >> ((8 * (gn & 3)).astype(U64) + o)
    nm = np.where(fast_n, nm, _gather_bytes(nmask, nb, 5, 0xFF) >> o)

    R = _pair_reverse64(D)
    r_lo, r_hi = R & U64(0xFFFFFFFF), R >> U64(32)
    re_top = _pair_reverse8(e) << U64(24)
    hi = np.full(4 * groups, 0xFFFFFFFF, U32)
    lo = np.full(4 * groups, 0xFFFFFFFF, U32)
    for r in range(4):
        if r:
            w = (D >> U64(2 * r)) | (e << U64(64 - 2 * r))
            rw = (_funnelshift_l(r_lo, r_hi, U64(2 * r)) << U64(32)) \
                | _funnelshift_l(re_top, r_lo, U64(2 * r))
        else:
            w, rw = D, R
        w = w & mask2k
        fwd = rw >> fshift
        rc = w ^ mask2k
        canon = np.minimum(fwd, rc)
        bad = ((nm >> U64(r)) & U64(0xFFFFFFFF) & kmask) != 0
        x = _mix64(np.where(bad, U64(0xFFFFFFFFFFFFFFFF), canon))
        real = p0 + r < P
        hi[r::4] = np.where(real, (x >> U64(32)).astype(U32), U32(0xFFFFFFFF))
        lo[r::4] = np.where(real, x.astype(U32), U32(0xFFFFFFFF))
    live = p0 < P
    return hi[:Ppad], lo[:Ppad], int((fast_p & live).sum()), \
        int((fast_n & live).sum())


MODEL_LENGTHS = [31, 64, 1027, BLOCK_POSITIONS + 30, 2 * BLOCK_POSITIONS + 37,
                 3 * BLOCK_POSITIONS + 8]


@pytest.mark.parametrize("k", [1, 15, 21, 31])
@pytest.mark.parametrize("L", MODEL_LENGTHS)
def test_pack_mix_thread_model_matches_plain(k, L):
    """The kernel's per-thread arithmetic equals the plain version at every
    output length the callers use (Ppad = P, P + 1..3, the next multiple of
    TILE_Q) and every alignment of the two streams; all but the last few
    live threads take the unchecked word path."""
    rng = np.random.default_rng(100 * k + L)
    packed, nmask, _ = pack_bases_np(_codes(rng, L, k))
    P = L - k + 1
    for Ppad in (P, P + 1, P + 2, P + 3, -(-P // TILE_Q) * TILE_Q):
        want_hi, want_lo = _plain(packed, nmask, L, k, Ppad)
        for ap, an in ((0, 0), (1, 0), (0, 3), (3, 2), (2, 1)):
            hi, lo, fast_p, fast_n = thread_model(packed, nmask, L, k, Ppad,
                                                  ap, an, seed=L + ap)
            assert np.array_equal(hi, want_hi), (Ppad, ap, an)
            assert np.array_equal(lo, want_lo), (Ppad, ap, an)
            # all but the threads whose words reach past the streams' ends
            live = -(-P // 4)
            assert fast_p >= live - 16 and fast_n >= live - 16


@pytest.mark.parametrize("k", [5, 31])
def test_pack_mix_thread_model_on_short_and_long_streams(k):
    """Streams shorter than the positions asked for (bytes past `packed`
    read as 0, past `nmask` as 0xFF: every window there is invalid) and
    longer than needed (the surplus is ignored)."""
    rng = np.random.default_rng(k)
    L = 5000
    packed, nmask, _ = pack_bases_np(_codes(rng, L, k))
    Ppad = -(-(L - k + 1) // TILE_Q) * TILE_Q
    for pk_bytes, nm_bytes in ((len(packed) // 2, len(nmask)),
                               (len(packed), len(nmask) // 2),
                               (len(packed) + 40, len(nmask) + 40)):
        p = np.resize(packed, pk_bytes)
        n = np.resize(nmask, nm_bytes)
        want_hi, want_lo = _plain(p, n, L, k, Ppad)
        hi, lo, _, _ = thread_model(p, n, L, k, Ppad, ap=1, an=3)
        assert np.array_equal(hi, want_hi) and np.array_equal(lo, want_lo)


def test_pair_reverse_by_bit_reverse_is_the_mask_and_shift_reverse():
    """The kernel's pair reverse (bit reverse, then one swap within each
    pair) equals the plain version's five mask-and-shift stages."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 64, 4096, dtype=U64)
    x[:3] = [0, 1, 0xFFFFFFFFFFFFFFFF]
    want = kernels._pair_reverse64(torch.from_numpy(x.view(np.int64)))
    assert np.array_equal(_pair_reverse64(x), want.numpy().view(U64))
    e = np.arange(256, dtype=U64)
    assert np.array_equal(_pair_reverse8(e), _pair_reverse64(e) >> U64(56))
