"""The plain torch versions of the kernels against the Pallas kernels.

Each Pallas kernel runs in interpret mode on the CPU, as tests/test_pallas.py
runs it; the port's wrappers, given CPU tensors, run their plain versions.
Inputs come from numpy with a fixed seed, and everything is integer, so
every comparison is exact (tolerance 0).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panagram_tpu.ops import pallas_kernels as pk
from panagram_tpu.ops.dictionary import build_dictionary as jax_build_dictionary
from panagram_tpu.ops.lookup import BucketedDict as JaxBucketedDict
from panagram_tpu.ops.lookup import row_pack
from panagram_tpu.ops import ref_impl as jax_ref_impl
from panagram_tpu.ops.ref_impl import genome_kmer_set
from panagram_tpu_torch.ops import kernels
from panagram_tpu_torch.ops.codec import pack_bases_np
from panagram_tpu_torch.ops.lookup import BucketedDict, mix64_np
from panagram_tpu_torch.ops.ref_impl import masks_to_bytes_np
from panagram_tpu_torch.tools import mosaic_probe as port_mosaic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("k", [5, 16, 21, 31])
@pytest.mark.parametrize("L", [3 * 16384, 4 * 16384 + 7])
def test_pack_mix_matches_pallas(k, L):
    rng = np.random.default_rng(1000 * k + L)
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.choice(L, L // 50, replace=False)] = 255
    packed, nmask, L2 = pack_bases_np(codes)
    P = L - k + 1
    Ppad = -(-P // (16 * 1024)) * (16 * 1024)

    mhi, mlo = pk.pack_mix_pallas(jnp.asarray(packed), jnp.asarray(nmask),
                                  L2, k, Ppad)
    pos = np.asarray(pk.pack_mix_positions(Ppad))
    want_hi = np.empty(Ppad, np.uint32)
    want_lo = np.empty(Ppad, np.uint32)
    want_hi[pos] = _u32(mhi).reshape(-1)
    want_lo[pos] = _u32(mlo).reshape(-1)

    hi, lo = kernels.pack_mix(torch.from_numpy(packed), torch.from_numpy(nmask),
                              L2, k, Ppad)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi)
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo)
    assert (want_hi[P:] == 0xFFFFFFFF).all()


def _probe_inputs(rng, ngenomes, ntiles, tile_q=1024):
    """Queries (mixed keys of the genomes' k-mers plus misses and all-ones
    padding) sorted by hi, and the JAX table from a `ngenomes` dictionary."""
    K = 13
    seqs = ["".join(rng.choice(list("ACGT"), 600)) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = jax_build_dictionary(sets, K)
    jbd = JaxBucketedDict.build(d.keys, d.masks, ngenomes, K)
    Q = ntiles * tile_q
    hits = rng.choice(d.keys, Q // 2)
    misses = rng.integers(0, 1 << 62, Q // 2 - 100, dtype=np.uint64)
    m = np.concatenate([mix64_np(hits), mix64_np(misses),
                        np.full(100, np.uint64(0xFFFFFFFFFFFFFFFF))])
    m = m[np.argsort((m >> np.uint64(32)).astype(np.uint32), kind="stable")]
    qhi = (m >> np.uint64(32)).astype(np.uint32)
    qlo = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return jbd, qhi, qlo


def _jax_blo_span(qhi, nbits, stride, tile_q):
    """blo (packed rows) and span as panagram_tpu's merge probe computes them
    (lookup.py bucket_query_sorted_pre)."""
    B = 1 << nbits
    pack = row_pack(stride, B)
    Bp = B // pack
    Qp = len(qhi)
    expect = max(tile_q * Bp // Qp, 1)
    span = min(Bp, max((1 << 19) // (stride * pack), 64),
               max((-(-3 * expect // 2) + 7) & ~7, 64))
    brow = (qhi >> np.uint32(32 - nbits)).astype(np.int64) >> (pack.bit_length() - 1)
    blo = np.clip(brow[::tile_q], 0, Bp - span).astype(np.int32)
    return blo, span, pack


@pytest.mark.parametrize("ngenomes,ntiles", [(3, 2), (40, 4), (70, 4),
                                             (100, 4)])
def test_probe_sorted_matches_pallas(ngenomes, ntiles):
    rng = np.random.default_rng(7 + ngenomes)
    tile_q = 1024
    jbd, qhi, qlo = _probe_inputs(rng, ngenomes, ntiles, tile_q)
    (jt,) = jbd.device_arrays()
    blo, span, pack = _jax_blo_span(qhi, jbd.nbits, jbd.stride, tile_q)
    want = _u32(pk.probe_sorted(jnp.asarray(qhi), jnp.asarray(qlo),
                                jnp.asarray(blo), jt, jbd.nbits, jbd.cap,
                                jbd.nwords, span=span, pack=pack,
                                tile_q=tile_q)).T          # [Q, W]
    assert want.any()

    bd = BucketedDict.from_jax_state(np.asarray(jt), jbd.nbits, jbd.cap,
                                     jbd.stride, ngenomes, 13, jbd.nwords)
    got = kernels.probe_sorted(_i32(qhi), _i32(qlo),
                               torch.from_numpy(blo * pack),
                               _i32(bd.table), bd.nbits, bd.cap, bd.nwords,
                               span * pack, tile_q)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_fused_popcount_colsums_matches_pallas():
    rng = np.random.default_rng(11)
    P, W, N = 4096, 2, 40
    rows = rng.integers(0, 1 << 31, (P, W)).astype(np.uint32)
    rows[:, 1] &= np.uint32((1 << (N - 32)) - 1)   # only bits < N are set
    want_p, want_c = pk.fused_popcount_colsums(jnp.asarray(rows), N)
    popc, colsums = kernels.fused_popcount_colsums(_i32(rows), N)
    assert popc.dtype == torch.int32 and colsums.dtype == torch.int32
    assert np.array_equal(popc.numpy(), np.asarray(want_p))
    assert np.array_equal(colsums.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("nbytes", [1, 4, 5])
def test_masks_to_bytes_matches_pallas(nbytes):
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 1 << 32, (pk.TILE, 2), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pk.masks_to_bytes_pallas(jnp.asarray(rows), nbytes))
    got = kernels.masks_to_bytes(_i32(rows), nbytes)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def _mask_rows(rng, P, W, N):
    """Random u32 rows [P, W] with no bit at or past N."""
    rows = rng.integers(0, 1 << 32, (P, W), dtype=np.uint64)
    rows[:, -1] &= np.uint64((1 << (N - 32 * (W - 1))) - 1)
    return rows.astype(np.uint32)


# the shapes at which the CUDA kernels branch: W with a vector instance (1,
# 2, 4) and without (3, 5); nbytes that cut nothing (4W), one byte, three
# bytes, and all but one
BYTES_GRID = [(W, nb) for W in (1, 2, 3, 4, 5)
              for nb in sorted({1, 4 * W - 3, 4 * W - 1, 4 * W})]


@pytest.mark.parametrize("W,nbytes", BYTES_GRID)
def test_masks_to_bytes_grid_matches_pallas(W, nbytes):
    rng = np.random.default_rng(100 * W + nbytes)
    rows = rng.integers(0, 1 << 32, (pk.TILE, W), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pk.masks_to_bytes_pallas(jnp.asarray(rows), nbytes))
    got = kernels.masks_to_bytes(_i32(rows), nbytes)
    assert got.dtype == torch.uint8 and got.shape == (pk.TILE, nbytes)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("P", [1, 7, 1023])
def test_masks_to_bytes_matches_numpy_at_ragged_sizes(P):
    """Row counts that are no multiple of 16 (the kernels' 128-bit pieces
    end inside a row), against the port's numpy reference."""
    rng = np.random.default_rng(P)
    for W, nbytes in BYTES_GRID:
        rows = rng.integers(0, 1 << 32, (P, W), dtype=np.uint64).astype(np.uint32)
        got = kernels.masks_to_bytes(_i32(rows), nbytes)
        assert np.array_equal(got.numpy(), masks_to_bytes_np(rows, nbytes))


@pytest.mark.parametrize("W,N", [(1, 30), (1, 32), (2, 40), (3, 70), (4, 100),
                                 (5, 130)])
def test_fused_popcount_colsums_grid_matches_jax(W, N):
    """Against the Pallas kernel in interpret mode at P = 4096; the column
    totals also against panagram_tpu's numpy reference rows."""
    rng = np.random.default_rng(17 * W + N)
    P = 4096
    rows = _mask_rows(rng, P, W, N)
    want_p, want_c = pk.fused_popcount_colsums(jnp.asarray(rows), N)
    popc, colsums = kernels.fused_popcount_colsums(_i32(rows), N)
    assert popc.shape == (P,) and colsums.shape == (N,)
    assert np.array_equal(popc.numpy(), np.asarray(want_p))
    assert np.array_equal(colsums.numpy(), np.asarray(want_c))
    assert np.array_equal(popc.numpy(), jax_ref_impl.popcount_np(rows))


@pytest.mark.parametrize("P,W,N,ones", [
    (1, 1, 30, False), (7, 2, 40, False), (1023, 4, 100, False),
    (4097, 5, 130, False), (70_000, 1, 32, True), (70_000, 2, 64, True),
    (70_000, 4, 128, True)])
def test_fused_popcount_colsums_matches_numpy(P, W, N, ones):
    """Odd row counts, and rows of all ones over 70,000 rows: past any
    interval at which a kernel flushes its small column counters, and past
    2^16."""
    rng = np.random.default_rng(P + W)
    rows = np.full((P, W), 0xFFFFFFFF, np.uint32) if ones \
        else _mask_rows(rng, P, W, N)
    bits = np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")
    popc, colsums = kernels.fused_popcount_colsums(_i32(rows), N)
    assert np.array_equal(popc.numpy(), bits.sum(axis=1))
    assert np.array_equal(colsums.numpy(), bits.sum(axis=0)[:N])
    if ones:
        assert (colsums.numpy() == P).all() and (popc.numpy() == 32 * W).all()


@pytest.mark.parametrize("name,shape,want", [
    ("pack_bases", dict(L=(1 << 22) + 30), 4_194_334 + 1_048_584 + 524_292),
    ("pack_mix", dict(L=(1 << 22) + 30, k=31, Ppad=1 << 22),
     1_048_584 + 524_292 + 33_554_432),
    ("probe_sorted", dict(Q=1 << 22, nwords=1, tile_q=1024,
                          table_bytes=117_000_000),
     33_554_432 + 16_384 + 16_777_216 + 117_000_000),
    ("fused_popcount_colsums", dict(P=1 << 22, W=1, ngenomes=32),
     16_777_216 + 16_777_216 + 128),
    ("masks_to_bytes", dict(P=1 << 22, W=1, nbytes=4), 16_777_216 + 16_777_216),
    ("masks_to_bytes", dict(P=1 << 22, W=2, nbytes=5), 33_554_432 + 20_971_520),
    ("mosaic_probe", dict(n=1 << 24), 134_217_728 + 268_435_456),
])
def test_bound_bytes_at_the_main_path_shapes(name, shape, want):
    """Each input read once, each output written once, at the shapes of a
    2^22-position chunk (k=31, 30 genomes) and of the 2^24 probe."""
    assert kernels.bound_bytes(name, **shape) == want
    with pytest.raises(KeyError):
        kernels.bound_bytes("no_such_kernel", **shape)


def _hand_table():
    """A 4-bucket table, W=1, cap 4 (stride 12): bucket 0 full, bucket 1
    three keys (one with an all-ones lo word), bucket 2 empty, bucket 3 one
    key with an all-ones hi word."""
    t = np.full((4, 12), 0xFFFFFFFF, np.uint32)
    t[0] = [0x1, 1, 11, 0x2, 2, 12, 0x3, 3, 13, 0x4, 4, 14]
    t[1, :9] = [0x40000001, 1, 21, 0x40000002, 0xFFFFFFFF, 22,
                0x40000003, 9, 23]
    t[3, :3] = [0xFFFFFFFF, 7, 31]
    return t


# sorted on hi, three tiles of 4: hits at slots 0 (twice) and cap - 1 of
# the full row and a miss there; hits at slots 0 and 1 of bucket 1, none
# at its last key (slot 2) nor its terminator; bucket 3's key and
# (0xC0000000, 1), a miss, out of tile 1's window when span = 2; bucket 3's
# key again, an all-ones query and two all-ones pads
HAND_QUERIES = [(0x1, 1), (0x1, 1), (0x4, 4), (0x5, 5),
                (0x40000001, 1), (0x40000002, 0xFFFFFFFF), (0xC0000000, 1),
                (0xFFFFFFFF, 7),
                (0xFFFFFFFF, 7)] + [(0xFFFFFFFF, 0xFFFFFFFF)] * 3


@pytest.mark.parametrize("span,want_rows,want_bytes", [
    # rows 0, 1, 3: 4 + 2 + 2 pairs (the miss in row 3 reads its key and
    # terminator); slots hit: 0/0, 0/3, 1/0, 1/1, 3/0
    (4, [11, 11, 14, 0, 21, 22, 0, 31, 31, 0, 0, 0], 8 * 8 + 4 * 5),
    # tile 1 reads rows 1-2: its bucket-3 queries read the empty row 2 and
    # miss (1 pair); tile 2 reads rows 2-3, its hit in row 3 1 pair
    (2, [11, 11, 14, 0, 21, 22, 0, 0, 31, 0, 0, 0], 8 * 8 + 4 * 5),
])
def test_probe_need_bytes_by_hand(span, want_rows, want_bytes):
    """probe_need_bytes against a hand count: a row costs the pairs of its
    longest scan, to a hit at slot s s + 1, to a miss its keys and the
    terminator (a full row its cap pairs); an all-ones query nothing; each
    distinct slot hit 4W bytes.  The bound adds the queries, the windows
    and the output."""
    t = _i32(_hand_table())
    qhi = _i32([h for h, _ in HAND_QUERIES])
    qlo = _i32([lo for _, lo in HAND_QUERIES])
    blo = kernels.probe_rows(qhi[::4], torch.zeros(3, dtype=torch.int32), 2,
                             4, 1)
    blo = torch.clamp(blo, max=4 - span).to(torch.int32)
    args = (qhi, qlo, blo, t, 2, 4, 1, span, 4)
    assert kernels.probe_sorted(*args)[:, 0].tolist() == want_rows
    got = kernels.probe_need_bytes(*args)
    assert got == want_bytes
    assert kernels.probe_need_bytes(*args, block=2) == got
    assert kernels.bound_bytes("probe_sorted", Q=12, nwords=1, tile_q=4,
                               table_bytes=got) == 8 * 12 + 4 * 3 + 4 * 12 + got


def test_probe_rows_are_the_rows_the_plain_probe_gathers():
    rng = np.random.default_rng(23)
    jbd, qhi, qlo = _probe_inputs(rng, 3, 2)
    (jt,) = jbd.device_arrays()
    bd = BucketedDict.from_jax_state(np.asarray(jt), jbd.nbits, jbd.cap,
                                     jbd.stride, 3, 13, jbd.nwords)
    blo, span, pack = _jax_blo_span(qhi, jbd.nbits, jbd.stride, 1024)
    rows = kernels.probe_rows(_i32(qhi), torch.from_numpy(blo * pack),
                              bd.nbits, span * pack, 1024)
    assert rows.dtype == torch.int64 and rows.shape == (len(qhi),)
    assert int(rows.min()) >= 0 and int(rows.max()) < (1 << bd.nbits)
    t = _i32(bd.table)
    got = kernels.match_slots(t[rows], _i32(qhi), _i32(qlo), bd.cap, bd.nwords)
    want = kernels.probe_sorted(_i32(qhi), _i32(qlo),
                                torch.from_numpy(blo * pack), t, bd.nbits,
                                bd.cap, bd.nwords, span * pack, 1024)
    assert torch.equal(got, want)


def test_build_compiles_the_five_sources_of_the_package():
    """One library beside the package, from the sources of csrc/ (the five
    kernels that replace TPU kernels, and pack_bases), each with the C
    entry point its wrapper calls."""
    from panagram_tpu_torch import _build

    assert os.path.dirname(_build.LIB_PATH) == _build.BUILD_DIR
    assert os.path.dirname(_build.BUILD_DIR) == os.path.dirname(_build.SRC_DIR)
    srcs = _build.sources()
    assert [os.path.basename(p) for p in srcs] == [
        "masks_to_bytes.cu", "mosaic_probe.cu", "pack_bases.cu",
        "pack_mix.cu", "popcount_colsums.cu", "probe_sorted.cu"]
    text = "".join(open(p).read() for p in srcs)
    for entry in kernels._SIGNATURES:
        assert f'extern "C" int {entry}(' in text, entry


def test_cpu_tensors_take_plain_versions_without_counting():
    kernels.reset_launches()
    rows = torch.zeros(64, 1, dtype=torch.int32)
    kernels.masks_to_bytes(rows, 2)
    kernels.fused_popcount_colsums(rows, 30)
    assert all(v == 0 for v in kernels.launches.values())


def test_wrappers_refuse_bad_inputs():
    rows = torch.zeros(8, 1, dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.masks_to_bytes(rows, 2)                       # dtype
    with pytest.raises(ValueError):
        kernels.masks_to_bytes(torch.zeros(8, 1, dtype=torch.int32), 5)  # > 4W
    with pytest.raises(ValueError):
        kernels.fused_popcount_colsums(
            torch.zeros(8, 1, dtype=torch.int32, device="meta"), 4)
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.mosaic_probe(a.to(torch.int64), a)             # dtype
    with pytest.raises(ValueError):
        kernels.mosaic_probe(a, a[:4])                         # shapes
    with pytest.raises(ValueError):
        kernels.mosaic_probe(a.to("meta"), a.to("meta"))       # device


def _mosaic_want(a, b):
    """What tools/mosaic_probe.py checks its kernel's output against."""
    want_prod = (a.astype(np.uint64) * b.astype(np.uint64)).astype(np.uint32)
    want_roll = np.roll(a, -1)
    want_hi16 = ((a >> 16).astype(np.uint64) * (b & 0xFFFF)).astype(np.uint32)
    want_cmp = np.where(a < b, want_prod, want_roll)
    return np.stack([want_prod, want_roll, want_hi16, want_cmp], axis=1)


@pytest.mark.parametrize("n", [1024, 1, 777, 1 << 16])
def test_mosaic_probe_plain_matches_numpy(n):
    """The tool's own inputs (default_rng(0)), other sizes, and the edge
    values of the unsigned compare and the products."""
    a, b = port_mosaic.probe_inputs(n)
    if n == 1 << 16:
        edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                        np.uint32)
        a[:25] = np.repeat(edge, 5)
        b[:25] = np.tile(edge, 5)
    got = kernels.mosaic_probe(torch.from_numpy(a.view(np.int32)),
                               torch.from_numpy(b.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (n, 4)
    assert np.array_equal(got.numpy().view(np.uint32), _mosaic_want(a, b))
    assert all(np.array_equal(w, _mosaic_want(a, b)[:, i])
               for i, w in enumerate(port_mosaic.expected(a, b)))


def test_mosaic_probe_tools_print_the_four_checks(capsys):
    """panagram_tpu's tools/mosaic_probe.py runs its Pallas kernel in
    interpret mode here and prints four True lines; the port's tool refuses
    a CPU device, since its kernel runs only on a CUDA card."""
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_probe", os.path.join(REPO, "tools", "mosaic_probe.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main()
    lines = capsys.readouterr().out.splitlines()
    checks = [line for line in lines if "ok:" in line or "exact:" in line]
    assert [c.split(":")[0].strip() for c in checks] == \
        ["u32 mul exact", "roll ok", "16x32 mul ok", "select ok"]
    assert all(c.split(":")[1].strip() == "True" for c in checks)

    kernels.reset_launches()
    with pytest.raises(SystemExit, match="not a CUDA device"):
        port_mosaic.main(["--device", "cpu"])
    assert kernels.launches["mosaic_probe"] == 0
