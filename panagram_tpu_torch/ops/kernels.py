"""The device kernels of the port, with their plain versions.

Each wrapper here but pack_bases replaces one Pallas TPU kernel: the four
of the anchor chunk in ``panagram_tpu/ops/pallas_kernels.py``, and the
capability probe of ``tools/mosaic_probe.py``.  pack_bases (through
pack_chunk) packs a chunk's bases on the card for the anchor stream, the
device-dict builder and the mesh ranks, where panagram_tpu packs them on
the host:

=========================  ===============================  ==================
wrapper                    TPU kernel                       CUDA source
=========================  ===============================  ==================
pack_bases                 no TPU kernel: panagram_tpu      csrc/pack_bases.cu
                           packs on the host
                           (codec.pack_bases_np)
pack_mix                   pack_mix_pallas                  csrc/pack_mix.cu
probe_sorted               probe_sorted                     csrc/probe_sorted.cu
fused_popcount_colsums     fused_popcount_colsums           csrc/popcount_colsums.cu
masks_to_bytes             masks_to_bytes_pallas            csrc/masks_to_bytes.cu
mosaic_probe               kern (tools/mosaic_probe.py)     csrc/mosaic_probe.cu
=========================  ===============================  ==================

On a CUDA tensor a wrapper launches its hand-written kernel (built by
``panagram_tpu_torch._build`` at first use, called through ctypes on
torch's current stream) and adds one to ``launches[name]``; a refused
launch raises.  On a CPU tensor it runs the plain torch version
beside it, which is the specification the kernel is tested against.  Any
other device raises.  Each source file notes what bounds its kernel on the
card and what its design does about that; in short:

* pack_bases: bytes (1 in and 3/8 out per base).  One thread packs 8
  bases: one 64-bit load, the N flags and the 2-bit fields found for all 8
  bytes at once by shifts and masks (SWAR), one 16-bit store of bases and
  one mask byte; the grid is capped and loops.
* pack_mix: bytes (8.4 per position), with integer work of the same
  order.  One thread does the four positions of a packed byte: one
  72-bit window from three aligned word loads, one bit-reverse-based pair
  reverse for all four, 128-bit stores; the grid is capped and loops.  On
  an NVIDIA H100 80GB HBM3 at 700.00 W: 0.0192-0.0199 ms cold per
  2^22-position chunk, 0.53 of its bound (chip_smoke.py).
* probe_sorted: bytes, most of them the table's: the key pairs of each row
  its queries read, as far as the longest scan of the row goes (to a hit,
  or on a miss to the empty slot that ends the row's keys), and the mask
  words of each slot hit (probe_need_bytes).  Each query stops at the
  first hit or empty slot; at W=1 and 2 it loads 64-byte pieces of its
  row as 16-byte loads issued before any compare, at W=3 and 4 single
  words.  0.087 / 0.106 / 0.139 / 0.134 ms cold at W=1-4 on the same
  card, 0.31-0.37 of its bound (tools/kernel_times.py).
* fused_popcount_colsums: bytes.  128-bit loads, bit-sliced 5-bit column
  counters per thread, and a 32 x 32 bit transpose per warp at each flush
  keep the arithmetic at a few instructions per word.
* masks_to_bytes: bytes.  The output is a byte stream cut out of the
  input: a 128-bit copy when nothing is cut, else tiles staged in shared
  memory and 16 output bytes gathered per thread.
* mosaic_probe: bytes; 8 in and 16 out per element, already streaming.

``bound_bytes`` counts the bytes each function must move, from its shapes
and, for probe_sorted, the table bytes its queries need
(``probe_need_bytes``); chip_smoke.py and PERF.md hold the measured times
against that count over the card's memory rate.

u32 data travels as int32 tensors holding the same bits.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .codec import SENTINEL, mix64, split64, srl, to_i32, u32

# kernel launches on the card since the last reset_launches(), by wrapper
launches = {"pack_bases": 0, "pack_mix": 0, "probe_sorted": 0,
            "fused_popcount_colsums": 0, "masks_to_bytes": 0,
            "mosaic_probe": 0}

# grid caps of the column-sum and pack_mix kernels (blocks per SM x the
# card's 132 SMs): their blocks loop over the rows beyond
_POPC_MAX_BLOCKS = 132 * 8
_PACK_MAX_BLOCKS = 132 * 16
_SMEM_LIMIT = 48 * 1024

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    "pg_pack_bases": [_P, _I64, _I64, _P, _P, _P],
    "pg_pack_mix": [_P, _I64, _P, _I64, _I32, _I64, _I64, _P, _P, _I32, _P],
    "pg_probe_sorted": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I64,
                        _I32, _P, _P],
    "pg_popcount_colsums": [_P, _I64, _I32, _I32, _P, _P, _I32, _P],
    "pg_masks_to_bytes": [_P, _I64, _I32, _I32, _P, _P],
    "pg_mosaic_probe": [_P, _P, _I64, _P, _P],
}
_lib_handle = None
# guards the first-use build and load of the library and every update of
# `launches`: anchor threads (--cores) launch kernels concurrently
_lock = threading.Lock()


def _lib():
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            from .. import _build

            _build.build()
            lib = ctypes.CDLL(_build.LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib_handle = lib
        return _lib_handle


def reset_launches():
    with _lock:
        for name in launches:
            launches[name] = 0


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU tensors (plain
    version); raises on mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def _need(t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous {ndim}-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _launched(name: str, rc: int, device):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc} "
                           f"on {device}")
    with _lock:
        launches[name] += 1


def _stream(device) -> _P:
    return _P(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# pack_bases
# ---------------------------------------------------------------------------

def pack_bases(codes: torch.Tensor, nvalid: int, L: int,
               out: torch.Tensor) -> torch.Tensor:
    """codes uint8 [>= nvalid] (one base a byte: 0-3 ACGT, >= 4 not) ->
    out uint8 [>= ceil(L/4) + ceil(L/8)], returned: codec.pack_bases_np's
    layout of L bases, the 2-bit bases (4 a byte, little-endian) in
    out[:ceil(L/4)] and the N-mask (bit i set when base i is not ACGT,
    little-endian bits) after them.  Bases at nvalid <= i < L are not ACGT,
    whatever codes holds there: codes past nvalid is never read.  Bytes of
    out past the two arrays are left as they are."""
    _need(codes, torch.uint8, 1, "pack_bases codes")
    _need(out, torch.uint8, 1, "pack_bases out")
    n4, n8 = -(-L // 4), -(-L // 8)
    if not 0 <= nvalid <= min(L, codes.numel()) or out.numel() < n4 + n8:
        raise ValueError(f"pack_bases: nvalid={nvalid}, L={L}, codes "
                         f"{tuple(codes.shape)}, out {tuple(out.shape)}")
    if not _on_card(codes, out):
        return pack_bases_plain(codes, nvalid, L, out)
    if L:
        dev = out.device
        rc = _lib().pg_pack_bases(codes.data_ptr(), int(nvalid), int(L),
                                  out.data_ptr(), out.data_ptr() + n4,
                                  _stream(dev))
        _launched("pack_bases", rc, dev)
    return out


def pack_chunk(codes: torch.Tensor, L: int):
    """A chunk's codes uint8 [nvalid] (nvalid <= L, on the device) -> the
    views (packed uint8 [ceil(L/4)], nmask uint8 [ceil(L/8)]) of one new
    buffer that pack_bases fills with codec.pack_bases_np's layout of L
    bases; those past the codes count as not ACGT."""
    n4 = -(-L // 4)
    out = torch.empty(n4 + -(-L // 8), dtype=torch.uint8, device=codes.device)
    pack_bases(codes, codes.numel(), L, out)
    return out[:n4], out[n4:]


def pack_bases_plain(codes, nvalid: int, L: int, out) -> torch.Tensor:
    """Plain torch version of pack_bases: the codes past nvalid replaced by
    255, then pack_bases_np's shifts over groups of 4 and 8 bases."""
    dev = out.device
    n4, n8 = -(-L // 4), -(-L // 8)
    c = torch.full((8 * n8,), 255, dtype=torch.uint8, device=dev)
    c[:nvalid] = codes[:nvalid]
    bad = (c >= 4) & (torch.arange(8 * n8, device=dev) < L)
    base = torch.where(c < 4, c, 0).to(torch.int32).reshape(-1, 4)
    packed = (base << torch.arange(0, 8, 2, device=dev)).sum(1)
    nmask = (bad.to(torch.int32).reshape(-1, 8)
             << torch.arange(8, device=dev)).sum(1)
    out[:n4] = packed[:n4].to(torch.uint8)
    out[n4:n4 + n8] = nmask.to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# pack_mix
# ---------------------------------------------------------------------------

def pack_mix(packed: torch.Tensor, nmask: torch.Tensor, L: int, k: int,
             Ppad: int):
    """packed uint8 [>= ceil(L/4)] (4 bases/byte, little-endian), nmask
    uint8 [>= ceil(L/8)] (bit i = base i is not ACGT) -> (hi, lo) int32
    [Ppad]: for each position p < P = L-k+1 the splitmix64 mix of its
    canonical k-mer (of the all-ones SENTINEL if the window holds an N);
    positions P <= p < Ppad get the all-ones pair.  Positional order."""
    if not 1 <= k <= 31 or Ppad < L - k + 1:
        raise ValueError(f"pack_mix: k={k}, L={L}, Ppad={Ppad}")
    _need(packed, torch.uint8, 1, "pack_mix packed")
    _need(nmask, torch.uint8, 1, "pack_mix nmask")
    if not _on_card(packed, nmask):
        return pack_mix_plain(packed, nmask, L, k, Ppad)
    dev = packed.device
    hi = torch.empty(Ppad, dtype=torch.int32, device=dev)
    lo = torch.empty(Ppad, dtype=torch.int32, device=dev)
    _pack_mix_into(packed, nmask, L, k, hi, lo)
    return hi, lo


def _pack_mix_into(packed, nmask, L: int, k: int, hi, lo,
                   max_blocks: int = _PACK_MAX_BLOCKS):
    """Launch the kernel into hi and lo, contiguous int32 [Ppad] tensors of
    the inputs' card (any 4-byte alignment), on a grid of at most
    max_blocks blocks."""
    _need(hi, torch.int32, 1, "pack_mix hi")
    _need(lo, torch.int32, 1, "pack_mix lo")
    Ppad = hi.shape[0]
    if lo.shape[0] != Ppad or not 1 <= k <= 31 or Ppad < L - k + 1 \
            or max_blocks < 1 or not _on_card(packed, nmask, hi, lo):
        raise ValueError(f"pack_mix: outputs {tuple(hi.shape)} "
                         f"{tuple(lo.shape)} for k={k}, L={L}, "
                         f"max_blocks={max_blocks}")
    if Ppad:
        dev = packed.device
        rc = _lib().pg_pack_mix(packed.data_ptr(), packed.numel(),
                                nmask.data_ptr(), nmask.numel(), k, L - k + 1,
                                Ppad, hi.data_ptr(), lo.data_ptr(),
                                max_blocks, _stream(dev))
        _launched("pack_mix", rc, dev)


def _pair_reverse64(x: torch.Tensor) -> torch.Tensor:
    x = (x << 32) | srl(x, 32)
    for m, s in ((0x0000FFFF0000FFFF, 16), (0x00FF00FF00FF00FF, 8),
                 (0x0F0F0F0F0F0F0F0F, 4), (0x3333333333333333, 2)):
        x = ((x & m) << s) | (srl(x, s) & m)
    return x


def pack_mix_plain(packed, nmask, L: int, k: int, Ppad: int):
    """Plain torch version of pack_mix (the window build of
    panagram_tpu.ops.codec.pack_kmers_packed, then mix64)."""
    dev = packed.device
    P = L - k + 1
    nb = -(-Ppad // 4)
    p = torch.zeros(nb + 9, dtype=torch.int64, device=dev)
    n = min(packed.numel(), nb + 9)
    p[:n] = packed[:n].to(torch.int64)
    D = p[:nb].clone()
    for t in range(1, 8):
        D |= p[t:t + nb] << (8 * t)
    E = p[8:8 + nb]
    phases = [D] + [srl(D, 2 * r) | (E << (64 - 2 * r)) for r in (1, 2, 3)]
    mask2k = (1 << (2 * k)) - 1
    W = torch.stack(phases, dim=1).reshape(-1)[:Ppad] & mask2k
    fwd = srl(_pair_reverse64(W), 64 - 2 * k)
    canon = torch.minimum(fwd, ~W & mask2k)

    n8 = -(-Ppad // 8)
    m = torch.full((n8 + 8,), 0xFF, dtype=torch.int64, device=dev)
    n = min(nmask.numel(), n8 + 8)
    m[:n] = nmask[:n].to(torch.int64)
    NB = m[:n8].clone()
    for t in range(1, 6):
        NB |= m[t:t + n8] << (8 * t)
    kmask = (1 << k) - 1
    bad = torch.stack([((NB >> r) & kmask) != 0 for r in range(8)],
                      dim=1).reshape(-1)[:Ppad]

    x = mix64(torch.where(bad, torch.full_like(canon, SENTINEL), canon))
    hi, lo = split64(x)
    pad = torch.arange(Ppad, device=dev) >= P
    ones = torch.full_like(hi, -1)
    return torch.where(pad, ones, hi), torch.where(pad, ones, lo)


# ---------------------------------------------------------------------------
# probe_sorted
# ---------------------------------------------------------------------------

def probe_sorted(qhi: torch.Tensor, qlo: torch.Tensor, blo: torch.Tensor,
                 table: torch.Tensor, nbits: int, cap: int, nwords: int,
                 span: int, tile_q: int) -> torch.Tensor:
    """qhi/qlo int32 [Q] sorted by hi (as u32), blo int32 [ceil(Q/tile_q)]
    (first table row of each tile's window), table int32 [2^nbits, stride]
    -> rows int32 [Q, W]: query i reads row blo[t] + clamp(bucket - blo[t],
    0, span-1), t = i // tile_q, and emits the W mask words of the slot
    holding its (hi, lo) pair, or 0.  The table's rows fill from slot 0, as
    every layout of this package and panagram_tpu's does: the kernel's
    scan of a row ends at the first all-ones pair."""
    Q = qhi.shape[0]
    B, stride = table.shape
    if not 1 <= nbits <= 32 or B != 1 << nbits or nwords < 1 \
            or cap * (2 + nwords) > stride or not 1 <= span <= B \
            or blo.shape[0] * tile_q < Q:
        raise ValueError(f"probe_sorted: nbits={nbits} table={tuple(table.shape)} "
                         f"cap={cap} W={nwords} span={span} tile_q={tile_q} "
                         f"Q={Q} tiles={blo.shape[0]}")
    for t, what in ((qhi, "qhi"), (qlo, "qlo"), (blo, "blo")):
        _need(t, torch.int32, 1, f"probe_sorted {what}")
    _need(table, torch.int32, 2, "probe_sorted table")
    if not _on_card(qhi, qlo, blo, table):
        return probe_sorted_plain(qhi, qlo, blo, table, nbits, cap, nwords,
                                  span, tile_q)
    out = torch.empty(Q, nwords, dtype=torch.int32, device=qhi.device)
    _probe_sorted_into(qhi, qlo, blo, table, nbits, cap, nwords, span,
                       tile_q, out)
    return out


def _probe_sorted_into(qhi, qlo, blo, table, nbits: int, cap: int,
                       nwords: int, span: int, tile_q: int, out):
    """Launch the kernel into out, a contiguous int32 [Q, W] tensor of the
    inputs' card; the other arguments are probe_sorted's, checked there."""
    _need(out, torch.int32, 2, "probe_sorted out")
    Q = qhi.shape[0]
    if out.shape != (Q, nwords) or not _on_card(qhi, qlo, blo, table, out):
        raise ValueError(f"probe_sorted: out {tuple(out.shape)} for Q={Q}, "
                         f"W={nwords}")
    if Q:
        dev = qhi.device
        rc = _lib().pg_probe_sorted(qhi.data_ptr(), qlo.data_ptr(),
                                    blo.data_ptr(), table.data_ptr(), Q, nbits,
                                    cap, nwords, table.shape[1], span, tile_q,
                                    out.data_ptr(), _stream(dev))
        _launched("probe_sorted", rc, dev)


def match_slots(rows: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                cap: int, nwords: int) -> torch.Tensor:
    """rows int32 [Q, stride] (each query's table row) -> int32 [Q, W]: the
    mask words of the slot matching (qhi, qlo), 0 on a miss or for the
    all-ones pair.  Keys are distinct, so at most one slot matches and the
    sum over slots is that slot's words."""
    Q = rows.shape[0]
    slot_w = 2 + nwords
    s = rows[:, :cap * slot_w].reshape(Q, cap, slot_w)
    valid = ~((qhi == -1) & (qlo == -1))
    hit = (s[:, :, 0] == qhi[:, None]) & (s[:, :, 1] == qlo[:, None]) \
        & valid[:, None]
    sel = torch.where(hit[:, :, None], s[:, :, 2:], torch.zeros_like(s[:, :, 2:]))
    return sel.sum(dim=1, dtype=torch.int32)


def probe_rows(qhi, blo, nbits: int, span: int, tile_q: int) -> torch.Tensor:
    """int64 [Q]: the table row each query of probe_sorted reads."""
    Q = qhi.shape[0]
    b0 = blo.to(torch.int64)[torch.arange(Q, device=qhi.device) // tile_q]
    bucket = u32(qhi) >> (32 - nbits)
    return b0 + torch.clamp(bucket - b0, 0, span - 1)


def probe_need_bytes(qhi, qlo, blo, table, nbits: int, cap: int,
                     nwords: int, span: int, tile_q: int,
                     block: int = 1 << 20) -> int:
    """The table bytes probe_sorted's queries need (its arguments).  A
    query other than the all-ones pair scans its row's 8-byte key pairs
    from slot 0 to its hit, or on a miss to the all-ones pair that ends
    the row's keys (all `cap` of a full row); each distinct row costs the
    pairs of its longest scan, and each distinct slot hit 4W bytes for its
    mask words.  Queries are taken `block` at a time."""
    slot_w = 2 + nwords
    valid = ~((qhi == -1) & (qlo == -1))
    qh, ql = qhi[valid], qlo[valid]
    rows = probe_rows(qhi, blo, nbits, span, tile_q)[valid]
    urows, inv = torch.unique(rows, return_inverse=True)
    reach = inv.new_zeros(urows.shape[0])     # pairs of each row's longest scan
    hits = [inv.new_zeros(0)]
    for a in range(0, qh.shape[0], block):
        u = inv[a:a + block]
        k = table[rows[a:a + block], :cap * slot_w].reshape(-1, cap, slot_w)
        hit = (k[:, :, 0] == qh[a:a + block, None]) \
            & (k[:, :, 1] == ql[a:a + block, None])
        # keys are distinct and fill from slot 0: a scan ends at its hit or
        # at the first empty slot, reading that slot's pair, else at cap
        end = hit | ((k[:, :, 0] == -1) & (k[:, :, 1] == -1))
        n = torch.where(end.any(dim=1), end.to(torch.int8).argmax(dim=1) + 1,
                        cap)
        reach.scatter_reduce_(0, u, n, "amax")
        got = hit.any(dim=1)
        hits.append(u[got] * cap + hit.to(torch.int8).argmax(dim=1)[got])
    return 8 * int(reach.sum()) \
        + 4 * nwords * torch.unique(torch.cat(hits)).numel()


def probe_sorted_plain(qhi, qlo, blo, table, nbits: int, cap: int,
                       nwords: int, span: int, tile_q: int) -> torch.Tensor:
    """Plain torch version of probe_sorted: the clamped row per query,
    gathered, then matched."""
    row = probe_rows(qhi, blo, nbits, span, tile_q)
    return match_slots(table[row], qhi, qlo, cap, nwords)


# ---------------------------------------------------------------------------
# fused_popcount_colsums
# ---------------------------------------------------------------------------

def fused_popcount_colsums(rows: torch.Tensor, ngenomes: int):
    """rows int32 [P, W] -> (popc int32 [P]: set bits of each row, colsums
    int32 [ngenomes]: rows with genome bit g set, for g < ngenomes <= 32W).
    Mask rows have no bits at or past ngenomes, so popc counts genomes."""
    _need(rows, torch.int32, 2, "fused_popcount_colsums rows")
    P, W = rows.shape
    if not 0 <= ngenomes <= 32 * W:
        raise ValueError(f"fused_popcount_colsums: ngenomes={ngenomes}, W={W}")
    if not _on_card(rows):
        return fused_popcount_colsums_plain(rows, ngenomes)
    dev = rows.device
    popc = torch.empty(P, dtype=torch.int32, device=dev)
    colsums = torch.zeros(ngenomes, dtype=torch.int32, device=dev)
    _popcount_colsums_into(rows, ngenomes, popc, colsums)
    return popc, colsums


def _popcount_colsums_into(rows, ngenomes: int, popc, colsums):
    """Launch the kernel on rows [P, W] into popc [P] and the zeroed
    colsums [ngenomes], contiguous int32 tensors of the rows' card."""
    P, W = rows.shape
    dev = rows.device
    _need(popc, torch.int32, 1, "fused_popcount_colsums popc")
    _need(colsums, torch.int32, 1, "fused_popcount_colsums colsums")
    if popc.shape[0] != P or colsums.shape[0] != ngenomes \
            or not _on_card(rows, popc, colsums):
        raise ValueError(f"fused_popcount_colsums: outputs {tuple(popc.shape)} "
                         f"{tuple(colsums.shape)} for P={P}, N={ngenomes}")
    smem = 8 * 32 * W * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_popcount_colsums: W={W} needs {smem} B of "
                         f"shared memory, over {_SMEM_LIMIT}")
    if P:
        rc = _lib().pg_popcount_colsums(rows.data_ptr(), P, W, ngenomes,
                                        popc.data_ptr(), colsums.data_ptr(),
                                        _POPC_MAX_BLOCKS, _stream(dev))
        _launched("fused_popcount_colsums", rc, dev)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def fused_popcount_colsums_plain(rows, ngenomes: int):
    """Plain torch version of fused_popcount_colsums."""
    r = u32(rows)
    popc = _popcount32(r).sum(dim=1)
    cols = [((r[:, g // 32] >> (g % 32)) & 1).sum() for g in range(ngenomes)]
    colsums = torch.stack(cols) if cols else r.new_zeros(0)
    return popc.to(torch.int32), colsums.to(torch.int32)


# ---------------------------------------------------------------------------
# masks_to_bytes
# ---------------------------------------------------------------------------

def masks_to_bytes(rows: torch.Tensor, nbytes: int | None = None
                   ) -> torch.Tensor:
    """rows int32 [P, W] -> uint8 [P, nbytes]: each row's words as
    little-endian bytes, truncated to nbytes <= 4W (all 4W by default, as
    panagram_tpu.ops.anchor.masks_to_bytes)."""
    _need(rows, torch.int32, 2, "masks_to_bytes rows")
    P, W = rows.shape
    if nbytes is None:
        nbytes = 4 * W
    if not 0 <= nbytes <= 4 * W:
        raise ValueError(f"masks_to_bytes: nbytes={nbytes}, W={W}")
    if not _on_card(rows):
        return masks_to_bytes_plain(rows, nbytes)
    out = torch.empty(P, nbytes, dtype=torch.uint8, device=rows.device)
    _masks_to_bytes_into(rows, out)
    return out


def _masks_to_bytes_into(rows, out):
    """Launch the kernel on rows [P, W] into out, a contiguous uint8
    [P, nbytes] tensor of the rows' card."""
    P, W = rows.shape
    _need(out, torch.uint8, 2, "masks_to_bytes out")
    nbytes = out.shape[1]
    if out.shape[0] != P or nbytes > 4 * W or not _on_card(rows, out):
        raise ValueError(f"masks_to_bytes: out {tuple(out.shape)} for "
                         f"rows {tuple(rows.shape)}")
    if P and nbytes:
        rc = _lib().pg_masks_to_bytes(rows.data_ptr(), P, W, nbytes,
                                      out.data_ptr(), _stream(rows.device))
        _launched("masks_to_bytes", rc, rows.device)


def masks_to_bytes_plain(rows, nbytes: int) -> torch.Tensor:
    """Plain torch version of masks_to_bytes: shifts of the u32 words."""
    r = u32(rows)
    cols = [((r[:, b // 4] >> (8 * (b % 4))) & 0xFF) for b in range(nbytes)]
    if not cols:
        return torch.zeros(rows.shape[0], 0, dtype=torch.uint8,
                           device=rows.device)
    return torch.stack(cols, dim=1).to(torch.uint8)


# ---------------------------------------------------------------------------
# mosaic_probe
# ---------------------------------------------------------------------------

def mosaic_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b int32 [n] (u32 bits) -> int32 [n, 4]: per element the u32
    product a*b, the rolled a[(i+1) % n], the 16x32 product
    (a >> 16) * (b & 0xFFFF), and a < b (unsigned) ? product : rolled."""
    _need(a, torch.int32, 1, "mosaic_probe a")
    _need(b, torch.int32, 1, "mosaic_probe b")
    if a.shape != b.shape:
        raise ValueError(f"mosaic_probe: a {tuple(a.shape)} != b {tuple(b.shape)}")
    if not _on_card(a, b):
        return mosaic_probe_plain(a, b)
    dev = a.device
    n = a.shape[0]
    out = torch.empty(n, 4, dtype=torch.int32, device=dev)
    if n:
        rc = _lib().pg_mosaic_probe(a.data_ptr(), b.data_ptr(), n,
                                    out.data_ptr(), _stream(dev))
        _launched("mosaic_probe", rc, dev)
    return out


def mosaic_probe_plain(a, b) -> torch.Tensor:
    """Plain torch version of mosaic_probe on int32 bit patterns: products
    in int64 (which wraps like u64, so the low 32 bits are exact), the
    unsigned compare as a signed one after XOR with 0x80000000."""
    x, y = u32(a), u32(b)
    prod = to_i32((x * y) & 0xFFFFFFFF)
    rolled = torch.roll(a, -1)
    hi16 = to_i32((x >> 16) * (y & 0xFFFF))
    sign = torch.iinfo(torch.int32).min
    cmp = torch.where((a ^ sign) < (b ^ sign), prod, rolled)
    return torch.stack([prod, rolled, hi16, cmp], dim=1)


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def bound_bytes(name: str, **shape) -> int:
    """The bytes the function `name` must move at a shape: each input read
    once, each output written once, and of a table only what the queries
    need.  Pure arithmetic on the shape:

    pack_bases             L (L in, ceil(L/4) + ceil(L/8) out)
    pack_mix               L, k, Ppad
    probe_sorted           Q, nwords, tile_q, table_bytes (the table bytes
                           these queries need: probe_need_bytes)
    fused_popcount_colsums P, W, ngenomes
    masks_to_bytes         P, W, nbytes
    mosaic_probe           n
    """
    g = shape.__getitem__
    if name == "pack_bases":
        return g("L") + -(-g("L") // 4) + -(-g("L") // 8)
    if name == "pack_mix":
        return -(-g("L") // 4) + -(-g("L") // 8) + 8 * g("Ppad")
    if name == "probe_sorted":
        Q = g("Q")
        return (8 * Q + 4 * -(-Q // g("tile_q")) + 4 * g("nwords") * Q
                + g("table_bytes"))
    if name == "fused_popcount_colsums":
        return 4 * g("P") * g("W") + 4 * g("P") + 4 * g("ngenomes")
    if name == "masks_to_bytes":
        return 4 * g("P") * g("W") + g("P") * g("nbytes")
    if name == "mosaic_probe":
        return 8 * g("n") + 16 * g("n")
    raise KeyError(name)
