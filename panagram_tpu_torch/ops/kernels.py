"""The four device kernels of the anchor chunk, with their plain versions.

Each wrapper here replaces one Pallas TPU kernel of
``panagram_tpu/ops/pallas_kernels.py``:

=========================  ===============================  ==================
wrapper                    TPU kernel                       CUDA source
=========================  ===============================  ==================
pack_mix                   pack_mix_pallas                  csrc/pack_mix.cu
probe_sorted               probe_sorted                     csrc/probe_sorted.cu
fused_popcount_colsums     fused_popcount_colsums           csrc/popcount_colsums.cu
masks_to_bytes             masks_to_bytes_pallas            csrc/masks_to_bytes.cu
=========================  ===============================  ==================

On a CUDA tensor a wrapper launches its hand-written kernel (built by
``panagram_tpu_torch._build`` at first use, called through ctypes on
torch's current stream) and adds one to ``launches[name]``; a refused
launch raises.  On a CPU tensor it runs the plain torch version
beside it, which is the specification the kernel is tested against.  Any
other device raises.  Each source file notes what bounds its kernel on the
card and what its design does about that.

u32 data travels as int32 tensors holding the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from .codec import SENTINEL, mix64, split64, srl, u32

# kernel launches on the card since the last reset_launches(), by wrapper
launches = {"pack_mix": 0, "probe_sorted": 0, "fused_popcount_colsums": 0,
            "masks_to_bytes": 0}

# grid cap of the column-sum kernel: blocks loop over rows beyond it
_POPC_MAX_BLOCKS = 132 * 8
_SMEM_LIMIT = 48 * 1024

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    "pg_pack_mix": [_P, _I64, _P, _I64, _I32, _I64, _I64, _P, _P, _P],
    "pg_probe_sorted": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                        _I32, _P, _P],
    "pg_popcount_colsums": [_P, _I64, _I32, _I32, _P, _P, _I32, _P],
    "pg_masks_to_bytes": [_P, _I64, _I32, _I32, _P, _P],
}
_lib_handle = None


def _lib():
    global _lib_handle
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
    launches[name] += 1


def _stream(device) -> _P:
    return _P(torch.cuda.current_stream(device).cuda_stream)


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
    if Ppad:
        rc = _lib().pg_pack_mix(packed.data_ptr(), packed.numel(),
                                nmask.data_ptr(), nmask.numel(), k, L - k + 1,
                                Ppad, hi.data_ptr(), lo.data_ptr(),
                                _stream(dev))
        _launched("pack_mix", rc, dev)
    return hi, lo


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
    holding its (hi, lo) pair, or 0."""
    Q = qhi.shape[0]
    B, stride = table.shape
    if not 1 <= nbits <= 32 or B != 1 << nbits or cap * (2 + nwords) > stride \
            or not 1 <= span <= B or blo.shape[0] * tile_q < Q:
        raise ValueError(f"probe_sorted: nbits={nbits} table={tuple(table.shape)} "
                         f"cap={cap} W={nwords} span={span} tile_q={tile_q} "
                         f"Q={Q} tiles={blo.shape[0]}")
    for t, what in ((qhi, "qhi"), (qlo, "qlo"), (blo, "blo")):
        _need(t, torch.int32, 1, f"probe_sorted {what}")
    _need(table, torch.int32, 2, "probe_sorted table")
    if not _on_card(qhi, qlo, blo, table):
        return probe_sorted_plain(qhi, qlo, blo, table, nbits, cap, nwords,
                                  span, tile_q)
    dev = qhi.device
    out = torch.empty(Q, nwords, dtype=torch.int32, device=dev)
    if Q:
        rc = _lib().pg_probe_sorted(qhi.data_ptr(), qlo.data_ptr(),
                                    blo.data_ptr(), table.data_ptr(), Q, nbits,
                                    cap, nwords, stride, span, tile_q,
                                    out.data_ptr(), _stream(dev))
        _launched("probe_sorted", rc, dev)
    return out


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


def probe_sorted_plain(qhi, qlo, blo, table, nbits: int, cap: int,
                       nwords: int, span: int, tile_q: int) -> torch.Tensor:
    """Plain torch version of probe_sorted: the clamped row per query,
    gathered, then matched."""
    Q = qhi.shape[0]
    b0 = blo.to(torch.int64)[torch.arange(Q, device=qhi.device) // tile_q]
    bucket = u32(qhi) >> (32 - nbits)
    row = b0 + torch.clamp(bucket - b0, 0, span - 1)
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
    smem = 8 * 32 * W * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_popcount_colsums: W={W} needs {smem} B of "
                         f"shared memory, over {_SMEM_LIMIT}")
    if P:
        rc = _lib().pg_popcount_colsums(rows.data_ptr(), P, W, ngenomes,
                                        popc.data_ptr(), colsums.data_ptr(),
                                        _POPC_MAX_BLOCKS, _stream(dev))
        _launched("fused_popcount_colsums", rc, dev)
    return popc, colsums


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

def masks_to_bytes(rows: torch.Tensor, nbytes: int) -> torch.Tensor:
    """rows int32 [P, W] -> uint8 [P, nbytes]: each row's words as
    little-endian bytes, truncated to nbytes <= 4W."""
    _need(rows, torch.int32, 2, "masks_to_bytes rows")
    P, W = rows.shape
    if not 0 <= nbytes <= 4 * W:
        raise ValueError(f"masks_to_bytes: nbytes={nbytes}, W={W}")
    if not _on_card(rows):
        return masks_to_bytes_plain(rows, nbytes)
    dev = rows.device
    out = torch.empty(P, nbytes, dtype=torch.uint8, device=dev)
    if P and nbytes:
        rc = _lib().pg_masks_to_bytes(rows.data_ptr(), P, W, nbytes,
                                      out.data_ptr(), _stream(dev))
        _launched("masks_to_bytes", rc, dev)
    return out


def masks_to_bytes_plain(rows, nbytes: int) -> torch.Tensor:
    """Plain torch version of masks_to_bytes: shifts of the u32 words."""
    r = u32(rows)
    cols = [((r[:, b // 4] >> (8 * (b % 4))) & 0xFF) for b in range(nbytes)]
    if not cols:
        return torch.zeros(rows.shape[0], 0, dtype=torch.uint8,
                           device=rows.device)
    return torch.stack(cols, dim=1).to(torch.uint8)
