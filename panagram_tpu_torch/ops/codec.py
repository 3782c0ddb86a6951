"""Canonical k-mer codec in torch, and the u64-as-int64 helpers.

Bases are 2-bit codes (A=0, C=1, G=2, T=3); a code >= 4 makes every window
that holds it invalid.  A k-mer packs into 2k bits with its first base most
significant, and its canonical form is min(forward, reverse complement).

torch has no shifts or ordered compares for uint32/uint64 on every backend,
so a u64 lives in an int64 tensor as the same bit pattern, under these
rules:

* a logical right shift is ``srl(x, s) = (x >> s) & ((1 << (64 - s)) - 1)``;
* int64 ``*`` wraps exactly as the u64 multiply does;
* canonical keys are < 2^62 (k <= 31), so signed order equals unsigned
  order for them; only the all-ones SENTINEL differs (it is -1 and sorts
  FIRST under signed order);
* mixed keys use all 64 bits, so they sort on ``flip64(x) = x ^ (1 << 63)``,
  whose signed order is the unsigned order of x and which sends the
  SENTINEL to INT64_MAX, the tail (``sort_u64``);
* a u32 lives in an int32 tensor the same way; ``u32(x)`` widens it to an
  int64 holding the unsigned value.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_K = 31

# the all-ones u64 as an int64 bit pattern
SENTINEL = -1
# bit 63 as an int64: x ^ SIGN64 maps unsigned order onto signed order
SIGN64 = torch.iinfo(torch.int64).min

# splitmix64 finalizer constants
MIX_M1 = 0xBF58476D1CE4E5B9
MIX_M2 = 0x94D049BB133111EB


def check_k(k: int):
    if not (1 <= k <= MAX_K):
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def as_signed64(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a constant 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 tensor of the unsigned values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def split64(x: torch.Tensor):
    """int64 u64 patterns -> (hi, lo) int32 u32 patterns."""
    return to_i32(srl(x, 32)), to_i32(x & 0xFFFFFFFF)


def u64_np(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array of the same bits (host copy)."""
    return x.detach().cpu().numpy().view(np.uint64)


def from_u64_np(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor of the same bits on `device`."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    if not a.flags.writeable:       # e.g. np.load of an npz member
        a = a.copy()
    return torch.from_numpy(a.view(np.int64)).to(device)


def upload_codes(codes: np.ndarray, device) -> torch.Tensor:
    """numpy uint8 codes -> uint8 tensor on `device`.  On a CUDA device
    through a page-locked block of torch's caching host allocator and a
    copy that does not wait for the card's queued work (the allocator
    reuses the block once the copy is done); elsewhere a tensor over the
    array itself."""
    codes = np.ascontiguousarray(codes, np.uint8)
    if torch.device(device).type != "cuda":
        return torch.from_numpy(codes).to(device)
    host = torch.empty(len(codes), dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = codes
    return host.to(device, non_blocking=True)


def flip64(x: torch.Tensor) -> torch.Tensor:
    """int64 u64 patterns -> int64 whose signed order is the unsigned order
    of x (the map is its own inverse)."""
    return x ^ SIGN64


def sort_u64(x: torch.Tensor) -> torch.Tensor:
    """int64 u64 patterns sorted in unsigned order (SENTINELs last)."""
    return flip64(torch.sort(flip64(x)).values)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (int64 * wraps as u64)."""
    x = x ^ srl(x, 30)
    x = x * as_signed64(MIX_M1)
    x = x ^ srl(x, 27)
    x = x * as_signed64(MIX_M2)
    return x ^ srl(x, 31)


def pack_kmers(codes: torch.Tensor, k: int):
    """codes uint8 [L] (0-3 valid, >= 4 invalid) -> (canon int64 [L-k+1],
    valid bool [L-k+1]); an invalid window's canon is SENTINEL.

    The forward word shifts each base in from the right; the reverse
    complement puts base i's complement at bits 2i.  k passes of
    elementwise ops over the sequence, all on the codes' device."""
    check_k(k)
    n = codes.shape[0] - k + 1
    if n <= 0:
        z = codes.new_zeros(0, dtype=torch.int64)
        return z, z.to(torch.bool)
    c = codes.to(torch.int64)
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    valid = torch.ones(n, dtype=torch.bool, device=codes.device)
    for i in range(k):
        ci = c[i:i + n]
        fwd = (fwd << 2) | (ci & 3)
        rc = rc | ((3 - (ci & 3)) << (2 * i))
        valid &= ci < 4
    canon = torch.minimum(fwd, rc)
    return torch.where(valid, canon, torch.full_like(canon, SENTINEL)), valid


def unpack_bases(packed: torch.Tensor, nmask: torch.Tensor,
                 L: int) -> torch.Tensor:
    """pack_bases_np's (packed uint8 [ceil(L/4)], nmask uint8 [ceil(L/8)])
    -> codes uint8 [L]: 0-3 for a valid base, 255 for an invalid one, as
    panagram_tpu.ops.codec.unpack_bases.  On the tensors' device."""
    p = packed.to(torch.int32)
    sh4 = torch.arange(0, 8, 2, dtype=torch.int32, device=packed.device)
    codes = ((p[:, None] >> sh4) & 3).reshape(-1)[:L]
    m = nmask.to(torch.int32)
    sh8 = torch.arange(8, dtype=torch.int32, device=nmask.device)
    bad = ((m[:, None] >> sh8) & 1).reshape(-1)[:L]
    return torch.where(bad == 1, 255, codes).to(torch.uint8)


def pack_kmers_packed(packed: torch.Tensor, nmask: torch.Tensor, L: int,
                      k: int):
    """Canonical k-mers of a 2-bit packed sequence (pack_bases_np's layout)
    -> (canon int64 [L-k+1], valid bool [L-k+1]), an invalid window's canon
    SENTINEL: panagram_tpu.ops.codec.pack_kmers_packed, here the unpack
    followed by pack_kmers."""
    return pack_kmers(unpack_bases(packed, nmask, L), k)


def canonical_kmers(codes, k: int, *, device="cuda"):
    """numpy uint8 codes -> numpy (canon uint64 with invalid windows zeroed,
    valid bool), the convention of panagram_tpu.ops.codec.canonical_kmers."""
    check_k(k)
    codes = np.asarray(codes, np.uint8)
    if codes.shape[0] < k:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    canon, valid = pack_kmers(torch.from_numpy(codes).to(device), k)
    canon = torch.where(valid, canon, torch.zeros_like(canon))
    return u64_np(canon), valid.cpu().numpy()


def pack_bases_np(codes: np.ndarray):
    """Host-side 2-bit packing: (packed u8 [ceil(L/4)] with 4 bases/byte
    little-endian, nmask u8 [ceil(L/8)] with bit i set when base i is
    non-ACGT, L).  The layout of panagram_tpu.ops.codec.pack_bases_np."""
    codes = np.asarray(codes, np.uint8)
    L = len(codes)
    invalid = codes >= 4
    c = np.where(invalid, 0, codes).astype(np.uint8)
    pad = (-L) % 4
    c4 = np.concatenate([c, np.zeros(pad, np.uint8)]).reshape(-1, 4)
    packed = (c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4) | (c4[:, 3] << 6))
    nmask = np.packbits(
        np.concatenate([invalid, np.zeros((-L) % 8, bool)]), bitorder="little"
    )
    return packed.astype(np.uint8), nmask, L
