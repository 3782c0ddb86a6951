"""Pan-genome k-mer dictionary: sorted u64 keys -> N-bit presence masks.

Genome g contributes bit (g % 32) of mask word (g // 32).  The merge sorts
the concatenated per-genome key sets on the device and adds each genome's
one-hot word into its key's segment; every (key, genome) pair occurs once,
so the integer sum is the OR and does not depend on order.  The same merge
serves the mesh's range shards (parallel/shard.py).

``PanKmerDict`` saves and loads the ``pandict.npz`` format of
``panagram_tpu.ops.dictionary`` unchanged, so either package reads the
other's dictionary.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zipfile

import numpy as np
import torch

from .. import spans
from .codec import SIGN64, from_u64_np, u64_np

# rows per pairwise block: entries of one block's product are <= 2^20 < 2^24,
# so float32 holds every partial sum exactly
PAIRWISE_BLOCK = 1 << 20


def _merge_sets(pairs: list, nwords: int):
    """[keys int64 [T], genome ids int32 [T]] -> (distinct keys int64 [D]
    in unsigned order, masks int32 [D, W] holding u32 bits): each pair's
    one-hot word added into its key's row, which is the OR because every
    (key, genome) pair occurs once.  Keys are any u64 bit patterns
    (canonical k-mers, mixed keys, SENTINEL): they sort through the flip
    of codec.flip64.

    The sort's moment is the peak, about 52 bytes per pair on a CUDA
    device (keys 8, ids 4, sorted keys 8, order 8, the radix sort's index
    input and spare buffers 24), so nothing else is alive then and nothing
    wide after: the list is emptied and its tensors consumed (the keys are
    flipped in place), each tensor is dropped once spent, the segment ids
    and the scatter index are int32 while they fit, and the words are
    added by index_add_, which sorts nothing."""
    keys, gids = pairs
    pairs.clear()
    T = keys.shape[0]
    srt, order = torch.sort(keys.bitwise_xor_(SIGN64))   # flip64 in place
    del keys
    g = gids[order]
    del gids, order
    ks = srt.bitwise_xor_(SIGN64)
    del srt
    is_start = torch.ones(T, dtype=torch.bool, device=ks.device)
    torch.ne(ks[1:], ks[:-1], out=is_start[1:])
    out = ks[is_start]
    del ks
    D = out.shape[0]
    narrow = max(T, D * nwords) < 1 << 31
    # torch.cumsum of an integer tensor gives int64 unless told otherwise
    seg = torch.cumsum(is_start, 0,
                       dtype=torch.int32 if narrow else torch.int64)
    del is_start
    flat = seg.sub_(1).mul_(nwords).add_(g >> 5)
    del seg
    # int32 1 << 31 is the sign bit: the same u32 bits, and distinct bits
    # never carry
    word = torch.ones_like(g).bitwise_left_shift_(g.bitwise_and_(31))
    del g
    masks = torch.zeros(D * nwords, dtype=torch.int32, device=out.device)
    masks.index_add_(0, flat, word)
    return out, masks.view(D, nwords)


def merge_sets_bytes(pairs: int, nwords: int) -> int:
    """Device bytes _merge_sets holds at its peak for `pairs` (key, genome)
    pairs of nwords mask words: the sort's moment (52 B per pair), or,
    when the masks are wide, the end, where the keys out (8 B per key,
    at most one per pair), the segment ids (at most 8: int64 where int32
    does not hold them), the one-hot words (4) and the masks (4W per key)
    are alive."""
    return max(52, 20 + 4 * nwords) * pairs


def npz_member(path: str, name: str, mmap: bool = False) -> np.ndarray:
    """Array `name` of the .npz at `path`.  With mmap=True a member stored
    uncompressed (np.savez's) is mapped read-only where it lies in the
    archive, so that slicing it reads only the slice's pages; a compressed
    or empty member is loaded whole."""
    if mmap:
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo(name + ".npy")
        if info.compress_type == zipfile.ZIP_STORED:
            with open(path, "rb") as f:
                f.seek(info.header_offset + 26)
                n_name, n_extra = struct.unpack("<HH", f.read(4))
                f.seek(n_name + n_extra, os.SEEK_CUR)
                fmt = np.lib.format
                read = {(1, 0): fmt.read_array_header_1_0,
                        (2, 0): fmt.read_array_header_2_0}.get(
                            fmt.read_magic(f))
                if read is not None:
                    shape, fortran, dtype = read(f)
                    offset = f.tell()
            if read is not None and int(np.prod(shape)) > 0:
                return np.memmap(path, dtype, "r", offset, shape,
                                 "F" if fortran else "C")
    with np.load(path) as z:
        return z[name]


@dataclasses.dataclass
class PanKmerDict:
    """Host mirror of the pan-kmer dictionary.

    keys:  sorted distinct keys, numpy uint64 [D] -- canonical k-mers
           (key_space "canon") or their splitmix64 mixes ("mixed")
    masks: presence masks, numpy uint32 [D, W], W = ceil(ngenomes/32)
    """

    keys: np.ndarray
    masks: np.ndarray
    ngenomes: int
    k: int
    key_space: str = "canon"

    @property
    def nwords(self) -> int:
        return self.masks.shape[1]

    @property
    def nbytes_row(self) -> int:
        """Bitmap bytes per anchor position: ceil(ngenomes / 8)."""
        return (self.ngenomes + 7) // 8

    def __len__(self):
        return len(self.keys)

    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, keys=self.keys, masks=self.masks,
                     ngenomes=self.ngenomes, k=self.k,
                     key_space=self.key_space)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, mmap: bool = False) -> "PanKmerDict":
        """The dictionary saved at `path`; mmap=True maps keys and masks
        read-only (npz_member) for a reader that slices them."""
        with np.load(path) as z:
            key_space = str(z["key_space"]) if "key_space" in z else "canon"
            ngenomes, k = int(z["ngenomes"]), int(z["k"])
        return cls(npz_member(path, "keys", mmap),
                   npz_member(path, "masks", mmap), ngenomes, k, key_space)

    def pairwise_shared(self, block: int = PAIRWISE_BLOCK, *,
                        device="cuda") -> np.ndarray:
        """Genome x genome shared-distinct-kmer counts, int64 [N, N]: the
        sum over row blocks of bits^T @ bits, in float32 (exact, see
        PAIRWISE_BLOCK) on `device`, accumulated in int64."""
        n = self.ngenomes
        out = torch.zeros(n, n, dtype=torch.int64, device=device)
        shifts = torch.arange(32, dtype=torch.int64, device=device)
        for s in range(0, len(self.keys), block):
            m = torch.from_numpy(
                np.ascontiguousarray(self.masks[s:s + block]).view(np.int32))
            m = m.to(device).to(torch.int64) & 0xFFFFFFFF
            bits = ((m[:, :, None] >> shifts) & 1).reshape(m.shape[0], -1)
            bits = bits[:, :n].to(torch.float32)
            out += (bits.T @ bits).to(torch.int64)
        return out.cpu().numpy()


def build_dictionary(genome_sets: list[np.ndarray], k: int,
                     ngenomes: int | None = None, *,
                     device="cuda") -> PanKmerDict:
    """Merge per-genome sorted distinct key sets (numpy uint64; list order
    = genome id) into a PanKmerDict, on `device`.  Spans
    (panagram_tpu_torch.spans), timed on the card: dict.upload (the sets),
    dict.merge, dict.readback (keys and masks)."""
    N = ngenomes if ngenomes is not None else len(genome_sets)
    W = (N + 31) // 32
    total = int(sum(len(s) for s in genome_sets))
    if total == 0:
        return PanKmerDict(np.zeros(0, np.uint64), np.zeros((0, W), np.uint32),
                           N, k)
    cuda = torch.device(device).type == "cuda"
    # one buffer filled set by set: a concatenation would hold every set
    # twice
    with spans.span("dict.upload", device=cuda):
        keys = torch.empty(total, dtype=torch.int64, device=device)
        gids = torch.empty(total, dtype=torch.int32, device=device)
        off = 0
        for g, s in enumerate(genome_sets):
            keys[off:off + len(s)] = from_u64_np(s, device)
            gids[off:off + len(s)] = g
            off += len(s)
    pairs = [keys, gids]
    del keys, gids
    with spans.span("dict.merge", device=cuda):
        out_keys, masks = _merge_sets(pairs, W)
    with spans.span("dict.readback", device=cuda):
        return PanKmerDict(u64_np(out_keys),
                           masks.cpu().numpy().view(np.uint32), N, k)
