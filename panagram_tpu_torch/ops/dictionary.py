"""Pan-genome k-mer dictionary: sorted u64 keys -> N-bit presence masks.

Genome g contributes bit (g % 32) of mask word (g // 32).  The merge sorts
the concatenated per-genome key sets on the device and adds each genome's
one-hot word into its key's segment; every (key, genome) pair occurs once,
so the integer sum is the OR and does not depend on order.

``PanKmerDict`` saves and loads the ``pandict.npz`` format of
``panagram_tpu.ops.dictionary`` unchanged, so either package reads the
other's dictionary.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .codec import from_u64_np, u64_np

# rows per pairwise block: entries of one block's product are <= 2^20 < 2^24,
# so float32 holds every partial sum exactly
PAIRWISE_BLOCK = 1 << 20


def _merge_sets(keys: torch.Tensor, gids: torch.Tensor, nwords: int):
    """keys int64 [T] (canonical, < 2^62), gids int64 [T] -> (distinct
    sorted keys int64 [D], masks int64 [D, W] holding u32 values)."""
    keys_s, order = torch.sort(keys)
    g = gids[order]
    is_start = torch.ones_like(keys_s, dtype=torch.bool)
    is_start[1:] = keys_s[1:] != keys_s[:-1]
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    out_keys = keys_s[is_start]
    masks = torch.zeros(out_keys.shape[0], nwords, dtype=torch.int64,
                        device=keys.device)
    masks.index_put_((seg, g // 32), torch.ones_like(g) << (g % 32),
                     accumulate=True)
    return out_keys, masks


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
    def load(cls, path: str) -> "PanKmerDict":
        z = np.load(path)
        key_space = str(z["key_space"]) if "key_space" in z else "canon"
        return cls(z["keys"], z["masks"], int(z["ngenomes"]), int(z["k"]),
                   key_space)

    def pairwise_shared(self, device="cpu",
                        block: int = PAIRWISE_BLOCK) -> np.ndarray:
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
                     ngenomes: int | None = None,
                     device="cpu") -> PanKmerDict:
    """Merge per-genome sorted distinct key sets (numpy uint64; list order
    = genome id) into a PanKmerDict, on `device`."""
    N = ngenomes if ngenomes is not None else len(genome_sets)
    W = (N + 31) // 32
    total = int(sum(len(s) for s in genome_sets))
    if total == 0:
        return PanKmerDict(np.zeros(0, np.uint64), np.zeros((0, W), np.uint32),
                           N, k)
    keys = torch.cat([from_u64_np(s, device) for s in genome_sets])
    gids = torch.cat([torch.full((len(s),), g, dtype=torch.int64,
                                 device=device)
                      for g, s in enumerate(genome_sets)])
    out_keys, masks = _merge_sets(keys, gids, W)
    return PanKmerDict(u64_np(out_keys),
                       masks.cpu().numpy().astype(np.uint32), N, k)
