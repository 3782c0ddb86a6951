"""Canonical k-mers, the presence-mask dictionary and the anchored answers,
written from the index's definition (docs/FORMAT.md of this repository):

* bases are 2-bit codes A=0, C=1, G=2, T=3; any other code is an N, and a
  window that holds one has no k-mer and an all-zero presence row;
* a k-mer packs into 2k bits with its first base most significant; its
  canonical form is the smaller of it and its reverse complement;
* genome g sets bit g % 32 of mask word g // 32;
* a position's bitmap bytes are its words' little-endian bytes,
  concatenated and cut to ceil(N / 8); its popcount counts the set bits;
  a chunk's column sum of genome g counts its positions with bit g set.

Plain torch, on any device; the benchmark runs it on the card once the
window has closed and the program's state is freed.
"""

from __future__ import annotations

import torch

_POP8 = [bin(i).count("1") for i in range(256)]


def kmer_words(codes: torch.Tensor, k: int, canonical: bool = True):
    """codes uint8 [L] -> (k-mer words int64 [L - k + 1], valid bool): the
    canonical words, or with canonical=False the forward ones."""
    n = codes.shape[0] - k + 1
    dev = codes.device
    if n <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    c = codes.to(torch.int64)
    fwd = torch.zeros(n, dtype=torch.int64, device=dev)
    rc = torch.zeros(n, dtype=torch.int64, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(k):
        ci = c[i:i + n]
        valid &= (ci >= 0) & (ci < 4)
        b = ci & 3
        fwd = fwd * 4 + b
        rc = rc + ((3 - b) << (2 * i))
    return (torch.minimum(fwd, rc) if canonical else fwd), valid


def kmer_set(codes: torch.Tensor, k: int, canonical: bool = True):
    """Sorted distinct k-mer words of one genome's codes."""
    words, valid = kmer_words(codes, k, canonical)
    return torch.unique(words[valid])


def union_keys(sets) -> torch.Tensor:
    """Sorted distinct keys over the genomes' sets."""
    return torch.unique(torch.cat(list(sets)))


def _bit(b: int) -> int:
    """Bit b of an int32 word as an int32 value."""
    return (1 << b) - (1 << 32 if b == 31 else 0)


def masks(keys: torch.Tensor, sets, order=None) -> torch.Tensor:
    """Presence masks int32 [D, W] of the sorted `keys`: column g is genome
    order[g]'s set (order None: set g)."""
    n = len(order) if order is not None else len(sets)
    out = torch.zeros(keys.shape[0], (n + 31) // 32, dtype=torch.int32,
                      device=keys.device)
    for g in range(n):
        s = sets[order[g] if order is not None else g]
        idx = torch.searchsorted(keys, s)
        out[idx, g // 32] |= _bit(g % 32)
    return out


def rows(words: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """Presence rows int32 [P, W] of the k-mer words: the key's mask where
    the word is a key and valid, else 0."""
    if keys.shape[0] == 0:
        return mask.new_zeros(words.shape[0], mask.shape[1])
    idx = torch.searchsorted(keys, words).clamp_(max=keys.shape[0] - 1)
    hit = valid & (keys[idx] == words)
    return mask[idx] * hit[:, None].to(torch.int32)


def row_bytes(r: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes uint8 [P, 4W] of rows int32 [P, W]."""
    parts = [((r[:, w] >> (8 * b)) & 0xFF) for w in range(r.shape[1])
             for b in range(4)]
    return torch.stack(parts, 1).to(torch.uint8)


def popcount(by: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of bytes uint8 [P, B] -> int32 [P]."""
    pop = torch.tensor(_POP8, dtype=torch.int32, device=by.device)
    return pop[by.to(torch.int64)].sum(1, dtype=torch.int32)


def column_sums(r: torch.Tensor, ngenomes: int) -> torch.Tensor:
    """Rows with bit g set, for g < ngenomes: int64 [ngenomes]."""
    return torch.stack([((r[:, g // 32] >> (g % 32)) & 1).sum()
                        for g in range(ngenomes)]).to(torch.int64)
