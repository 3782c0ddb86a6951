"""Pure-numpy reference implementation of the k-mer engine.

A copy of panagram_tpu.ops.ref_impl that imports no jax, so it also runs
where only torch and numpy are installed.  It is the correctness oracle for
the device path: a direct, slow,
obviously-correct restatement of what KMC + the reference anchoring pipeline
compute (reference panagram/index.py:932-969 and cpp/anchor.cpp:112-195):

* canonical k-mer at position p = min(packed forward, packed revcomp) under
  2-bit A=0,C=1,G=2,T=3 encoding with the first base most significant
  (KMC's canonical form);
* any window containing a non-ACGT base yields no k-mer (counter 0 /
  presence mask 0 — KMC GetCountersForRead semantics);
* the pan-genome dictionary maps each canonical k-mer to an N-bit presence
  mask, bit g set iff genome g contains that k-mer.
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import seq_to_codes


def canonical_kmers_np(seq: str | np.ndarray, k: int):
    """Return (canon: u64 array [L-k+1], valid: bool array)."""
    codes = seq_to_codes(seq) if not isinstance(seq, np.ndarray) else seq
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    valid = np.ones(n, bool)
    c64 = codes.astype(np.uint64)
    for i in range(k):
        ci = c64[i : i + n]
        fwd |= (ci & np.uint64(3)) << np.uint64(2 * (k - 1 - i))
        rc |= ((np.uint64(3) - ci) & np.uint64(3)) << np.uint64(2 * i)
        valid &= codes[i : i + n] < 4
    canon = np.minimum(fwd, rc)
    canon[~valid] = 0
    return canon, valid


def genome_kmer_set(fastas_or_seqs, k: int) -> np.ndarray:
    """Sorted distinct canonical k-mers over a list of sequences."""
    chunks = []
    for seq in fastas_or_seqs:
        canon, valid = canonical_kmers_np(seq, k)
        chunks.append(canon[valid])
    if not chunks:
        return np.zeros(0, np.uint64)
    return np.unique(np.concatenate(chunks))


def build_dict_np(genome_sets: list[np.ndarray], nwords: int | None = None):
    """Merge per-genome sorted k-mer sets into (keys, masks).

    masks is uint32 [D, W] with W = ceil(N/32); bit g of word g//32 set iff
    genome g contains the key (the reference's one-hot + sum-union layout,
    panagram/index.py:391-426)."""
    ngenomes = len(genome_sets)
    W = nwords or (ngenomes + 31) // 32
    keys = np.unique(np.concatenate(genome_sets)) if genome_sets else np.zeros(0, np.uint64)
    masks = np.zeros((len(keys), W), np.uint32)
    for g, s in enumerate(genome_sets):
        idx = np.searchsorted(keys, s)
        masks[idx, g // 32] |= np.uint32(1 << (g % 32))
    return keys, masks


def anchor_np(seq, k: int, keys: np.ndarray, masks: np.ndarray):
    """Presence-mask rows for every position of an anchor sequence."""
    canon, valid = canonical_kmers_np(seq, k)
    W = masks.shape[1] if masks.ndim == 2 else 1
    out = np.zeros((len(canon), W), np.uint32)
    if len(keys):
        idx = np.searchsorted(keys, canon)
        idx_c = np.clip(idx, 0, len(keys) - 1)
        hit = valid & (keys[idx_c] == canon)
        out[hit] = masks[idx_c[hit]]
    return out


def masks_to_bytes_np(masks: np.ndarray, nbytes: int) -> np.ndarray:
    """uint32 mask words -> little-endian bytes, truncated to nbytes
    (the reference's per-DB byte-slice layout, panagram/index.py:937-947)."""
    le = masks.astype("<u4").view(np.uint8).reshape(masks.shape[0], -1)
    return le[:, :nbytes]


def popcount_np(masks: np.ndarray) -> np.ndarray:
    return np.unpackbits(
        masks.astype("<u4").view(np.uint8), axis=-1, bitorder="little"
    ).sum(axis=-1).astype(np.int64)
