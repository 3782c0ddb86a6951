"""The card's peaks and the least bytes an anchor chunk must move.

Peaks: NVIDIA's data sheet for the H100 SXM5 80 GB (HBM3), at its full
power limit of 700 W; the harness prints the card's own limit beside the
numbers.  The anchor chunk's work is integer work bound by memory, so its
roofline is bytes over the memory rate.

The least bytes are counted from the chunk's inputs, each value at the
fewest whole bytes that hold it, the same whatever implements them.  The
arithmetic is the benchmark's own, not a copy: the program's counts,
``ops.kernels.bound_bytes`` and ``probe_need_bytes``
(panagram_tpu_torch/ops/kernels.py at commit 299c73b), charge its present
kernels' layout and would go stale with a redesign.  The count:

1. in: 2 bits per base and one validity bit per base, for the chunk's
   m + k - 1 bases;
2. the dictionary: each distinct canonical k-mer of the chunk, its key of
   2k bits, and, where it is in the dictionary, its N presence bits;
3. out: each position's ceil(N/8) bitmap bytes and its popcount (a count
   up to N), and the chunk's N column sums (counts up to m).
"""

from __future__ import annotations

# HBM3 bytes per second of one H100 SXM5 80 GB
PEAK_BYTES_PER_S = 3.35e12


def nbytes(bits: int) -> int:
    """The whole bytes that hold `bits` bits."""
    return -(-bits // 8)


def count_bytes(most: int) -> int:
    """The whole bytes that hold a count from 0 to `most`."""
    return nbytes(most.bit_length())


def anchor_chunk_least_bytes(m: int, k: int, distinct: int, hits: int,
                             ngenomes: int) -> int:
    """Least bytes of one anchor chunk of m positions: `distinct` distinct
    canonical k-mers, `hits` of them in the dictionary of ngenomes
    genomes."""
    bases = m + k - 1
    inp = nbytes(2 * bases) + nbytes(bases)
    row = nbytes(ngenomes)
    table = nbytes(2 * k) * distinct + row * hits
    out = m * (row + count_bytes(ngenomes)) + ngenomes * count_bytes(m)
    return inp + table + out
