"""Device operations: codec, counting, dictionary, table, kernels, anchoring.

The names of panagram_tpu.ops, under the port's dtype rules (ops/codec.py):
u64 keys as int64 bit patterns, u32 mask words as int32.
"""

from .anchor import (
    anchor_lookup,
    genome_column_sums,
    mask_popcount,
    occupancy_histogram,
)
from .codec import MAX_K, SENTINEL, canonical_kmers, pack_kmers
from .count import distinct_kmers, distinct_kmers_chunked
from .dictionary import PanKmerDict, build_dictionary
from .kernels import masks_to_bytes

__all__ = [
    "pack_kmers",
    "canonical_kmers",
    "SENTINEL",
    "MAX_K",
    "distinct_kmers",
    "distinct_kmers_chunked",
    "build_dictionary",
    "PanKmerDict",
    "anchor_lookup",
    "masks_to_bytes",
    "mask_popcount",
    "occupancy_histogram",
    "genome_column_sums",
]
