"""Host I/O: FASTA reading, BGZF writing and reading, GFF and tabix."""

from .bgzf import BgzfReader, BgzfWriter, load_gzi, make_virtual_offset
from .fasta import FastaFile, iter_fasta, write_fai

__all__ = [
    "BgzfWriter",
    "BgzfReader",
    "load_gzi",
    "make_virtual_offset",
    "FastaFile",
    "iter_fasta",
    "write_fai",
]
