"""FASTA reading + .fai (faidx) indexing.

Host code shared in behaviour with ``panagram_tpu.io.fasta`` (carried as a
copy: importing any ``panagram_tpu`` module imports jax).  Dependency-free,
producing the standard 5-column .fai format: name, length, offset,
linebases, linewidth.
"""

from __future__ import annotations

import gzip
import os

import numpy as np


def _open_text(path):
    if str(path).endswith((".gz", ".bgz")):
        return gzip.open(path, "rt")
    return open(path, "r")


def iter_fasta(path):
    """Yield (name, sequence) tuples.  Name is the first whitespace-delimited
    token of the header line, matching the reference (cpp/anchor.cpp:84-85)."""
    name = None
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line[0] == ">":
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def write_fai(path, out_path=None):
    """Build a samtools-compatible .fai.  Offsets are in UNCOMPRESSED byte
    space, so the same index serves plain FASTA (seek into the file) and
    BGZF FASTA (seek through the .gzi block table), exactly like samtools
    faidx on bgzipped input."""
    if out_path is None:
        out_path = str(path) + ".fai"
    if str(path).endswith((".gz", ".bgz")):
        with gzip.open(path, "rb") as fh:
            entries = _scan_fai(path, fh)
    else:
        with open(path, "rb") as fh:
            entries = _scan_fai(path, fh)
    tmp = out_path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as out:
        for e in entries:
            out.write("\t".join(str(x) for x in e) + "\n")
    os.replace(tmp, out_path)
    return out_path


def _scan_fai(path, fh):
    """Scan a (decompressed) FASTA byte stream into .fai rows."""
    entries = []
    name = None
    length = 0
    offset = 0
    linebases = 0
    linewidth = 0
    first_line = True
    short_seen = False
    pos = 0
    for raw in fh:
        line = raw.rstrip(b"\r\n")
        if raw.startswith(b">"):
            if name is not None:
                entries.append((name, length, offset, linebases, linewidth))
            name = raw[1:].split()[0].decode() if len(raw) > 1 else ""
            length = 0
            offset = pos + len(raw)
            first_line = True
            short_seen = False
        elif name is not None:
            if not line:
                # a blank line's bytes still shift every later offset,
                # so any further sequence data makes the arithmetic
                # silently wrong — treat like a short line: legal only
                # at the very end of the record
                short_seen = True
            elif first_line:
                if short_seen:
                    raise ValueError(
                        f"{path}: sequence '{name}' has a blank line "
                        "before its data; cannot build a .fai index")
                linebases = len(line)
                linewidth = len(raw)
                first_line = False
            else:
                # .fai offset arithmetic assumes every non-terminal
                # sequence line has the same width; a ragged FASTA
                # would make fetch() silently return wrong bases
                # (samtools faidx errors on such input too)
                if short_seen or len(line) > linebases:
                    raise ValueError(
                        f"{path}: sequence '{name}' has ragged line "
                        "lengths; cannot build a .fai index")
                if len(line) < linebases:
                    short_seen = True  # only legal as the final line
            length += len(line)
        pos += len(raw)
    if name is not None:
        entries.append((name, length, offset, linebases, linewidth))
    return entries


class FastaFile:
    """Random-access FASTA via .fai (subset of pysam.FastaFile's API used by
    the reference: references, get_reference_length, fetch)."""

    def __init__(self, path):
        self.path = path
        fai = str(path) + ".fai"
        self._seqs = None
        self._bgzf = None
        if str(path).endswith((".gz", ".bgz")):
            from .bgzf import BgzfReader, build_gzi, is_bgzf

            if is_bgzf(path):
                # bgzip-compressed: random access through .fai offsets (in
                # uncompressed space) + the .gzi block table — the htslib
                # behaviour the reference gets from pysam.FastaFile on
                # bgzf input (reference panagram/index.py:576); no
                # whole-genome load.  Indexes
                # land next to the FASTA; a read-only location falls back
                # to the in-memory path below (the old behaviour).
                try:
                    gzi = str(path) + ".gzi"
                    if not os.path.exists(gzi):
                        build_gzi(path, gzi)
                    if not os.path.exists(fai):
                        write_fai(path, fai)
                    self._load_fai(fai)
                    self._bgzf = BgzfReader(path, gzi=gzi)
                    self._fh = None
                    return
                except OSError:
                    self._bgzf = None
            # plain gzip (not bgzf): not seekable — load into memory
            self._seqs = dict(iter_fasta(path))
            self._index = {
                n: (len(s), None, None, None) for n, s in self._seqs.items()
            }
            self._fh = None
            return
        if not os.path.exists(fai):
            write_fai(path, fai)
        self._load_fai(fai)
        self._fh = open(path, "rb")

    def _load_fai(self, fai):
        self._index = {}
        with open(fai) as f:
            for line in f:
                name, length, offset, linebases, linewidth = line.split("\t")[:5]
                self._index[name] = (
                    int(length),
                    int(offset),
                    int(linebases),
                    int(linewidth),
                )

    @property
    def references(self):
        return list(self._index.keys())

    def get_reference_length(self, name):
        return self._index[name][0]

    def fetch(self, name, start=None, end=None):
        length, offset, linebases, linewidth = self._index[name]
        if start is None:
            start = 0
        if end is None or end > length:
            end = length
        if self._seqs is not None:
            return self._seqs[name][start:end]
        line0 = start // linebases
        byte_start = offset + line0 * linewidth + (start - line0 * linebases)
        line1 = (end - 1) // linebases if end > start else line0
        byte_end = offset + line1 * linewidth + ((end - 1) - line1 * linebases) + 1
        if self._bgzf is not None:
            raw = self._bgzf.read_at(byte_start, byte_end - byte_start)
        else:
            self._fh.seek(byte_start)
            raw = self._fh.read(byte_end - byte_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    def close(self):
        if self._fh is not None:
            self._fh.close()
        if self._bgzf is not None:
            self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# 2-bit base codes matching KMC's encoding (A=0 C=1 G=2 T=3), with 4 marking
# any non-ACGT character (reference cpp/util.hpp base table).
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE_LUT[b] = i
    _CODE_LUT[b + 32] = i  # lowercase


def seq_to_codes(seq) -> np.ndarray:
    """Encode an ASCII sequence into uint8 codes (A=0,C=1,G=2,T=3, other=4)."""
    if isinstance(seq, str):
        arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    elif isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return _CODE_LUT[arr]
