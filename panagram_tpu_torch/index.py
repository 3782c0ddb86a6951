"""The pan-kmer index, write path: samples, config, and anchoring.

Writes the on-disk index of ``panagram_tpu.index`` for the same readers:

  samples.tsv, config.yaml                 (index root)
  anchor/<name>/bitmap.{1,100}.gz + .gzi   BGZF presence bitmaps
  anchor/<name>/chrs.tsv                   per-chromosome size = L - k + 1
  anchor/<name>/bitsum.bins.tsv            per-bin occupancy histograms
  anchor/<name>/total_paircounts.csv       per-genome presence totals

The tables are formatted with the csv module or plain string formatting,
byte-identical to what panagram_tpu writes through pandas.  Reading an
index (queries, viewer, UMAP embeddings) stays with panagram_tpu.index,
which opens this package's output.
"""

from __future__ import annotations

import csv
import logging
import os
import re
import time

import numpy as np

from .config import IndexConfig, config_path, samples_path
from .io.bgzf import BgzfWriter
from .io.fasta import FastaFile, iter_fasta, seq_to_codes

logger = logging.getLogger(__name__)

NAME_REGEX = "[A-Za-z0-9_-]+"
ANCHOR_DIR = "anchor"
FASTQ_EXTS = (".fastq", ".fastq.gz", ".fq", ".fq.gz")

# positions per streamed anchor chunk (upper end of the pow2 ladder)
ANCHOR_CHUNK = 1 << 22

# strings pandas.read_csv reads as missing by default; samples.tsv fields
# holding one of these are treated as absent, as panagram_tpu treats them
_NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])


def _field(v):
    """A samples.tsv cell, or None when it is missing."""
    return None if v is None or v in _NA_STRINGS else v


def _read_tsv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def _write_tsv(path: str, header, rows):
    """Tab-separated table in the dialect of pandas.DataFrame.to_csv."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


class Index:
    """Write handle on an index directory.

    Index(samples_tsv, prefix=..., **params) -> initializes config.yaml and
                                                samples.tsv
    Index(index_dir)                         -> resumes an initialized dir
    """

    def __init__(self, input, prefix=None, **params):
        self.conf = IndexConfig()
        if os.path.isdir(input):
            self.prefix = input
            if not (os.path.isfile(config_path(input))
                    and os.path.isfile(samples_path(input))):
                raise ValueError("Index write directory not initialized")
            self.conf = IndexConfig.load(config_path(input))
        elif os.path.isfile(input):
            self.prefix = prefix if prefix else (os.path.dirname(input) or ".")
            for key, val in params.items():
                setattr(self.conf, key, val)
            self.init_config(input)
        else:
            raise ValueError("Index input must be sample TSV or initialized "
                             "directory")

        self.samples = _read_tsv(samples_path(self.prefix))
        self.ngenomes = len(self.samples)
        self.genomes = {}
        for row in self.samples:
            anchor = _field(row.get("anchor"))
            self.genomes[row["name"]] = Genome(
                self, row["name"], _field(row.get("fasta")),
                _field(row.get("gff")),
                None if anchor is None else anchor == "True")

    def init_config(self, samples_tsv):
        with open(samples_tsv, newline="") as f:
            reader = csv.DictReader(f, delimiter="\t")
            rows = list(reader)
        missing = {"name", "fasta"} - set(reader.fieldnames or ())
        if missing:
            raise ValueError(
                f"samples.tsv is missing required column(s) "
                f"{sorted(missing)}; expected a tab-separated header with "
                f"at least 'name' and 'fasta' (optional 'gff')")
        bad = [r["name"] for r in rows
               if not re.fullmatch(NAME_REGEX, r["name"] or "")]
        if bad:
            raise ValueError(
                f"genome name(s) {bad} are not usable as file-path "
                f"components; names must match r'{NAME_REGEX}'")

        src_dir = os.path.dirname(os.path.abspath(samples_tsv))

        def resolve(p):
            if p is None or os.path.isabs(p):
                return p
            return os.path.relpath(os.path.join(src_dir, p), self.prefix)

        table = []
        for r in rows:
            fasta = resolve(_field(r.get("fasta")))
            gff = resolve(_field(r.get("gff")))
            if fasta is None and gff is None:
                continue
            table.append([r["name"], fasta, gff])

        if self.conf.anchor_genomes is None:
            self.conf.anchor_genomes = [
                n for n, fasta, _ in table
                if fasta is not None and not fasta.endswith(FASTQ_EXTS)]
        anchors = set(self.conf.anchor_genomes)

        os.makedirs(self.prefix, exist_ok=True)
        _write_tsv(samples_path(self.prefix),
                   ["name", "fasta", "gff", "id", "anchor"],
                   [[n, fasta or "", gff or "", i, str(n in anchors)]
                    for i, (n, fasta, gff) in enumerate(table)])
        self.conf.input = os.path.basename(samples_tsv)
        self.conf.save(config_path(self.prefix))

    @property
    def k(self):
        return self.conf.k

    @property
    def lowres_step(self):
        return self.conf.lowres_step

    @property
    def anchor_genomes(self):
        return self.conf.anchor_genomes or []

    @property
    def steps(self):
        return self.conf.steps

    @property
    def genome_names(self):
        return list(self.genomes)

    @property
    def genome_dist_fname(self):
        return os.path.join(self.prefix, "genome_dist.tsv")

    @property
    def kmer_dir(self):
        """Per-genome k-mer sets and the dictionary."""
        return os.path.join(self.prefix, "kmc")

    def kmer_set_fname(self, name):
        return os.path.join(self.kmer_dir, f"{name}.kmers.npz")

    @property
    def dict_fname(self):
        return os.path.join(self.kmer_dir, "pandict.npz")


class Genome:
    """One genome of the index; anchored genomes own an anchor/<name>/ dir."""

    def __init__(self, idx, name, fasta=None, gff=None, anchor=None):
        self.index = idx
        self.name = name
        self.fasta = fasta
        self.gff = gff
        self.is_fastq = fasta is not None and fasta.endswith(FASTQ_EXTS)
        self.anchored = (bool(anchor) if anchor is not None
                         else fasta is not None) and not self.is_fastq
        self.prefix = os.path.join(idx.prefix, ANCHOR_DIR, name)
        self.ngenomes = idx.ngenomes
        self.nbytes = (self.ngenomes + 7) // 8
        self.steps = list(idx.steps)
        self.chrs = None       # [name, id, size, gene_count] per record
        if not self.anchored:
            return
        if os.path.exists(self.chrs_fname):
            self.load_chrs()
        elif self.fasta is not None and os.path.exists(self._fasta_path):
            self.init_chrs()

    @property
    def _fasta_path(self):
        if self.fasta is None or os.path.isabs(self.fasta):
            return self.fasta
        return os.path.join(self.index.prefix, self.fasta)

    @property
    def chrs_fname(self):
        return os.path.join(self.prefix, "chrs.tsv")

    @property
    def bins_fname(self):
        return os.path.join(self.prefix, "bitsum.bins.tsv")

    @property
    def paircounts_fname(self):
        return os.path.join(self.prefix, "total_paircounts.csv")

    def bitmap_gz_fname(self, step):
        return os.path.join(self.prefix, f"bitmap.{step}.gz")

    def bitmap_gzi_fname(self, step):
        return os.path.join(self.prefix, f"bitmap.{step}.gzi")

    def init_chrs(self):
        """Chromosome table from the FASTA index; size = L - k + 1, clamped
        at 0 for records shorter than k."""
        k = self.index.k
        with FastaFile(self._fasta_path) as fa:
            self.chrs = [[name, i, max(fa.get_reference_length(name) - k + 1, 0), 0]
                         for i, name in enumerate(fa.references)]

    def load_chrs(self):
        self.chrs = [[r["name"], int(r["id"]), int(r["size"]),
                      int(r.get("gene_count") or 0)]
                     for r in _read_tsv(self.chrs_fname)]

    def write_chrs(self):
        _write_tsv(self.chrs_fname, ["name", "id", "size", "gene_count"],
                   self.chrs)

    def _anchor_chunk(self) -> int:
        """Pow2 chunk ladder: the smallest power of two holding the largest
        chromosome, within [2^18, ANCHOR_CHUNK]."""
        max_pos = max((c[2] for c in self.chrs), default=ANCHOR_CHUNK) \
            if self.chrs else ANCHOR_CHUNK
        return min(ANCHOR_CHUNK,
                   max(1 << 18, 1 << max(int(np.ceil(np.log2(
                       max(max_pos, 2)))), 1)))

    def bin_bitsum_binlen(self, nkmers):
        """Bin length of the occupancy histograms."""
        binlen = self.index.conf.max_bin_kbp * 1000
        if nkmers / binlen < self.index.conf.min_bin_count:
            binlen = nkmers // self.index.conf.min_bin_count
        return max(int(binlen), 1)

    def run_anchor(self, bucketed):
        """Anchor this genome against `bucketed` (a BucketedDict whose table
        is on the compute device) and write its anchor/<name>/ files."""
        from .ops.anchor import stream_anchor_chunks

        if not self.anchored:
            logger.info(f"Skipping non-anchor genome '{self.name}'")
            return
        os.makedirs(self.prefix, exist_ok=True)
        k = self.index.k
        N = self.ngenomes
        nbytes = self.nbytes
        lowres = self.index.lowres_step
        if self.chrs is None:
            self.init_chrs()
        for c in self.chrs:
            c[3] = 0    # gene_count: annotation is not in this slice

        writers = {s: BgzfWriter(self.bitmap_gz_fname(s)) for s in self.steps}
        bin_rows = []  # (chr_id, start, counts[0..N])
        paircount_sums = np.zeros(N, np.int64)
        chunk = self._anchor_chunk()
        phase = {"encode": 0.0, "drain": 0.0, "write": 0.0, "bins": 0.0}
        logger.info("Anchoring Started")
        try:
            for chrom_i, (chrom, seq) in enumerate(iter_fasta(self._fasta_path)):
                t0 = time.perf_counter()
                codes = seq_to_codes(seq)
                phase["encode"] += time.perf_counter() - t0
                nkmers = len(codes) - k + 1
                if nkmers <= 0:
                    logger.warning(f"Skipping short sequence {chrom}")
                    continue
                binlen = self.bin_bitsum_binlen(nkmers)
                nbins = -(-nkmers // binlen)
                hist = np.zeros((nbins, N + 1), np.int64)

                it = stream_anchor_chunks(codes, nkmers, chunk, bucketed,
                                          nbytes, N, k)
                while True:
                    t0 = time.perf_counter()
                    item = next(it, None)
                    phase["drain"] += time.perf_counter() - t0
                    if item is None:
                        break
                    start, m, by, popc, chunk_colsums = item
                    t0 = time.perf_counter()
                    writers[1].write(by)
                    # global-phase low-resolution rows: every lowres-th
                    # position of the chromosome
                    first = (-start) % lowres
                    writers[lowres].write(by[first::lowres].tobytes())
                    phase["write"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    bins = (start + np.arange(m)) // binlen
                    hist += np.bincount(bins * (N + 1) + popc,
                                        minlength=nbins * (N + 1)
                                        ).reshape(nbins, N + 1)
                    paircount_sums += chunk_colsums
                    phase["bins"] += time.perf_counter() - t0
                for b in range(nbins):
                    bin_rows.append((chrom_i, b * binlen, hist[b]))
                logger.info(f"Anchored {chrom}")
        finally:
            for w in writers.values():
                w.close()
        for s in self.steps:
            writers[s].write_gzi(self.bitmap_gzi_fname(s))

        self._write_paircounts(paircount_sums)
        with open(self.bins_fname, "w") as f:
            f.write("chr\tstart\t" + "\t".join(str(i) for i in range(N + 1))
                    + "\n")
            for cid, start, counts in bin_rows:
                f.write(f"{cid}\t{start}\t"
                        + "\t".join(str(int(c)) for c in counts) + "\n")
        self.write_chrs()
        logger.info("anchor phases: " + " ".join(
            f"{name}={v:.3f}s" for name, v in phase.items()))

    def _write_paircounts(self, sums: np.ndarray):
        """total_paircounts.csv: each genome's presence total over this
        anchor's positions, and its fraction of this genome's own total
        (floats as pandas writes them: repr, NaN empty)."""
        own = sums[self.index.genome_names.index(self.name)]
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = sums / own
        with open(self.paircounts_fname, "w") as f:
            f.write("name,count,frac\n")
            for name, c, fr in zip(self.index.genome_names, sums, frac):
                f.write(f"{name},{int(c)},"
                        f"{'' if np.isnan(fr) else repr(float(fr))}\n")
