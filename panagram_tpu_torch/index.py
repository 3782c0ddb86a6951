"""The pan-kmer index: samples, config, anchoring, annotation, and reading.

Writes the on-disk index of ``panagram_tpu.index`` for the same readers:

  samples.tsv, config.yaml                 (index root)
  anchor/<name>/bitmap.{1,100}.gz + .gzi   BGZF presence bitmaps
  anchor/<name>/chrs.tsv                   per-chromosome size = L - k + 1
  anchor/<name>/bitsum.bins.tsv            per-bin occupancy histograms
  anchor/<name>/total_paircounts.csv       per-genome presence totals
  anchor/<name>/{gene,anno}.bed.gz + .csi  GFF tables (annotated genomes)
  anchor/<name>/anno_types.txt             annotation types
  anchor/<name>/bitsum.genes.tsv           per-chromosome gene histograms
  anchor/<name>/{chrom,genome}_umap(s).csv 2-D embeddings of paircount bins

The tables are formatted with the csv module or plain string formatting,
byte-identical to what panagram_tpu writes through pandas (the embeddings'
coordinates to floating-point rounding; anno_types.txt lists a set, in
hash order).

Read mode (``Index(index_dir)``) is panagram_tpu's read API without
pandas: ``query_bitmap``, ``query_genes``, ``query_anno``, the per-genome
and index-wide occupancy summaries and the bin transforms.  Each table is a
``Table``: a numpy array with its row and column labels, holding the values
and labels of the DataFrame or Series panagram_tpu returns under the same
name.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
import re
import threading
import time
from typing import Sequence

import numpy as np

from .config import IndexConfig, config_path, samples_path
from .io.bgzf import BgzfReader, BgzfWriter
from .io.fasta import FastaFile, iter_fasta, seq_to_codes
from .io.gff import split_gff
from .io.tabix import TabixFile, write_tabix

logger = logging.getLogger(__name__)

NAME_REGEX = "[A-Za-z0-9_-]+"
ANCHOR_DIR = "anchor"
FASTQ_EXTS = (".fastq", ".fastq.gz", ".fq", ".fq.gz")
BGZ_SUFFIX = "gz"
IDX_SUFFIX = "gzi"
TABIX_COLS = ["chr", "start", "end", "type", "name"]
TABIX_TYPES = {"start": int, "end": int}
GENE_COLS = ["chr", "start", "end", "name"]

_LOG_FORMAT = "[%(asctime)s %(levelname)s] %(message)s"
_LOG_DATEFMT = "%Y-%m-%d %H:%M:%S"

# positions per streamed anchor chunk (upper end of the pow2 ladder);
# panagram_tpu's knob of the same name sets it for runs and tests that need
# many small chunks
ANCHOR_CHUNK = 1 << int(os.environ.get("PANAGRAM_TPU_CHUNK_LOG2", "22"))

# strings pandas.read_csv reads as missing by default; samples.tsv fields
# holding one of these are treated as absent, as panagram_tpu treats them
_NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])


def init_logger(logfile=None):
    """INFO logging as panagram_tpu configures it: to `logfile` (replacing
    the root logger's handlers) when given, else to stderr unless logging
    is configured already."""
    logging.basicConfig(filename=logfile, level=logging.INFO,
                        format=_LOG_FORMAT, datefmt=_LOG_DATEFMT,
                        force=logfile is not None)


def _field(v):
    """A samples.tsv cell, or None when it is missing."""
    return None if v is None or v in _NA_STRINGS else v


def _read_tsv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def _write_tsv(path: str, header, rows, delimiter="\t"):
    """A table in the dialect of pandas.DataFrame.to_csv."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=delimiter, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def _na(name):
    """A GFF name as panagram_tpu writes it: a missing one is 'nan'."""
    return "nan" if name is None else name


def _by_chrom(genes: list) -> dict:
    """Gene rows grouped by chromosome, in order of first appearance."""
    out: dict[str, list] = {}
    for g in genes:
        out.setdefault(g[0], []).append(g)
    return out


def bitmap_occupancy(rows: np.ndarray, ngenomes: int, device) -> np.ndarray:
    """Genomes present at each bitmap row (uint8 [P, nbytes], no bit set
    past ngenomes), int64 [P]: the rows widened to zero-padded u32 words,
    the int32 rows layout of ops/anchor.anchor_chunk, and popcounted by the
    fused_popcount_colsums kernel on `device`."""
    import torch

    from .ops import kernels

    P, nbytes = rows.shape
    words = np.zeros((P, 4 * -(-nbytes // 4)), np.uint8)
    words[:, :nbytes] = rows
    t = torch.from_numpy(words.view("<i4")).to(device)
    popc, _ = kernels.fused_popcount_colsums(t, ngenomes)
    return popc.cpu().numpy().astype(np.int64)


def bitmap_to_bins(positions: np.ndarray, presence: np.ndarray, binlen: int):
    """panagram_tpu.index.Index.bitmap_to_bins on arrays: bitmap rows at
    `positions` with presence bits [rows, N] -> (bin starts [B], occupancy
    histograms int64 [N+1, B], per-bin genome totals scaled by the bin's
    largest total [B, N], NaN for an empty bin)."""
    bins, slots = np.unique(np.asarray(positions) // binlen,
                            return_inverse=True)
    nb, n = len(bins), presence.shape[1]
    # bincounts of flat (row, column) cells: the np.add.at sums of
    # panagram_tpu, exact in integers and ~100x faster
    occ = np.bincount(presence.sum(axis=1, dtype=np.int64) * nb + slots,
                      minlength=(n + 1) * nb).reshape(n + 1, nb)
    cells = slots[:, None] * n + np.arange(n)
    sums = np.bincount(cells[presence.astype(bool)],
                       minlength=nb * n).reshape(nb, n)
    peak = sums.T.max(axis=0, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        scaled = np.where(peak > 0, sums.T / peak, np.nan)
    return bins * binlen, occ, scaled.T


def bitmap_to_paircount_bins(positions, presence, binlen: int):
    """(bin starts, scaled per-bin genome totals [B, N] with empty bins
    0): the paircount profiles panagram_tpu embeds, fillna(0) applied."""
    starts, _, scaled = bitmap_to_bins(positions, presence, binlen)
    return starts, np.where(np.isnan(scaled), 0.0, scaled)


@dataclasses.dataclass
class Table:
    """A labelled table, the read API's stand-in for a pandas DataFrame or
    Series: `values` (a DataFrame's ``to_numpy()``: [rows, columns], an
    object array where the columns mix types; a Series' values: [rows]),
    `index` (one label per row, a tuple where the DataFrame has a
    MultiIndex), `columns` (the column labels; None for a Series) and
    `index_name`."""

    values: np.ndarray
    index: Sequence
    columns: list | None = None
    # the name of the row labels, where the DataFrame's index has one
    index_name: str | None = None


def _frequencies(t: Table) -> Table:
    """Each row divided by its sum (0 / 0 -> NaN): panagram_tpu's
    ``df.divide(df.sum(axis=1), axis=0)``."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return Table(t.values / t.values.sum(axis=1, keepdims=True), t.index,
                     t.columns)


def _mean_occupancy(freqs: Table) -> Table:
    """Per row the sum over occupancy of occupancy x frequency (NaN
    frequencies count 0), ascending: a Series of panagram_tpu.  The sum
    runs over a column-major array, the layout of a pandas frame's values,
    so that it adds in panagram_tpu's order and gives its last bits."""
    vals = np.nansum(np.asfortranarray(freqs.values)
                     * np.asarray(freqs.columns), axis=1)
    order = np.argsort(vals, kind="stable")
    return Table(vals[order], [freqs.index[i] for i in order])


def _stack(tables: list, keys: list, columns: list) -> Table:
    """Tables with these columns one under another, each row label
    prefixed with its table's key: ``pd.concat(tables, keys=keys)``."""
    return Table(np.concatenate([t.values for t in tables]
                                or [np.zeros((0, len(columns)))]),
                 [(k,) + (i if isinstance(i, tuple) else (i,))
                  for k, t in zip(keys, tables) for i in t.index],
                 columns)


def _column(fields) -> list:
    """A CSV column typed as pandas.read_csv types it: int, else float
    (empty fields NaN), else str."""
    try:
        return [int(x) for x in fields]
    except ValueError:
        pass
    try:
        return [float(x) if x else float("nan") for x in fields]
    except ValueError:
        return list(fields)


def _values(cols: list, nrows: int) -> np.ndarray:
    """Columns as one [rows, columns] array, as DataFrame.to_numpy() gives
    it: int64 when every value is an int, float64 when every value is a
    number, else (and without rows) an object array."""
    out = np.empty((nrows, len(cols)), object)
    for j, c in enumerate(cols):
        out[:, j] = c
    kinds = {type(x) for c in cols for x in c}
    if not nrows:
        return out
    if kinds <= {int}:
        return out.astype(np.int64)
    if kinds <= {int, float}:
        return out.astype(np.float64)
    return out


def _read_table(path: str, sep=",", index_col=None) -> Table:
    """A CSV or TSV file as pandas.read_csv(path, sep=sep,
    index_col=index_col) reads it: each column typed by _column, the rows
    labelled by the index column or 0..n-1."""
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f, delimiter=sep))
    cols = [_column(c) for c in zip(*rows)] if rows else [[] for _ in header]
    if index_col is None:
        index = np.arange(len(rows))
    else:
        i = header.index(index_col)
        index = cols.pop(i)
        header = header[:i] + header[i + 1:]
    return Table(_values(cols, len(rows)), index, header)


class Index:
    """Handle on an index directory, as panagram_tpu.index.Index.

    Index(samples_tsv, prefix=..., **params) -> write mode: initializes
                                                config.yaml and samples.tsv
    Index(index_dir, mode="w")               -> write mode: resumes an
                                                initialized dir
    Index(index_dir)                         -> read mode
    """

    def __init__(self, input, mode=None, prefix=None, **params):
        self.conf = IndexConfig()
        self.write_mode = os.path.isfile(input) if mode is None else mode == "w"
        # a mesh build's per-rank reports (pipeline.build_index)
        self.mesh_ranks = None
        if not self.write_mode:
            if not os.path.isdir(input):
                raise ValueError("Index input must be directory in mode='r'")
            self.prefix = input
            self.conf = IndexConfig.load(config_path(input))
        elif os.path.isdir(input):
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
        for i, row in enumerate(self.samples):
            anchor = _field(row.get("anchor"))
            self.genomes[row["name"]] = Genome(
                self, int(_field(row.get("id")) or i), row["name"],
                _field(row.get("fasta")), _field(row.get("gff")),
                None if anchor is None else anchor == "True",
                write=self.write_mode)
        self.chrs = None
        if not self.write_mode:
            self._init_read()

    def _init_read(self):
        """The anchored genomes' summaries stacked into index-wide tables
        (panagram_tpu's Index._init_read): chrs, bitsum_bins (sorted by
        genome, chr, start), bitsum_chrs and bitfreq_chrs (per genome,
        chromosomes by name), bitsum_totals and bitfreq_totals (one row per
        anchor), bitsum_totals_avg and bitsum_chrs_avg (mean occupancy,
        ascending) and genome_sizes (length and chr_count per genome, by
        name)."""
        loaded = [(n, self.genomes[n]) for n in self.anchor_genomes
                  if self.genomes[n].chrs is not None]
        names = [n for n, _ in loaded]
        self.chrs = Table(
            np.array([c[1:] for _, g in loaded for c in g.chrs],
                     np.int64).reshape(-1, 3),
            [(n, c[0]) for n, g in loaded for c in g.chrs],
            ["id", "size", "gene_count"])
        occ = self.bitsum_index
        bins = _stack([g.bitsum_bins for _, g in loaded], names, occ)
        order = sorted(range(len(bins.index)), key=bins.index.__getitem__)
        self.bitsum_bins = Table(bins.values[order],
                                 [bins.index[i] for i in order], occ)
        self.bitsum_chrs = _stack([g.bitsum_chrs for _, g in loaded], names,
                                  occ)
        self.bitfreq_chrs = _stack([g.bitfreq_chrs for _, g in loaded],
                                   names, occ)
        self.bitsum_totals = Table(
            np.array([g.bitsum_total.values for _, g in loaded],
                     np.int64).reshape(len(names), len(occ)), names, occ)
        self.bitfreq_totals = _frequencies(self.bitsum_totals)
        self.bitsum_totals_avg = _mean_occupancy(self.bitfreq_totals)
        self.bitsum_chrs_avg = _mean_occupancy(self.bitfreq_chrs)
        sizes: dict[str, list[int]] = {}
        for (n, _), size in zip(self.chrs.index, self.chrs.values[:, 1]):
            sizes.setdefault(n, []).append(int(size))
        gs = sorted(sizes)
        self.genome_sizes = Table(
            np.array([[sum(sizes[n]), len(sizes[n])] for n in gs],
                     np.int64).reshape(-1, 2),
            gs, ["length", "chr_count"])

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
        self.write_config()

    def write_config(self):
        self.conf.save(config_path(self.prefix))

    def load_config(self):
        self.conf = IndexConfig.load(config_path(self.prefix))

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
    def params(self) -> dict:
        """The configuration as a dict, with the index's prefix."""
        d = self.conf.to_dict(exclude=())
        d["prefix"] = self.prefix
        return d

    @property
    def genome_names(self):
        return list(self.genomes)

    @property
    def genome_dist_fname(self):
        return os.path.join(self.prefix, "genome_dist.tsv")

    def get_subdir(self, name):
        return os.path.join(self.prefix, name)

    @property
    def kmer_dir(self):
        """Per-genome k-mer sets and the dictionary."""
        return self.get_subdir("kmc")

    def kmer_set_fname(self, name):
        return os.path.join(self.kmer_dir, f"{name}.kmers.npz")

    @property
    def dict_fname(self):
        return os.path.join(self.kmer_dir, "pandict.npz")

    @property
    def bitsum_index(self) -> list[int]:
        """Occupancy values 0..N: the columns of the histograms."""
        return list(range(self.ngenomes + 1))

    # ---------------- read API (panagram_tpu.index.Index's) ----------------

    def __getitem__(self, genome):
        return self.genomes[genome]

    def query_bitmap(self, genome, chrom, start=None, end=None, step=1):
        return self.genomes[genome].query(chrom, start, end, step)

    def query_genes(self, genome, chrom=None, start=None, end=None):
        return self.genomes[genome].query_genes(chrom, start, end)

    def query_anno(self, genome, chrom, start, end):
        return self.genomes[genome].query_anno(chrom, start, end)

    def bitsum_count(self, occs) -> np.ndarray:
        """How many of `occs` hold each occupancy 1..N, uint32 [N] (an
        occupancy 0 lands in the last slot, as in panagram_tpu)."""
        ret = np.zeros(self.ngenomes, "uint32")
        occs, counts = np.unique(occs, return_counts=True)
        ret[occs - 1] = counts
        return ret

    def bitmap_to_bins(self, bitmap: Table, binlen: int):
        """(pancount_bins: occupancy histograms [N+1, bins], columns the
        bin ids; paircount_bins: per-genome totals scaled by each bin's
        largest [N, bins], columns the bin starts) of a query_bitmap
        table."""
        starts, occ, scaled = bitmap_to_bins(bitmap.index, bitmap.values,
                                             binlen)
        return (Table(occ, self.bitsum_index, list(starts // binlen)),
                Table(scaled.T, list(bitmap.columns), list(starts)))

    def bitmap_to_paircount_bins(self, bitmap: Table, binlen: int) -> Table:
        """The paircount_bins table of bitmap_to_bins."""
        return self.bitmap_to_bins(bitmap, binlen)[1]

    def bitmap_to_pancount(self, bitmap: Table) -> Table:
        """Genomes present per row of a query_bitmap table (uint64, numpy's
        sum of uint8, as panagram_tpu's)."""
        return Table(bitmap.values.sum(axis=1), bitmap.index)

    def pancount_to_bins(self, pancnts: Table, binlen: int) -> Table:
        """Occupancy histograms [N+1, bins] of a bitmap_to_pancount table,
        columns the bin ids."""
        bins, slots = np.unique(np.asarray(pancnts.index) // binlen,
                                return_inverse=True)
        occ = np.bincount(np.asarray(pancnts.values, np.int64) * len(bins)
                          + slots, minlength=(self.ngenomes + 1) * len(bins))
        return Table(occ.reshape(self.ngenomes + 1, len(bins)),
                     self.bitsum_index, list(bins))

    def close(self):
        for g in self.genomes.values():
            g.close()


class Genome:
    """One genome of the index; anchored genomes own an anchor/<name>/ dir."""

    def __init__(self, idx, id, name, fasta=None, gff=None, anchor=None,
                 write=False):
        self.index = idx
        self.id = id           # samples.tsv's id (the genome's bit)
        self.name = name
        self.fasta = fasta
        self.gff = gff
        self.is_fastq = fasta is not None and fasta.endswith(FASTQ_EXTS)
        self.anchored = (bool(anchor) if anchor is not None
                         else fasta is not None) and not self.is_fastq
        self.annotated = gff is not None
        self.prefix = os.path.join(idx.prefix, ANCHOR_DIR, name)
        self.ngenomes = idx.ngenomes
        self.nbytes = (self.ngenomes + 7) // 8
        self.steps = list(idx.steps)
        self.chrs = None       # [name, id, size, gene_count] per record
        self.bitmaps = None    # step -> BgzfReader, opened by _open_bitmaps
        self.gene_tabix = self.anno_tabix = None
        if not self.anchored:
            return
        if os.path.exists(self.chrs_fname):
            self.load_chrs()
        elif self.fasta is not None and os.path.exists(self._fasta_path):
            self.init_chrs()
        if not write:
            if self.chrs is not None and os.path.exists(self.bitmap_gz_fname(1)):
                self.init_read()
            else:
                self.chrs = None

    @property
    def _fasta_path(self):
        if self.fasta is None or os.path.isabs(self.fasta):
            return self.fasta
        return os.path.join(self.index.prefix, self.fasta)

    @property
    def _gff_path(self):
        if self.gff is None or os.path.isabs(self.gff):
            return self.gff
        return os.path.join(self.index.prefix, self.gff)

    @property
    def chrs_fname(self):
        return os.path.join(self.prefix, "chrs.tsv")

    @property
    def chr_genes_fname(self):
        return os.path.join(self.prefix, "bitsum.genes.tsv")

    @property
    def anno_types_fname(self):
        return os.path.join(self.prefix, "anno_types.txt")

    def tabix_fname(self, typ):
        return os.path.join(self.prefix, f"{typ}.bed.gz")

    def tabix_idx_fname(self, typ):
        return self.tabix_fname(typ) + ".csi"

    @property
    def chrom_umaps_filename(self):
        return os.path.join(self.prefix, "chrom_umaps.csv")

    @property
    def genome_umap_filename(self):
        return os.path.join(self.prefix, "genome_umap.csv")

    @property
    def bins_fname(self):
        return os.path.join(self.prefix, "bitsum.bins.tsv")

    @property
    def paircounts_fname(self):
        return os.path.join(self.prefix, "total_paircounts.csv")

    def bitmap_gz_fname(self, step):
        return os.path.join(self.prefix, f"bitmap.{step}.{BGZ_SUFFIX}")

    def bitmap_gzi_fname(self, step):
        return os.path.join(self.prefix, f"bitmap.{step}.{IDX_SUFFIX}")

    @property
    def anchor_filenames(self) -> list:
        """The files anchoring writes (annotated genomes: the gene and
        annotation tables too); none for a genome that is not anchored."""
        if not self.anchored:
            return []
        ret = [self.chrs_fname, self.bins_fname]
        for s in self.steps:
            ret += [self.bitmap_gz_fname(s), self.bitmap_gzi_fname(s)]
        if self.annotated:
            ret.append(self.chr_genes_fname)
            for t in ["gene", "anno"]:
                ret += [self.tabix_fname(t), self.tabix_idx_fname(t)]
        return ret

    @property
    def bitsum_index(self) -> range:
        """Occupancy values 0..N (panagram_tpu's pd.RangeIndex)."""
        return range(0, self.ngenomes + 1)

    @property
    def gene_tabix_types(self) -> dict:
        r = {"start": int, "end": int}
        for i in [1, self.ngenomes]:
            r[i] = int
        return r

    @property
    def chr_count(self) -> int:
        return len(self.chrs)

    def _peer_anchor_dir(self, pid: int, me: int) -> str:
        """Process `pid`'s anchor directory of this genome, seen from
        process `me`, under the convention of a multi-process mesh build:
        process 0 writes under the bare prefix, process i under
        '<prefix>.p<i>', all on one shared filesystem."""
        base = self.index.prefix.rstrip("/")
        if me and base.endswith(f".p{me}"):
            base = base[:-len(f".p{me}")]
        if pid:
            base = f"{base}.p{pid}"
        return os.path.join(base, ANCHOR_DIR, self.name)

    def _bitmap_piece_fname(self, step, pid: int, me: int, peer=False):
        """Piece file of process `pid` for a multi-process bitmap write;
        each process writes under its own prefix, and peer=True resolves
        process pid's directory, so that process 0 can stitch."""
        adir = self._peer_anchor_dir(pid, me) if peer else self.prefix
        return os.path.join(adir, f".bitmap.{step}.p{pid}.part")

    def primary_bitmap_fname(self, step, me: int) -> str:
        """Where the stitched bitmap of a multi-process build lives: under
        process 0's prefix (the others keep only the derived tables)."""
        return os.path.join(self._peer_anchor_dir(0, me),
                            f"bitmap.{step}.{BGZ_SUFFIX}")

    def init_chrs(self):
        """Chromosome table from the FASTA index; size = L - k + 1, clamped
        at 0 for records shorter than k."""
        k = self.index.k
        with FastaFile(self._fasta_path) as fa:
            self.set_chrs([[name, i, max(fa.get_reference_length(name) - k + 1, 0)]
                           for i, name in enumerate(fa.references)])
        return self.chrs

    def load_chrs(self):
        self.set_chrs([[r["name"], int(r["id"]), int(r["size"]),
                        int(r.get("gene_count") or 0)]
                       for r in _read_tsv(self.chrs_fname)])

    def set_chrs(self, chrs):
        """Take `chrs` as the chromosome table: records [name, id, size] or
        [name, id, size, gene_count] (a missing gene_count is 0, as
        panagram_tpu's set_chrs adds it), or a Table as chrs_table gives
        (rows the names; columns id, size and optionally gene_count)."""
        if isinstance(chrs, Table):
            cols = [c for c in ("id", "size", "gene_count")
                    if c in chrs.columns]
            at = [list(chrs.columns).index(c) for c in cols]
            chrs = [[name] + [int(row[i]) for i in at]
                    for name, row in zip(chrs.index, chrs.values)]
        self.chrs = [[c[0], int(c[1]), int(c[2]),
                      int(c[3]) if len(c) > 3 else 0] for c in chrs]

    def write_chrs(self):
        _write_tsv(self.chrs_fname, ["name", "id", "size", "gene_count"],
                   self.chrs)

    @property
    def sizes(self) -> dict:
        """Chromosome -> size (positions, L - k + 1) in chrs.tsv order:
        panagram_tpu's ``sizes`` Series as a dict."""
        return {c[0]: c[2] for c in self.chrs}

    def seq_len(self, seq_name) -> int:
        return self.sizes[seq_name]

    @property
    def chrs_table(self) -> Table:
        """chrs.tsv as the Table of panagram_tpu's read-mode ``chrs``: rows
        labelled by chromosome name, columns id, size and gene_count."""
        return Table(np.array([c[1:] for c in self.chrs],
                              np.int64).reshape(-1, 3),
                     [c[0] for c in self.chrs], ["id", "size", "gene_count"])

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

    def iter_fasta(self):
        """(name, sequence) of each record of this genome's FASTA."""
        yield from iter_fasta(self._fasta_path)

    def run_anchor(self, pan_dict=None, logfile=None, bucketed=None,
                   mesh=None, sharded=None, *, device="cuda"):
        """Anchor this genome and write its anchor/<name>/ files: against
        `bucketed` (a BucketedDict whose table is on the compute device),
        else against `pan_dict` (a PanKmerDict; pandict.npz when None) laid
        out on `device`, or, called by every rank of `mesh`, against
        `sharded` (this rank's part of a parallel.shard dictionary).
        `logfile` sends the log there (init_logger).  On a mesh only writer
        ranks write; with per-process piece writes (range strategy, several
        processes, parallel.mesh.sharded_writes_enabled) each writer writes
        its ranks' bitmap rows as pieces and process 0 stitches them."""
        if logfile:
            init_logger(logfile)
        if not self.anchored:
            logger.info(f"Skipping non-anchor genome '{self.name}'")
            return
        if mesh is None and bucketed is None:
            from .ops.dictionary import PanKmerDict
            from .ops.lookup import BucketedDict

            if pan_dict is None:
                pan_dict = PanKmerDict.load(self.index.dict_fname)
            mixed = pan_dict.key_space == "mixed"
            bucketed = BucketedDict.build_device(
                pan_dict.keys, pan_dict.masks, self.ngenomes, self.index.k,
                mixed=mixed, sorted_input=mixed, device=device)
        k = self.index.k
        N = self.ngenomes
        nbytes = self.nbytes
        lowres = self.index.lowres_step
        if self.chrs is None:
            self.init_chrs()
        chunk = self._anchor_chunk()
        # host seconds per phase of the stage, logged at its end: encode
        # (FASTA codes), pack (2-bit packing, one-device path), wait (the
        # rest of each chunk's request: the enqueue and the wait for the
        # card, or the mesh's collectives), copy (the copy-back, a part of
        # wait: the card's time on CUDA), write (BGZF), bins, finish (the
        # embeddings)
        phase = {"encode": 0.0, "pack": 0.0, "wait": 0.0, "copy": 0.0,
                 "write": 0.0, "bins": 0.0}
        pieces = False
        if mesh is None:
            from .ops.anchor import stream_anchor_chunks

            def chunks(codes, nkmers):
                return stream_anchor_chunks(codes, nkmers, chunk, None, None,
                                            bucketed, nbytes, N, k,
                                            phase=phase)
        else:
            from .parallel.mesh import barrier, sharded_writes_enabled
            from .parallel.shard import ShardedBucketedDict, stream_mesh_chunks

            pieces = (isinstance(sharded, ShardedBucketedDict)
                      and sharded_writes_enabled(mesh))

            def chunks(codes, nkmers):
                return stream_mesh_chunks(mesh, sharded, codes, nkmers, chunk,
                                          nbytes, N, k, pieces)

            if not mesh.writer:
                # the collectives of every chunk, nothing written
                for _, seq in iter_fasta(self._fasta_path):
                    codes = seq_to_codes(seq)
                    for _ in chunks(codes, len(codes) - k + 1):
                        pass
                if pieces:
                    barrier(mesh)
                return
        os.makedirs(self.prefix, exist_ok=True)
        genes, by_chrom = None, {}
        if self.annotated:
            genes = self._init_gff()
            by_chrom = _by_chrom(genes)
            logger.info("Annotation pre-processed")
        for c in self.chrs:
            c[3] = len(by_chrom.get(c[0], ()))

        if pieces:
            from .io.bgzf import BgzfPieceWriter, stitch_bgzf_pieces

            me = mesh.process_index
            writers = {s: BgzfPieceWriter(self._bitmap_piece_fname(s, me, me))
                       for s in self.steps}
        else:
            writers = {s: BgzfWriter(self.bitmap_gz_fname(s))
                       for s in self.steps}
        bin_rows = []  # (chr_id, start, counts[0..N])
        paircount_sums = np.zeros(N, np.int64)
        # rows (step 1) and low-resolution rows of the chromosomes before
        # this one: where a piece goes in the whole bitmap
        base1 = base_low = 0
        drain = 0.0
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
                popc_full = np.empty(nkmers, np.int16) if genes else None

                it = chunks(codes, nkmers)
                while True:
                    t0 = time.perf_counter()
                    item = next(it, None)
                    drain += time.perf_counter() - t0
                    if item is None:
                        break
                    start, m, by, popc, chunk_colsums = item
                    t0 = time.perf_counter()
                    if pieces:
                        for row0, piece in by:
                            p0 = start + row0   # position in the chromosome
                            writers[1].write_piece((base1 + p0) * nbytes, piece)
                            sel = piece[(-p0) % lowres::lowres]
                            if sel.shape[0]:
                                lr = base_low + (p0 + lowres - 1) // lowres
                                writers[lowres].write_piece(lr * nbytes,
                                                            sel.tobytes())
                    else:
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
                    if popc_full is not None:
                        popc_full[start:start + m] = popc
                    phase["bins"] += time.perf_counter() - t0
                for b in range(nbins):
                    bin_rows.append((chrom_i, b * binlen, hist[b]))
                base1 += nkmers
                base_low += -(-nkmers // lowres)
                logger.info(f"Anchored {chrom}")
                if chrom in by_chrom:
                    self._add_gene_hists(by_chrom[chrom], chrom, popc_full, 0)
                    logger.info(f"Annotated {chrom}")
        finally:
            for w in writers.values():
                w.close()
        phase["wait"] = drain - phase["pack"]
        if pieces:
            # every process's pieces are complete before process 0 stitches
            barrier(mesh)
            if me == 0:
                for s in self.steps:
                    paths = [self._bitmap_piece_fname(s, p, me, peer=True)
                             for p in range(mesh.process_count)]
                    stitch_bgzf_pieces(paths, self.bitmap_gz_fname(s),
                                       self.bitmap_gzi_fname(s))
                    for path in paths:
                        os.remove(path)
                        os.remove(path + ".manifest.npy")
        else:
            for s in self.steps:
                writers[s].write_gzi(self.bitmap_gzi_fname(s))

        self._write_paircounts(paircount_sums)
        if genes is not None:
            self._write_genes(genes)
        with open(self.bins_fname, "w") as f:
            f.write("chr\tstart\t" + "\t".join(str(i) for i in range(N + 1))
                    + "\n")
            for cid, start, counts in bin_rows:
                f.write(f"{cid}\t{start}\t"
                        + "\t".join(str(int(c)) for c in counts) + "\n")
        self.write_chrs()

        if pieces and me != 0:
            # the stitched bitmap lives under process 0's prefix: nothing
            # here to embed
            logger.info("anchor phases: " + " ".join(
                f"{name}={v:.3f}s" for name, v in phase.items()))
            return
        t0 = time.perf_counter()
        self.close()    # readers of an earlier bitmap, if any
        try:
            self.write_umaps()
        except Exception as e:  # the embeddings are ancillary, as upstream
            logger.warning(f"UMAP embedding failed: {e}", exc_info=True)
        phase["finish"] = time.perf_counter() - t0
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

    # ---------------- annotation ----------------

    def _init_gff(self) -> list:
        """Parse the GFF: write the annotation tabix and anno_types.txt, and
        return the genes as [chr, start, end, name, histogram int64 [N+1]]
        rows, stably sorted by (chr, start, end)."""
        conf = self.index.conf
        genes, annos = split_gff(self._gff_path,
                                 gene_types=conf.gff_gene_types,
                                 anno_types=conf.gff_anno_types,
                                 name_attr=conf.gff_name)
        write_tabix([a[:4] + (_na(a[4]),) for a in annos],
                    self.tabix_fname("anno"), self.tabix_idx_fname("anno"))
        types = {a[3] for a in annos}
        if conf.gff_anno_types is not None:
            types = set(conf.gff_anno_types) & types
        with open(self.anno_types_fname, "w") as f:
            for t in types:
                f.write(f"{t}\n")
        genes.sort(key=lambda g: (g[0], g[1], g[2]))
        for g in genes:
            g.append(np.zeros(self.ngenomes + 1, np.int64))
        return genes

    def _add_gene_hists(self, rows: list, chrom: str, popc: np.ndarray,
                        base: int):
        """Add to each gene row of `chrom` the histogram of popc[start -
        base : end - base] (GFF coordinates used as 0-based half-open
        slices, as panagram_tpu does).  A gene whose span is empty, starts
        below 0 or ends past popc is skipped with a warning.  Rows with the
        same (chr, start, end) all receive every such row's histogram, as
        panagram_tpu's `.loc[key] +=` gives them."""
        same = {}
        for g in rows:
            same.setdefault((g[1], g[2]), []).append(g)
        for _, start, end, _, _ in rows:
            if end <= start or start < 0 or end - base > len(popc):
                logger.warning(f"Skipping gene at {chrom}:{start}-{end}, "
                               "coordinates out-of-bounds")
                continue
            occ = np.bincount(popc[start - base:end - base],
                              minlength=self.ngenomes + 1)
            for g in same[(start, end)]:
                g[4] += occ

    def _write_genes(self, genes: list):
        """gene.bed.gz + .csi (chr, start, end, name, genes with 1 and with
        N genomes present) and bitsum.genes.tsv (per-chromosome sums of
        the histograms, chromosomes in order of appearance)."""
        N = self.ngenomes
        write_tabix([(c, s, e, _na(name), h[1], h[N])
                     for c, s, e, name, h in genes],
                    self.tabix_fname("gene"), self.tabix_idx_fname("gene"))
        sums: dict[str, np.ndarray] = {}
        for c, _, _, _, h in genes:
            sums[c] = sums[c] + h if c in sums else h.copy()
        _write_tsv(self.chr_genes_fname, ["chr"] + list(range(N + 1)),
                   [[c] + [int(v) for v in h] for c, h in sums.items()])

    def run_annotate(self, gff_file=None, logfile=None, nogene=False, *,
                     device="cuda"):
        """(Re-)annotate from the existing bitmap: panagram_tpu's
        Genome.run_annotate (`logfile` as in run_anchor).  Each
        chromosome's genes are counted over one read of its bitmap rows
        [first gene start, min(size, last gene end)), whose per-position
        occupancy comes from the fused_popcount_colsums kernel on
        `device`.  chrs.tsv is left as it is."""
        if logfile:
            init_logger(logfile)
        if gff_file is not None:
            self.gff = gff_file
        self.annotated = True
        if self.chrs is None:
            raise ValueError(f"genome '{self.name}' has no anchor/{self.name}/"
                             "chrs.tsv: annotate needs an anchored genome")
        genes = self._init_gff()
        if nogene:
            return
        sizes = {c[0]: c[2] for c in self.chrs}
        for chrom, on in _by_chrom(genes).items():
            if chrom not in sizes:
                logger.warning(f"Skipping genes at {chrom}, chromosome not "
                               "found")
                continue
            st = min(g[1] for g in on)
            en = min(sizes[chrom], max(g[2] for g in on))
            _, rows = self.query_rows(chrom, st, en)
            self._add_gene_hists(on, chrom,
                                 bitmap_occupancy(rows, self.ngenomes, device),
                                 st)
        self._write_genes(genes)

    # ---------------- read path (panagram_tpu's read mode) ----------------

    @property
    def gene_tabix_cols(self) -> list:
        return GENE_COLS + [1, self.ngenomes]

    def init_read(self):
        """Open the bitmaps and the tabix files and load the summaries, as
        panagram_tpu's Genome.init_read: bitsum_bins (rows (chr, start),
        columns the occupancies 0..N), bitsum_chrs (per chromosome, by
        name), bitsum_total (a Series over 0..N), their frequency forms
        bitfreq_bins and bitfreq_chrs; gene_tabix and anno_tabix (TabixFile
        or None) and annotated; gff_anno_types and anno_type_ids (a dict
        for panagram_tpu's Series); bitsum_genes and bitfreq_genes (zeros
        over the chromosomes and gene_tabix_cols when not annotated);
        total_paircounts; chrom_umaps and genome_umap."""
        self._open_bitmaps()
        t = _read_table(self.bins_fname, "\t")
        names = [c[0] for c in self.chrs]
        self.bitsum_bins = Table(
            np.ascontiguousarray(t.values[:, 2:]),
            [(names[c], s) for c, s in t.values[:, :2].tolist()],
            [int(c) for c in t.columns[2:]])
        chrom = sorted({c for c, _ in self.bitsum_bins.index})
        slot = {c: i for i, c in enumerate(chrom)}
        sums = np.zeros((len(chrom), len(self.bitsum_bins.columns)), np.int64)
        np.add.at(sums, [slot[c] for c, _ in self.bitsum_bins.index],
                  self.bitsum_bins.values)
        self.bitsum_chrs = Table(sums, chrom, self.bitsum_bins.columns)
        self.bitsum_total = Table(self.bitsum_bins.values.sum(axis=0),
                                  self.bitsum_bins.columns)
        self.bitfreq_bins = _frequencies(self.bitsum_bins)
        self.bitfreq_chrs = _frequencies(self.bitsum_chrs)

        self.gene_tabix = self._load_tabix("gene")
        self.anno_tabix = self._load_tabix("anno")
        self.annotated = self.gene_tabix is not None \
            or self.anno_tabix is not None
        self._init_anno_types()
        if self.annotated and os.path.exists(self.chr_genes_fname):
            t = _read_table(self.chr_genes_fname, "\t", "chr")
            self.bitsum_genes = Table(t.values, t.index,
                                      [int(c) for c in t.columns])
            self.bitfreq_genes = _frequencies(self.bitsum_genes)
        else:
            self.bitsum_genes = self.bitfreq_genes = Table(
                np.zeros((len(self.chrs), len(self.gene_tabix_cols)),
                         np.int64), names, self.gene_tabix_cols)
        self.total_paircounts = (
            _read_table(self.paircounts_fname, ",", "name")
            if os.path.exists(self.paircounts_fname) else None)
        self.load_umaps()

    def _open_bitmaps(self):
        """One reader per stored step, and each chromosome's size and first
        row per step (panagram_tpu's bitmaps, sizes and offsets).  Queries
        take _query_lock: a reader keeps a position, and queries may come
        from several threads."""
        self.offsets = {}
        for step in self.steps:
            base, first = 0, {}
            for name, _, size, _ in self.chrs:
                first[name] = base
                base += -(-size // step)
            self.offsets[step] = first
        self._query_lock = threading.Lock()
        self.bitmaps = {s: BgzfReader(self.bitmap_gz_fname(s),
                                      self.bitmap_gzi_fname(s))
                        for s in self.steps}

    def _init_anno_types(self):
        """gff_anno_types (a set) and anno_type_ids (type -> id, "exon"
        first with id 0 when present, else ids from 1) from
        anno_types.txt; both None without it."""
        self.gff_anno_types = self.anno_type_ids = None
        if not os.path.exists(self.anno_types_fname):
            return
        with open(self.anno_types_fname) as f:
            types = [t.strip() for t in f if t.strip()]
        id0 = 1
        if "exon" in types:
            types = ["exon"] + [t for t in types if t != "exon"]
            id0 = 0
        self.gff_anno_types = set(types)
        self.anno_type_ids = {t: id0 + i for i, t in enumerate(types)}

    def _load_tabix(self, typ):
        fname = self.tabix_fname(typ)
        if not os.path.exists(fname):
            return None
        return TabixFile(fname, self.tabix_idx_fname(typ))

    def load_umaps(self):
        """chrom_umaps (rows by chrom) and genome_umap, or None."""
        self.chrom_umaps = (
            _read_table(self.chrom_umaps_filename, ",", "chrom")
            if os.path.exists(self.chrom_umaps_filename) else None)
        self.genome_umap = (_read_table(self.genome_umap_filename)
                            if os.path.exists(self.genome_umap_filename)
                            else None)

    def query_rows(self, name, start=None, end=None, step=1):
        """Bitmap rows of chromosome `name` over [start, end) at `step`:
        (positions, uint8 [rows, nbytes]).  Rows come from the coarsest
        stored resolution whose step divides `step`, thinned to it; the
        semantics of panagram_tpu.index.Genome.query."""
        if self.bitmaps is None:
            self._open_bitmaps()
        start = 0 if start is None else start
        end = self.seq_len(name) if end is None else end
        stored = max((s for s in self.steps if step % s == 0), default=1)
        row_base = self.offsets[stored][name] + start // stored
        n_rows = (end - 1 - start) // stored + 1
        with self._query_lock:
            raw = self.bitmaps[stored].read_at(row_base * self.nbytes,
                                               n_rows * self.nbytes)
        mat = np.frombuffer(raw, np.uint8).reshape(-1, self.nbytes)
        thin = step // stored
        if thin > 1:
            mat = mat[::thin]
        positions = np.arange(start, end, step)
        return positions, mat[:len(positions)]

    def query(self, name, start=None, end=None, step=1) -> Table:
        """Presence bits of chromosome `name` over [start, end) at `step`:
        uint8 [rows, N], the rows labelled by position, the columns by
        genome (panagram_tpu's Genome.query)."""
        positions, rows = self.query_rows(name, start, end, step)
        bits = np.unpackbits(rows, axis=1, bitorder="little")
        return Table(bits[:, :self.ngenomes], positions,
                     self.index.genome_names)

    def query_genes(self, chrom=None, start=None, end=None) -> Table:
        """Genes overlapping [start, end) of `chrom` (every gene without
        `chrom`): columns chr, start, end, name and the genes' counts of
        positions present in 1 and in N genomes (ints); no rows when the
        genome has no genes or `chrom` is unknown."""
        rows = []
        if self.gene_tabix is not None:
            try:
                rows = list(self.gene_tabix.fetch(chrom, start, end))
            except ValueError:
                rows = []
        vals = np.empty((len(rows), len(self.gene_tabix_cols)), object)
        for i, (c, s, e, name, one, alln) in enumerate(rows):
            vals[i] = [c, int(s), int(e), name, int(one), int(alln)]
        return Table(vals, np.arange(len(rows)), self.gene_tabix_cols)

    def query_anno(self, chrom, start, end) -> Table:
        """Annotations overlapping [start, end) of `chrom`: columns
        TABIX_COLS and type_id (the type's anno_type_ids entry, NaN where
        it has none); only TABIX_COLS when the genome has no annotation
        table."""
        if self.anno_tabix is None:
            return Table(np.empty((0, len(TABIX_COLS)), object),
                         np.arange(0), TABIX_COLS)
        try:
            rows = list(self.anno_tabix.fetch(chrom, start, end))
        except ValueError:
            rows = []
        ids = self.anno_type_ids or {}
        vals = np.empty((len(rows), len(TABIX_COLS) + 1), object)
        for i, (c, s, e, typ, name) in enumerate(rows):
            vals[i] = [c, int(s), int(e), typ, name,
                       ids.get(typ, float("nan"))]
        return Table(vals, np.arange(len(rows)), TABIX_COLS + ["type_id"])

    def close(self):
        """Close the bitmap readers (reopened by the next query) and the
        tabix files."""
        for r in (self.bitmaps or {}).values():
            r.close()
        self.bitmaps = None
        for t in (self.gene_tabix, self.anno_tabix):
            if t is not None:
                t.close()

    def write_umaps(self):
        """chrom_umaps.csv (each chromosome's bins of chrom_umap.bin_size
        embedded on their own) and genome_umap.csv (all bins of
        genome_umap.bin_size embedded together), from the low-resolution
        bitmap: panagram_tpu's Genome.write_umaps."""
        from .umap_embed import run_embedding

        conf = self.index.conf
        header = ["chrom", "start", "end", "umap1", "umap2", "cluster"]
        chrom_rows = []
        genome = ([], [], [])
        for name, _, _, _ in self.chrs:
            bits = self.query(name, step=self.index.lowres_step)
            starts, pc = bitmap_to_paircount_bins(bits.index, bits.values,
                                                  conf.chrom_umap.bin_size)
            chrom_rows += run_embedding([name] * len(starts), starts, pc,
                                        conf.chrom_umap, self.name)
            starts, pc = bitmap_to_paircount_bins(bits.index, bits.values,
                                                  conf.genome_umap.bin_size)
            genome[0].extend([name] * len(starts))
            genome[1].append(starts)
            genome[2].append(pc)
        _write_tsv(self.chrom_umaps_filename, header, chrom_rows, ",")
        _write_tsv(self.genome_umap_filename, header, run_embedding(
            genome[0], np.concatenate(genome[1]), np.concatenate(genome[2]),
            conf.genome_umap, self.name), ",")
