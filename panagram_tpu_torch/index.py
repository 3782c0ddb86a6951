"""The pan-kmer index, write path: samples, config, anchoring, annotation.

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
hash order).  The read path is what the write path needs: ``query`` reads
bitmap rows back for the embeddings and for ``annotate``; the viewer and
the other readers stay with panagram_tpu.index, which opens this package's
output.
"""

from __future__ import annotations

import csv
import logging
import os
import re
import time

import numpy as np

from .config import IndexConfig, config_path, samples_path
from .io.bgzf import BgzfReader, BgzfWriter
from .io.fasta import FastaFile, iter_fasta, seq_to_codes
from .io.gff import split_gff
from .io.tabix import write_tabix

logger = logging.getLogger(__name__)

NAME_REGEX = "[A-Za-z0-9_-]+"
ANCHOR_DIR = "anchor"
FASTQ_EXTS = (".fastq", ".fastq.gz", ".fq", ".fq.gz")

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


class Index:
    """Write handle on an index directory.

    Index(samples_tsv, prefix=..., **params) -> initializes config.yaml and
                                                samples.tsv
    Index(index_dir)                         -> resumes an initialized dir
    """

    def __init__(self, input, prefix=None, **params):
        self.conf = IndexConfig()
        # a mesh build's per-rank reports (pipeline.build_index)
        self.mesh_ranks = None
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
        self.annotated = gff is not None
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
        return os.path.join(self.prefix, f"bitmap.{step}.gz")

    def bitmap_gzi_fname(self, step):
        return os.path.join(self.prefix, f"bitmap.{step}.gzi")

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
        return os.path.join(self._peer_anchor_dir(0, me), f"bitmap.{step}.gz")

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

    def run_anchor(self, bucketed=None, mesh=None, sharded=None):
        """Anchor this genome and write its anchor/<name>/ files: against
        `bucketed` (a BucketedDict whose table is on the compute device),
        or, called by every rank of `mesh`, against `sharded` (this rank's
        part of a parallel.shard dictionary).  On a mesh only writer ranks
        write; with per-process piece writes (range strategy, several
        processes, parallel.mesh.sharded_writes_enabled) each writer writes
        its ranks' bitmap rows as pieces and process 0 stitches them."""
        if not self.anchored:
            logger.info(f"Skipping non-anchor genome '{self.name}'")
            return
        k = self.index.k
        N = self.ngenomes
        nbytes = self.nbytes
        lowres = self.index.lowres_step
        if self.chrs is None:
            self.init_chrs()
        chunk = self._anchor_chunk()
        pieces = False
        if mesh is None:
            from .ops.anchor import stream_anchor_chunks

            def chunks(codes, nkmers):
                return stream_anchor_chunks(codes, nkmers, chunk, bucketed,
                                            nbytes, N, k)
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
                popc_full = np.empty(nkmers, np.int16) if genes else None

                it = chunks(codes, nkmers)
                while True:
                    t0 = time.perf_counter()
                    item = next(it, None)
                    phase["drain"] += time.perf_counter() - t0
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

    def run_annotate(self, gff_file=None, nogene=False, device="cpu"):
        """(Re-)annotate from the existing bitmap: panagram_tpu's
        Genome.run_annotate.  Each chromosome's genes are counted over one
        read of its bitmap rows [first gene start, min(size, last gene
        end)), whose per-position occupancy comes from the
        fused_popcount_colsums kernel on `device`.  chrs.tsv is left as it
        is."""
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

    # ---------------- read path ----------------

    def query_rows(self, name, start=None, end=None, step=1):
        """Bitmap rows of chromosome `name` over [start, end) at `step`:
        (positions, uint8 [rows, nbytes]).  Rows come from the coarsest
        stored resolution whose step divides `step`, thinned to it; the
        semantics of panagram_tpu.index.Genome.query."""
        size = {c[0]: c[2] for c in self.chrs}[name]
        start = 0 if start is None else start
        end = size if end is None else end
        stored = max((s for s in self.steps if step % s == 0), default=1)
        row_base = start // stored
        for cname, _, csize, _ in self.chrs:
            if cname == name:
                break
            row_base += -(-csize // stored)
        n_rows = (end - 1 - start) // stored + 1
        with BgzfReader(self.bitmap_gz_fname(stored),
                        self.bitmap_gzi_fname(stored)) as r:
            raw = r.read_at(row_base * self.nbytes, n_rows * self.nbytes)
        mat = np.frombuffer(raw, np.uint8).reshape(-1, self.nbytes)
        thin = step // stored
        if thin > 1:
            mat = mat[::thin]
        positions = np.arange(start, end, step)
        return positions, mat[:len(positions)]

    def query(self, name, start=None, end=None, step=1):
        """(positions, presence bits uint8 [rows, N]) of query_rows."""
        positions, rows = self.query_rows(name, start, end, step)
        bits = np.unpackbits(rows, axis=1, bitorder="little")
        return positions, bits[:, :self.ngenomes]

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
            positions, bits = self.query(name, step=self.index.lowres_step)
            starts, pc = bitmap_to_paircount_bins(positions, bits,
                                                  conf.chrom_umap.bin_size)
            chrom_rows += run_embedding([name] * len(starts), starts, pc,
                                        conf.chrom_umap, self.name)
            starts, pc = bitmap_to_paircount_bins(positions, bits,
                                                  conf.genome_umap.bin_size)
            genome[0].extend([name] * len(starts))
            genome[1].append(starts)
            genome[2].append(pc)
        _write_tsv(self.chrom_umaps_filename, header, chrom_rows, ",")
        _write_tsv(self.genome_umap_filename, header, run_embedding(
            genome[0], np.concatenate(genome[1]), np.concatenate(genome[2]),
            conf.genome_umap, self.name), ",")
