"""Shared introgression primitives: BED <-> bin conversions, gap and region
filters, centromere merging, file-name conventions and the ground-truth
text matrices.

panagram_tpu.intros.core without pandas.  A BED is a list of rows
(chromosome, start, end, notes); per-bin flags are an ``index.Table`` whose
values are the flags (int64 [bins]) and whose index is the bin starts; a
text matrix is a Table of accessions x bin starts.  Files are read and
written as pandas reads and writes them there.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from ..index import Table, _column

BED_COLS = ["Chromosome", "Start", "End", "Notes"]


def bed_file_is_empty(bed_file) -> bool:
    p = Path(bed_file)
    return (not p.exists()) or p.stat().st_size == 0


def read_bed_file(bed_file):
    """BED -> rows [chromosome, start, end, notes] (its first four
    columns), or None for a missing or empty file."""
    if bed_file_is_empty(bed_file):
        return None
    with open(bed_file) as f:
        fields = [line.rstrip("\n").split("\t") for line in f
                  if line.strip()]
    if any(len(r) < 4 for r in fields):
        raise ValueError(f"{bed_file}: a BED line has fewer than the four "
                         f"columns {BED_COLS}")
    return [[r[0], int(r[1]), int(r[2]), r[3]] for r in fields]


def write_bed(rows, path):
    """BED rows as ``DataFrame.to_csv(path, header=False, index=False,
    sep="\\t")`` writes them; no rows, an empty file."""
    with open(path, "w") as f:
        f.writelines("\t".join(str(v) for v in r) + "\n" for r in rows)


def bin_starts(bin_size, chr_length) -> np.ndarray:
    return np.arange(math.ceil(chr_length / bin_size), dtype=np.int64) \
        * bin_size


def get_intro_df_template(bin_size, chr_length) -> Table:
    """panagram_tpu's template of one chromosome's bins: one row of zeros
    (row label 0), a column per bin start."""
    starts = bin_starts(bin_size, chr_length)
    return Table(np.zeros((1, len(starts)), np.int64), [0], starts.tolist())


def bed_to_bins(bed, bin_size, chr_length) -> Table:
    """BED rows -> per-bin 0/1 flags, each coordinate rounded to the
    nearest bin (half to even); an event shorter than its rounding but at
    least a quarter bin long flags its start's bin."""
    starts = bin_starts(bin_size, chr_length)
    flags = np.zeros(len(starts), np.int64)
    if bed:
        lo = np.array([r[1] for r in bed], np.int64)
        hi = np.array([r[2] for r in bed], np.int64)
        start_bin = (np.round(lo / bin_size) * bin_size).astype(np.int64)
        end_bin = (np.round(hi / bin_size) * bin_size).astype(np.int64)
        last = starts[-1]
        for s, e, st, en in zip(start_bin.tolist(), end_bin.tolist(),
                                lo.tolist(), hi.tolist()):
            labels = list(range(s, e, bin_size))
            if not labels and (en - st) >= bin_size / 4:
                labels = [s]
            for lab in labels:
                if lab <= last:
                    flags[lab // bin_size] = 1
    return Table(flags, starts)


def bins_to_bed(bins: Table, bin_size, chr_name, comp_group) -> list:
    """Per-bin flags -> BED rows: each run of adjacent flagged bins (flag >
    0) is one row, end = start + n * bin_size - 1."""
    starts = np.asarray(bins.index, np.int64)[np.asarray(bins.values) > 0]
    out = []
    i = 0
    while i < len(starts):
        j = i + 1
        while j < len(starts) and starts[j] == starts[j - 1] + bin_size:
            j += 1
        start = int(starts[i])
        out.append((chr_name, start, start + (j - i) * bin_size - 1,
                    f"{comp_group}_intro"))
        i = j
    return out


def fill_gaps(row, gap_size):
    """Fill 0-gaps of length <= gap_size between introgressed runs."""
    arr = np.asarray(row, dtype=int).copy()
    i = 0
    n = len(arr)
    while i < n:
        if arr[i] == 1:
            while i < n and arr[i] == 1:
                i += 1
            region_start = i
            while i < n and arr[i] == 0:
                i += 1
            region_end = i
            if i < n and region_end - region_start <= gap_size:
                arr[region_start:region_end] = 1
        else:
            i += 1
    return arr


def remove_small_regions(row, min_size):
    """Drop 1-runs shorter than min_size bins."""
    arr = np.asarray(row, dtype=int).copy()
    i = 0
    n = len(arr)
    while i < n:
        if arr[i] == 1:
            start = i
            while i < n and arr[i] == 1:
                i += 1
            if i - start < min_size:
                arr[start:i] = 0
        else:
            i += 1
    return arr


def merge_centromere_regions(bed, chrom_seqs, bin_size):
    """Merge introgressions separated by exactly 2 bins when the gap holds a
    centromere-like run of >= 50 N's.  chrom_seqs: {chrom: sequence}.  The
    rows are ordered by start as pandas' sort_values orders them (numpy's
    quicksort)."""
    if not bed:
        return bed
    order = np.argsort(np.array([r[1] for r in bed], np.int64),
                       kind="quicksort")
    rows = [list(bed[i]) for i in order]
    merged = [rows[0]]
    for r in rows[1:]:
        prev = merged[-1]
        gap_bins = (r[1] - prev[2]) / bin_size
        if gap_bins == 2 and r[0] == prev[0]:
            seq = chrom_seqs.get(r[0], "")
            if "N" * 50 in seq[int(prev[2]):int(r[1])]:
                prev[2] = r[2]
                continue
        merged.append(list(r))
    return [[c, int(s), int(e), n] for c, s, e, n in merged]


def get_bed_pieces(bed_file, accession_candidates):
    """Parse <accession>_<chromosome>_<intro_type>.bed; the accession is
    the longest matching prefix."""
    stem = Path(bed_file).stem
    if "_" in stem:
        stem_no_intro, intro_type = stem.rsplit("_", 1)
        matches = [
            a for a in accession_candidates
            if stem_no_intro == a or stem_no_intro.startswith(f"{a}_")
        ]
        if matches:
            accession = max(matches, key=len)
            chrom = stem_no_intro[len(accession):].lstrip("_")
            if chrom:
                return chrom, accession, intro_type
    raise ValueError(
        f"Unable to parse bed file name '{stem}'. Expected "
        "'<accession>_<chromosome>_<intro_type>.bed'."
    )


def read_text_file(text_file) -> Table:
    """A per-chromosome ground-truth or prediction matrix (rows =
    accessions, columns = bin starts), as ``pd.read_csv(sep="\\t",
    header=0, index_col=0).fillna(0)`` reads it: int64 values, float64
    where a column holds a non-integer or an empty cell (then 0)."""
    with open(text_file) as f:
        header, *rows = [line.rstrip("\n").split("\t") for line in f
                         if line.strip()]
    cols = [_column(c) for c in zip(*[r[1:] for r in rows])] if rows else []
    if any(isinstance(x, float) for c in cols for x in c):
        vals = np.array(cols, np.float64).T.reshape(len(rows), -1)
        vals[np.isnan(vals)] = 0
    else:
        vals = np.array(cols, np.int64).T.reshape(len(rows), -1)
    return Table(vals, [r[0] for r in rows], [int(c) for c in header[1:]],
                 header[0])


def merge_text_files(text_files) -> Table:
    """Text matrices of one chromosome stacked, then per accession the
    largest value of each bin, accessions sorted (``pd.concat(...)
    .groupby(level=0).max()``)."""
    tables = [read_text_file(f) for f in text_files]
    cols = tables[0].columns
    if any(t.columns != cols for t in tables):
        raise ValueError("ground-truth matrices of one chromosome must have "
                         "the same bins")
    names = sorted({n for t in tables for n in t.index})
    vals = np.stack([np.max([t.values[i] for t in tables
                             for i, m in enumerate(t.index) if m == n],
                            axis=0) for n in names])
    index_name = {t.index_name for t in tables}
    return Table(vals, names, cols,
                 index_name.pop() if len(index_name) == 1 else None)


def write_matrix(t: Table, path):
    """A matrix Table as ``DataFrame.to_csv(path, sep="\\t")`` writes it:
    floats as repr, NaN empty."""
    def cell(v):
        if isinstance(v, (float, np.floating)):
            return "" if np.isnan(v) else repr(float(v))
        return str(v)

    with open(path, "w") as f:
        f.write((t.index_name or "") + "\t"
                + "\t".join(str(c) for c in t.columns) + "\n")
        for name, row in zip(t.index, t.values.tolist()):
            f.write(str(name) + "\t" + "\t".join(cell(v) for v in row)
                    + "\n")
