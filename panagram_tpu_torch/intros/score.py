"""Introgression scoring: confusion metrics against the ground truth.

panagram_tpu.intros.score on the port's read API, without pandas: merge the
per-accession predicted BEDs into bin-space matrices, threshold them,
optionally postprocess the ground truth (fgap / fcen / rmbn), count
TP / TN / FP / FN with accuracy, precision, recall and FPR per chromosome x
introgression type, write metrics_<type>.tsv as pandas' to_csv writes it
(floats as repr, NaN empty) and render the scored heatmaps (matplotlib).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..index import Table
from ..io.fasta import iter_fasta
from .core import (
    bed_to_bins,
    bin_starts,
    bins_to_bed,
    fill_gaps,
    get_bed_pieces,
    merge_centromere_regions,
    merge_text_files,
    read_bed_file,
    read_text_file,
    remove_small_regions,
    write_matrix,
)

METRICS = ["True Positive", "True Negative", "False Positive",
           "False Negative", "Accuracy", "Precision", "Recall", "FPR"]


def merge_bed_files(bed_files, index, bin_size, chr_length):
    """Per-accession BEDs -> a Table accession x bin (an accession's later
    BED replaces an earlier one in its row), or None without BEDs."""
    rows = {}
    starts = None
    for f in bed_files:
        _, acc, _ = get_bed_pieces(f, index.genomes.keys())
        bins = bed_to_bins(read_bed_file(f), bin_size, chr_length)
        rows[acc] = bins.values
        starts = bins.index
    if not rows:
        return None
    return Table(np.stack(list(rows.values())), list(rows), list(starts))


def threshold_matrices(pred: Table, gt: Table, threshold):
    """The ground truth thresholded at `threshold`, the predictions
    binarized, both int."""
    g = np.where(gt.values < threshold, 0, gt.values)
    g = np.where(g != 0, 1, g).astype(int)
    p = np.where(pred.values < 1, 0, pred.values)
    p = np.where(p != 0, 1, p).astype(int)
    return (Table(p, pred.index, pred.columns, pred.index_name),
            Table(g, gt.index, gt.columns, gt.index_name))


def score_introgressions(pred: Table, gt: Table) -> list:
    """Confusion counts and rates over the accessions of both matrices:
    the values of METRICS."""
    if list(pred.columns) != list(gt.columns):
        raise ValueError("predictions and ground truth have different bins")
    shared = sorted(set(pred.index) & set(gt.index))
    pi, gi = list(pred.index), list(gt.index)
    p = pred.values[[pi.index(n) for n in shared]].reshape(len(shared), -1)
    g = gt.values[[gi.index(n) for n in shared]].reshape(len(shared), -1)
    total = g.size
    tp = ((p == 1) & (g == 1)).sum()
    tn = ((p == 0) & (g == 0)).sum()
    fp = ((p == 1) & (g == 0)).sum()
    fn = ((p == 0) & (g == 1)).sum()
    with np.errstate(invalid="ignore", divide="ignore"):
        acc = (tp + tn) / total if total else np.nan
        precision = tp / (tp + fp) if (tp + fp) else np.nan
        recall = tp / (tp + fn) if (tp + fn) else np.nan
        fpr = fp / (fp + tn) if (fp + tn) else np.nan
    return [tp, tn, fp, fn, acc, precision, recall, fpr]


def write_metrics(rows: dict, path):
    """{chromosome: METRICS values} as ``DataFrame.to_csv(sep="\\t")``
    writes the metrics frame: the counts as ints, the rates as repr, NaN
    empty."""
    def cell(v):
        if isinstance(v, (float, np.floating)):
            return "" if np.isnan(v) else repr(float(v))
        return str(int(v))

    with open(path, "w") as f:
        f.write("\t" + "\t".join(METRICS) + "\n")
        for chrom, vals in rows.items():
            f.write(f"{chrom}\t" + "\t".join(cell(v) for v in vals) + "\n")


def create_scored_heatmap(pred: Table, gt: Table, output_file, groups=None):
    """TP/FP/TN/FN heatmap (matplotlib's Figure API, not pyplot: the runner
    scores thresholds from a thread pool)."""
    try:
        from matplotlib.colors import ListedColormap
        from matplotlib.figure import Figure
    except ImportError as e:
        raise ImportError("scored heatmaps need matplotlib, which this "
                          "Python cannot import") from e

    shared = sorted(set(pred.index).intersection(set(gt.index)))
    if groups is not None:
        ordered = [n for n in groups if n in shared]
        shared = ordered or shared
    p = np.stack([pred.values[list(pred.index).index(n)] for n in shared])
    g = np.stack([gt.values[list(gt.index).index(n)] for n in shared])
    # 0=TN 1=FP 2=FN 3=TP
    code = p + 2 * g
    cmap = ListedColormap(["#f0f0f0", "#d62728", "#ff7f0e", "#2ca02c"])
    fig = Figure(figsize=(10, 0.3 * len(shared) + 1.5))
    ax = fig.subplots()
    ax.imshow(code, aspect="auto", cmap=cmap, vmin=0, vmax=3,
              interpolation="nearest")
    ax.set_yticks(range(len(shared)), shared, fontsize=7)
    ax.set_xlabel("bin")
    ax.set_title("TN grey / FP red / FN orange / TP green", fontsize=9)
    fig.savefig(output_file, bbox_inches="tight")


def rescale_prediction_row(row, starts, original_bin_size, new_bin_size,
                           chr_length) -> np.ndarray:
    """Re-bin a prediction row to the ground truth's bin size."""
    bed = bins_to_bed(Table(row, starts), original_bin_size, "nan", "nan")
    return bed_to_bins(bed or None, new_bin_size, chr_length).values


def score(index, pred_dir, gt_path, ref, output_dir, bin_size=1_000_000,
          min_bins=4, gap_bins=1, gt_threshold=0.5, comp_groups=None,
          actions=None, render_vis=False, groups=None):
    """Score every predicted BED of pred_dir (or the one BED pred_dir)."""
    pred_path = Path(pred_dir)
    bed_files = ([pred_path] if pred_path.is_file()
                 else sorted(pred_path.glob("*.bed")))
    gt_path = Path(gt_path)
    output_dir = Path(output_dir)
    (output_dir / "pred").mkdir(parents=True, exist_ok=True)
    (output_dir / "gt_postprocessed").mkdir(parents=True, exist_ok=True)
    if render_vis:
        (output_dir / "heatmaps").mkdir(parents=True, exist_ok=True)

    ref_genome = index.genomes[ref]

    chrs, intro_types = set(), set()
    for f in bed_files:
        chrom, _, ityp = get_bed_pieces(f, index.genomes.keys())
        chrs.add(chrom)
        intro_types.add(ityp)

    all_metrics = {}
    for chrom in sorted(chrs):
        for intro_type in sorted(intro_types):
            if gt_path.is_file():
                gt = read_text_file(gt_path)
            elif intro_type in ("REF", "REFA", "merged"):
                if not comp_groups:
                    raise ValueError("--cmp required for REF/merged scoring")
                files = []
                for grp in comp_groups:
                    files += list(gt_path.glob(f"{chrom}_{grp}.txt"))
                if not files:
                    raise ValueError(f"no ground truth for {chrom}")
                gt = merge_text_files(files)
            else:
                files = list(gt_path.glob(f"{chrom}_{intro_type}.txt"))
                if not files:
                    raise ValueError(
                        f"no ground truth {chrom}_{intro_type}.txt")
                gt = read_text_file(files[0])

            chr_length = int(ref_genome.sizes[chrom])
            sel = [f for f in bed_files
                   if f.name.endswith(f"_{chrom}_{intro_type}.bed")]
            pred = merge_bed_files(sel, index, bin_size, chr_length)
            if pred is None or not len(pred.columns):
                continue
            write_matrix(pred,
                         output_dir / "pred" / f"{chrom}_{intro_type}.txt")

            pred, gt = threshold_matrices(pred, gt, gt_threshold)

            gt_bin_size = (int(gt.columns[1]) if len(gt.columns) > 1
                           else bin_size)
            eff_bin = bin_size
            if bin_size != gt_bin_size:
                rows = [rescale_prediction_row(r, pred.columns, bin_size,
                                               gt_bin_size, chr_length)
                        for r in pred.values]
                pred = Table(np.stack(rows), pred.index,
                             list(bin_starts(gt_bin_size, chr_length)))
                eff_bin = gt_bin_size

            if actions:
                vals = gt.values
                for action in actions:
                    if action == "fgap":
                        vals = np.stack([fill_gaps(r, gap_bins) for r in vals])
                    elif action == "rmbn":
                        vals = np.stack([remove_small_regions(r, min_bins)
                                         for r in vals])
                    elif action == "fcen":
                        seqs = dict(iter_fasta(ref_genome._fasta_path))
                        out = []
                        for r in vals:
                            bed = bins_to_bed(Table(r, gt.columns), eff_bin,
                                              chrom, "gt")
                            merged = merge_centromere_regions(bed, seqs,
                                                              eff_bin)
                            out.append(bed_to_bins(merged, eff_bin,
                                                   chr_length).values)
                        vals = np.stack(out)
                gt = Table(vals, gt.index, gt.columns, gt.index_name)
                write_matrix(gt, output_dir / "gt_postprocessed"
                             / f"{chrom}_{intro_type}.txt")

            metrics = score_introgressions(pred, gt)
            if render_vis:
                create_scored_heatmap(
                    pred, gt,
                    output_dir / "heatmaps" / f"{chrom}_{intro_type}.png",
                    groups=groups)
            all_metrics.setdefault(intro_type, {})[chrom] = metrics

    for intro_type, rows in all_metrics.items():
        write_metrics(rows, output_dir / f"metrics_{intro_type}.tsv")
    return all_metrics
