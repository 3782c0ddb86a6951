"""Sweep visualization: PR curves, MCC curves and PR-AUC across thresholds,
and the table of every threshold's metrics.

panagram_tpu.intros.visualize without pandas.  The metrics are a list of
records (dicts: threshold, type, chr and the metrics_<type>.tsv columns,
every number a float, as pandas' iterrows gives them), written to
sweep_metrics.tsv as pandas writes the frame.  The plots need matplotlib,
imported at the first plot.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..index import _read_table

COUNTS = ["True Positive", "True Negative", "False Positive",
          "False Negative"]


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the sweep plots need matplotlib, which this "
                          "Python cannot import") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_sweep_metrics(output_dir, thresholds) -> list:
    """Records of metrics_<type>.tsv across <out>/<out>_<thr>/scored/."""
    output_dir = Path(output_dir)
    rows = []
    for thr in thresholds:
        scored = output_dir / f"{output_dir.name}_{thr}" / "scored"
        if not scored.is_dir():
            continue
        for f in scored.glob("metrics_*.tsv"):
            intro_type = f.stem.split("_", 1)[1]
            t = _read_table(str(f), "\t", "")
            for chrom, r in zip(t.index, np.asarray(t.values, float)):
                rows.append({"threshold": float(thr), "type": intro_type,
                             "chr": chrom,
                             **dict(zip(t.columns, r.tolist()))})
    return rows


def write_sweep_metrics(metrics: list, path):
    """The records as ``DataFrame(records).to_csv(sep="\\t",
    index=False)`` writes them: floats as repr, NaN empty."""
    cols = list(dict.fromkeys(k for r in metrics for k in r))

    def cell(v):
        if isinstance(v, float):
            return "" if np.isnan(v) else repr(v)
        return "" if v is None else str(v)

    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        for r in metrics:
            f.write("\t".join(cell(r.get(c, float("nan"))) for c in cols)
                    + "\n")


def _by(metrics: list, key) -> dict:
    """The records grouped by `key`, keys sorted, record order kept within
    a group (pandas' groupby)."""
    out: dict = {}
    for r in metrics:
        out.setdefault(r[key], []).append(r)
    return {k: out[k] for k in sorted(out)}


def _sums(records: list) -> tuple:
    """(thresholds, sums of COUNTS [thresholds, 4]): groupby("threshold")
    [COUNTS].sum()."""
    groups = _by(records, "threshold")
    sums = np.array([[sum(r[c] for r in g) for c in COUNTS]
                     for g in groups.values()], np.float64).reshape(-1, 4)
    return list(groups), sums


def _sort_order(values) -> np.ndarray:
    """pandas' sort_values order: non-NaN by numpy's quicksort, NaN last."""
    values = np.asarray(values, np.float64)
    nan = np.isnan(values)
    idx = np.arange(len(values))
    return np.concatenate([idx[~nan][values[~nan].argsort(kind="quicksort")],
                           idx[nan]])


def mcc(tp, tn, fp, fn):
    denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
    return (tp * tn - fp * fn) / denom if denom else 0.0


def pr_auc(precision, recall):
    """Area under the precision-recall points ordered by recall."""
    precision = np.asarray(precision, np.float64)
    recall = np.asarray(recall, np.float64)
    ok = ~(np.isnan(precision) | np.isnan(recall))
    precision, recall = precision[ok], recall[ok]
    if len(recall) < 2:
        return float("nan")
    order = recall.argsort(kind="quicksort")
    return float(np.trapezoid(precision[order], recall[order]))


def _rates(sums):
    tp, fp, fn = sums[:, 0], sums[:, 2], sums[:, 3]
    with np.errstate(invalid="ignore", divide="ignore"):
        return tp / (tp + fp), tp / (tp + fn)


def plot_pr_curves(metrics, output_dir):
    plt = _pyplot()
    out = Path(output_dir) / "sweep_pr_curve.png"
    fig, ax = plt.subplots(figsize=(6, 5))
    for intro_type, sub in _by(metrics, "type").items():
        thresholds, sums = _sums(sub)
        prec, rec = _rates(sums)
        ax.plot(rec, prec, "o-", label=f"{intro_type} "
                f"(AUC {pr_auc(prec, rec):.3f})")
        for t, r, p in zip(thresholds, rec, prec):
            ax.annotate(f"{t:g}", (r, p), fontsize=6)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1.05)
    ax.set_ylim(0, 1.05)
    ax.legend(fontsize=8)
    ax.set_title("Precision-Recall across thresholds")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out


def plot_per_chr_pr(metrics, output_dir):
    plt = _pyplot()
    out = Path(output_dir) / "sweep_pr_per_chr.png"
    chrs = sorted({r["chr"] for r in metrics})
    fig, axes = plt.subplots(1, max(len(chrs), 1),
                             figsize=(4 * max(len(chrs), 1), 4),
                             squeeze=False)
    for ax, chrom in zip(axes[0], chrs):
        sub = [r for r in metrics if r["chr"] == chrom]
        for intro_type, s2 in _by(sub, "type").items():
            s2 = [s2[i] for i in _sort_order([r["Recall"] for r in s2])]
            ax.plot(np.array([r["Recall"] for r in s2]),
                    np.array([r["Precision"] for r in s2]), "o-",
                    label=intro_type)
        ax.set_title(str(chrom))
        ax.set_xlabel("Recall")
        ax.set_ylabel("Precision")
        ax.legend(fontsize=7)
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out


def plot_mcc(metrics, output_dir):
    plt = _pyplot()
    out = Path(output_dir) / "sweep_mcc.png"
    fig, ax = plt.subplots(figsize=(6, 4))
    for intro_type, sub in _by(metrics, "type").items():
        thresholds, sums = _sums(sub)
        ax.plot(np.array(thresholds), [mcc(*s) for s in sums.tolist()], "o-",
                label=intro_type)
    ax.set_xlabel("threshold")
    ax.set_ylabel("MCC")
    ax.legend(fontsize=8)
    ax.set_title("Matthews correlation across thresholds")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out


def plot_heatmap_montage(output_dir, thresholds, max_tiles=9):
    """3x3 montage of the first scored heatmap of each threshold."""
    output_dir = Path(output_dir)
    pngs = []
    for thr in thresholds:
        d = output_dir / f"{output_dir.name}_{thr}" / "scored" / "heatmaps"
        pngs += sorted(d.glob("*.png"))[:1]
    pngs = pngs[:max_tiles]
    if not pngs:
        return None
    plt = _pyplot()
    cols = 3
    rows = -(-len(pngs) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 5, rows * 3),
                             squeeze=False)
    for ax in axes.flat:
        ax.axis("off")
    for ax, png in zip(axes.flat, pngs):
        ax.imshow(plt.imread(png))
        ax.set_title(png.parent.parent.parent.name, fontsize=7)
    out = output_dir / "sweep_heatmaps.png"
    fig.savefig(out, bbox_inches="tight", dpi=110)
    plt.close(fig)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Sweep visualization")
    p.add_argument("-v", "--visuals", nargs="+",
                   default=["prc", "prcc", "prca", "mcc", "shtmp"])
    p.add_argument("--dir", required=True)
    p.add_argument("--thresholds", nargs="+", type=float, required=True)
    args = p.parse_args(argv)

    metrics = load_sweep_metrics(args.dir, args.thresholds)
    if not metrics:
        print("No sweep metrics found.")
        return
    if "prc" in args.visuals or "prca" in args.visuals:
        plot_pr_curves(metrics, args.dir)
    if "prcc" in args.visuals:
        plot_per_chr_pr(metrics, args.dir)
    if "mcc" in args.visuals:
        plot_mcc(metrics, args.dir)
    if "shtmp" in args.visuals:
        plot_heatmap_montage(args.dir, args.thresholds)
    write_sweep_metrics(metrics, Path(args.dir) / "sweep_metrics.tsv")


if __name__ == "__main__":
    main()
