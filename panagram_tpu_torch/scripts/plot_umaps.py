"""Batch embedding plots, as scripts/plot_umaps.py: the bins' paircount
profiles of one chromosome or ALL embedded in 2-D (umap_embed's PCA
branch), clustered with DBSCAN, and drawn as scatter PNGs coloured by
cluster, by position and (for several chromosomes) by chromosome, plus a
PCA panel whose axes carry the explained variance.

Usage:
  python -m panagram_tpu_torch.scripts.plot_umaps <index_dir> <anchor>
      <chrom|ALL> [--bin-size N] [--step N] [--eps F] [--neighbors N]
      [--min-dist F] [--out DIR]

matplotlib is imported by ``render``, the only function that draws; where
it is missing the script raises naming it after printing the bin count.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..index import Index
from ..umap_embed import _embed, dbscan_labels, pca_fit


def chrom_bins(index, anchor, chrom, bin_size, step):
    """One chromosome's per-bin paircount profiles: (matrix [bins,
    genomes] with empty bins 0, the chromosome per bin, the bins' starts in
    base pairs)."""
    size = int(index.genomes[anchor].seq_len(chrom))
    bitmap = index.query_bitmap(anchor, chrom, 0, size, step)
    _, paircounts = index.bitmap_to_bins(bitmap, bin_size)
    pc = np.nan_to_num(paircounts.values, nan=0.0)
    starts = np.asarray(paircounts.columns)
    return pc.T, [chrom] * pc.shape[1], starts


def render(out_dir: str, tag: str, title: str, emb, clusters, starts,
           chrom_codes, pcs, ratio):
    """Write the scatter PNGs and the PCA panel; returns their paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []

    def save(fig, fname):
        path = os.path.join(out_dir, fname)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        print("wrote", path)
        paths.append(path)

    def scatter(c, label, fname, cmap="Spectral"):
        fig, ax = plt.subplots(figsize=(7, 6))
        sc = ax.scatter(emb[:, 0], emb[:, 1], c=c, s=10, alpha=0.7,
                        cmap=cmap)
        fig.colorbar(sc, ax=ax, label=label)
        ax.set_xlabel("dim 1")
        ax.set_ylabel("dim 2")
        ax.set_title(f"{title} bin embedding ({label})")
        save(fig, fname)

    scatter(clusters, "cluster", f"umap.cluster.{tag}.png")
    scatter(starts, "position (bp)", f"umap.pos.{tag}.png", cmap="viridis")
    if chrom_codes is not None:
        scatter(chrom_codes, "chromosome", f"umap.chrom.{tag}.png",
                cmap="tab20")

    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(pcs[:, 0], pcs[:, 1] if pcs.shape[1] > 1 else
                    np.zeros(len(pcs)), c=clusters, s=10, alpha=0.6,
                    cmap="rainbow")
    ax.set_xlabel(f"PC 1: {ratio[0]:.3f}")
    if pcs.shape[1] > 1:
        ax.set_ylabel(f"PC 2: {ratio[1]:.3f}")
    fig.colorbar(sc, ax=ax, label="cluster")
    save(fig, f"pca.{tag}.png")
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plot_umaps")
    ap.add_argument("index_dir")
    ap.add_argument("anchor")
    ap.add_argument("chrom", help="chromosome name or ALL")
    ap.add_argument("--bin-size", type=int, default=100_000)
    ap.add_argument("--step", type=int, default=100)
    ap.add_argument("--eps", type=float, default=1.0)
    ap.add_argument("--neighbors", type=int, default=4)
    ap.add_argument("--min-dist", type=float, default=0.0)
    ap.add_argument("--out", default="umap_plots")
    args = ap.parse_args(argv)

    index = Index(args.index_dir)
    chroms = ([c[0] for c in index.genomes[args.anchor].chrs]
              if args.chrom == "ALL" else [args.chrom])

    mats, chrom_list, starts = [], [], []
    for c in chroms:
        m, cl, st = chrom_bins(index, args.anchor, c, args.bin_size,
                               args.step)
        mats.append(m)
        chrom_list += cl
        starts.append(st)
    data = np.concatenate(mats, axis=0)
    starts = np.concatenate(starts)
    print(f"{data.shape[0]} bins x {data.shape[1]} genomes")

    # umap-learn is absent, so --neighbors and --min-dist go unused, as in
    # scripts/plot_umaps.py without it
    emb = _embed(data)
    if emb is None:
        sys.exit("too few bins to embed")
    clusters = dbscan_labels(emb, args.eps, 1)
    chrom_codes = None
    if len(chroms) > 1:
        code = {c: i for i, c in enumerate(chroms)}
        chrom_codes = np.array([code[c] for c in chrom_list])
    pcs, ratio = pca_fit(data, min(3, data.shape[1], len(data)))
    render(args.out, f"{args.anchor}.{args.chrom}.bins{args.bin_size}",
           f"{args.anchor} {args.chrom}", emb, clusters, starts, chrom_codes,
           pcs, ratio)
    index.close()


if __name__ == "__main__":
    main()
