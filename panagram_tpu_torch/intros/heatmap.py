"""Standalone k-mer-similarity heatmaps (``intros heatmap``).

panagram_tpu.intros.heatmap on the port's read API: for each chromosome of
an anchor genome, bin the bitmap (optionally omitting fixed k-mers) and
render a similarity heatmap into <index>/panagram_visuals/ (matplotlib).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..index import Index
from .call import bitmap_to_bins, read_groups, visualize


def panagram_heatmap_general(index_dir, anchor, groups_tsv=None,
                             bin_size=1_000_000, step=100, rmf=True,
                             out_dir=None):
    index = Index(str(index_dir))
    genome = index.genomes[anchor]
    groups = read_groups(groups_tsv) if groups_tsv else None
    out_dir = Path(out_dir) if out_dir else Path(index_dir) / "panagram_visuals"
    out_dir.mkdir(parents=True, exist_ok=True)

    outputs = []
    for chrom, size in genome.sizes.items():
        bitmap = genome.query(chrom, 0, int(size), step=step)
        binned = bitmap_to_bins(bitmap, bin_size, omit_fixed_kmers=rmf)
        out = out_dir / f"{anchor}_{chrom}_heatmap.svg"
        visualize(binned, out, title=f"{anchor} {chrom} k-mer similarity",
                  groups=groups)
        outputs.append(out)
    return outputs


def main(argv=None):
    p = argparse.ArgumentParser(description="Pan-kmer similarity heatmaps")
    p.add_argument("--index-dir", required=True)
    p.add_argument("--anchor", required=True)
    p.add_argument("--groups", default=None)
    p.add_argument("--bin", type=int, default=1_000_000)
    p.add_argument("--stp", type=int, default=100)
    p.add_argument("--no-rmf", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    panagram_heatmap_general(args.index_dir, args.anchor, args.groups,
                             args.bin, args.stp, not args.no_rmf, args.out)


if __name__ == "__main__":
    main()
