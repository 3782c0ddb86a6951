"""Ground-truth BED -> per-chromosome text matrices for scoring (``intros
bed2txt``).

panagram_tpu.intros.bed2txt on the port's read API: the simulator's
introgression BED is binned and copied to every offspring genome (every
genome but the reference and the wild type), written as
<chr>_<wild_type_group>.txt next to the BED.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..index import Index, Table
from .core import bed_to_bins, read_bed_file, write_matrix


def bed_to_text(gt_bed_file, index_dir, ref, wild_type, wild_type_group,
                bin_size=1_000_000):
    gt_bed_file = Path(gt_bed_file).resolve()
    bed = read_bed_file(gt_bed_file)
    if not bed:
        print("No introgressions found in ground truth bed file.")
        return []

    index = Index(str(index_dir))
    ref_genome = index.genomes[ref]
    offspring = [name for name in index.genomes
                 if name not in (ref, wild_type)]

    outputs = []
    for chrom in dict.fromkeys(r[0] for r in bed):
        chr_length = int(ref_genome.sizes[chrom])
        bins = bed_to_bins([r for r in bed if r[0] == chrom], bin_size,
                           chr_length)
        out = Table(np.tile(bins.values, (len(offspring), 1)), offspring,
                    list(bins.index), "Sample")
        path = gt_bed_file.parent / f"{chrom}_{wild_type_group}.txt"
        write_matrix(out, path)
        outputs.append(path)
    return outputs


def main(argv=None):
    p = argparse.ArgumentParser(description="BED -> scoring text matrices")
    p.add_argument("--gt_bed_file", required=True)
    p.add_argument("--index_dir", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--wild_type", required=True)
    p.add_argument("--wild_type_group", required=True)
    p.add_argument("--bin_size", type=int, default=1_000_000)
    args = p.parse_args(argv)
    bed_to_text(args.gt_bed_file, args.index_dir, args.ref, args.wild_type,
                args.wild_type_group, args.bin_size)


if __name__ == "__main__":
    main()
