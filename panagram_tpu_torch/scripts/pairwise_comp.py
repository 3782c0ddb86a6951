"""Per-genome shared k-mer totals of an anchor, as scripts/pairwise_comp.py:
the column sums of at most 50,000 bitmap rows (step 100) sampled per
chromosome, printed as name,count,percent of the anchor's own count.

Usage: python -m panagram_tpu_torch.scripts.pairwise_comp <anchor> <index_dir>

The exact genome x genome matrix is pairwise_matrix's.
"""

from __future__ import annotations

import sys

import numpy as np

from ..index import Index

SAMPLE_ROWS = 50_000


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    anchor, wd = argv[0], argv[1]
    index = Index(wd)
    genome = index.genomes[anchor]

    data = {g: 0 for g in index.genomes}
    for c, _, end, _ in genome.chrs:
        bits = index.query_bitmap(anchor, c, 0, end, 100)
        n = len(bits.values)
        # DataFrame.sample(n=..., random_state=42)'s rows
        rows = np.random.RandomState(42).choice(n, min(n, SAMPLE_ROWS),
                                                replace=False)
        sums = bits.values[rows].sum(axis=0)
        for g, s in zip(bits.columns, sums):
            data[g] += int(s)

    for g in data:
        print(f"{g},{data[g]},{data[g] / data[anchor] * 100}")
    index.close()


if __name__ == "__main__":
    main()
