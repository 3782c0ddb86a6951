"""Index query demos, as scripts/query_index.py: gene, annotation and
bitmap queries and a boolean k-mer pattern search over every chromosome
of an anchor (or one).

Usage: python -m panagram_tpu_torch.scripts.query_index <index_dir> <anchor>
           {gene|anno|bit|pattern} [chrom]
"""

from __future__ import annotations

import sys

import numpy as np

from ..__main__ import frame_text
from ..index import Index


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    index_dir, anchor, what = argv[:3]
    chrom = argv[3] if len(argv) > 3 else None
    index = Index(index_dir)
    genome = index.genomes[anchor]
    chroms = [chrom] if chrom else [c[0] for c in genome.chrs]

    for c in chroms:
        size = int(genome.sizes[c])
        if what == "gene":
            print(frame_text(index.query_genes(anchor, c, 0, size)))
        elif what == "anno":
            print(frame_text(index.query_anno(anchor, c, 0, size)))
        elif what == "bit":
            bm = index.query_bitmap(anchor, c, 0, size, 100)
            print(c, "occupancy mean:", bm.values.sum(axis=1).mean())
        elif what == "pattern":
            # positions whose k-mer is present in genome 0 and absent from
            # genome 1
            kmers = index.query_bitmap(anchor, c, 0, size, 1).values
            locs = np.flatnonzero((kmers[:, 0] == 1) & (kmers[:, 1] == 0))
            print(c, f"{len(locs)} positions match; first 10: {locs[:10]}")
        else:
            print("Specify: gene, anno, bit, pattern")
            return
    index.close()


if __name__ == "__main__":
    main()
