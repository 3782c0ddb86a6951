"""Rewrite the bin-embedding CSVs (chrom_umaps.csv, genome_umap.csv) of
anchors, every anchor by default, as scripts/write_umaps.py.

Usage: python -m panagram_tpu_torch.scripts.write_umaps <index_dir>
           [anchor ...]
"""

from __future__ import annotations

import sys

from ..index import Index


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    index = Index(argv[0])
    anchors = argv[1:] or index.anchor_genomes
    for a in anchors:
        print(f"embedding {a} ...")
        index.genomes[a].write_umaps()
    index.close()


if __name__ == "__main__":
    main()
