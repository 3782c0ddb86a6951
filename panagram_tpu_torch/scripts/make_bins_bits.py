"""Unique and universal k-mer counts per genomic bin, as
scripts/make_bins_bits.py: for each bin (200 kbp by default) of an anchor,
the sampled positions (step 100) whose k-mer is in exactly one genome and
in all of them.

Usage: python -m panagram_tpu_torch.scripts.make_bins_bits <index_dir>
           <anchor> [bin_kbp]
"""

from __future__ import annotations

import sys

from ..index import Index


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    index = Index(argv[0])
    anchor = argv[1]
    bin_len = int(argv[2]) * 1000 if len(argv) > 2 else 200_000
    genome = index.genomes[anchor]
    n = index.ngenomes

    print("chr\tstart\tend\tunique\tuniversal\ttotal")
    for c, _, size, _ in genome.chrs:
        for start in range(0, size, bin_len):
            end = min(start + bin_len, size)
            occ = index.query_bitmap(anchor, c, start, end,
                                     100).values.sum(axis=1)
            print(f"{c}\t{start}\t{end}\t{int((occ == 1).sum())}"
                  f"\t{int((occ == n).sum())}\t{len(occ)}")
    index.close()


if __name__ == "__main__":
    main()
