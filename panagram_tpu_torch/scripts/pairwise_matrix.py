"""The exact genome x genome shared distinct k-mer matrix of an index, from
its pan-kmer dictionary (PanKmerDict.pairwise_shared: blocked products of
the presence bits on the device), as scripts/pairwise_matrix.py.

Usage: python -m panagram_tpu_torch.scripts.pairwise_matrix <index_dir>
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from ..index import Index
from ..ops.dictionary import PanKmerDict


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pairwise_matrix")
    ap.add_argument("index_dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    index = Index(args.index_dir)
    shared = PanKmerDict.load(index.dict_fname).pairwise_shared(device=args.device)
    names = list(index.genome_names)
    print("\t" + "\t".join(names))
    for i, n in enumerate(names):
        print(n + "\t" + "\t".join(str(int(x)) for x in shared[i]))
    index.close()


if __name__ == "__main__":
    main()
