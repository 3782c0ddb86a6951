"""CLI: python -m panagram_tpu_torch index samples.tsv -k 31 --prefix idx

The ``index`` subcommand of panagram_tpu's CLI with the same flags, run on
one device (``--device``, default cuda).  ``--device-dict`` and ``--mesh``
are accepted only to say that this slice of the port does not build them.
"""

from __future__ import annotations

import argparse
import sys


def _add_index(sub):
    p = sub.add_parser("index", help="Build a pan-kmer index from a samples.tsv")
    p.add_argument("input", metavar="config_file",
                   help="samples.tsv (name/fasta columns) or initialized index dir")
    p.add_argument("-o", "--prefix", default=None, help="output index directory")
    p.add_argument("-k", type=int, default=21, help="k-mer length (<=31)")
    p.add_argument("-c", "--cores", type=int, default=1)
    p.add_argument("--lowres-step", type=int, default=100)
    p.add_argument("--max-bin-kbp", type=int, default=200)
    p.add_argument("--min-bin-count", type=int, default=100)
    p.add_argument("--anchor-genomes", nargs="*", default=None)
    p.add_argument("--gff-gene-types", nargs="*", default=["gene"])
    p.add_argument("--gff-anno-types", nargs="*", default=None)
    p.add_argument("--gff-name", default="Name")
    p.add_argument("-p", "--prepare", action="store_true",
                   help="write config.yaml/samples.tsv without building")
    p.add_argument("--force", action="store_true", help="ignore cached stage outputs")
    p.add_argument("--device", default="cuda",
                   help="torch device for every device step (default cuda; "
                        "asking for cuda without a card raises)")
    p.add_argument("--device-dict", action="store_true",
                   help="not in this slice of the port: raises")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="not in this slice of the port: raises")
    return p


def _run_index(args):
    from .index import Index
    from .pipeline import build_index

    params = dict(
        k=args.k,
        cores=args.cores,
        lowres_step=args.lowres_step,
        max_bin_kbp=args.max_bin_kbp,
        min_bin_count=args.min_bin_count,
        anchor_genomes=args.anchor_genomes,
        gff_gene_types=args.gff_gene_types,
        gff_anno_types=args.gff_anno_types,
        gff_name=args.gff_name,
    )
    if args.prepare:
        idx = Index(args.input, prefix=args.prefix, **params)
        print(f"Prepared index at {idx.prefix}. "
              f"Run 'python -m panagram_tpu_torch index {idx.prefix}' to build.")
        return
    idx = build_index(args.input, prefix=args.prefix, force=args.force,
                      device=args.device, device_dict=args.device_dict,
                      mesh_devices=args.mesh, **params)
    print(f"Index built at {idx.prefix}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="panagram_tpu_torch",
        description="Pan-genome k-mer index build on one PyTorch device")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_index(sub)
    args = parser.parse_args(argv)
    {"index": _run_index}[args.cmd](args)


if __name__ == "__main__":
    main()
