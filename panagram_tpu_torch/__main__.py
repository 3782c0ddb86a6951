"""CLI: python -m panagram_tpu_torch index samples.tsv -k 31 --prefix idx
     python -m panagram_tpu_torch annotate idx genome genes.gff

The ``index`` and ``annotate`` subcommands of panagram_tpu's CLI with the
same flags, run on one device (``--device``, default cuda), or with
``--mesh N`` on N ranks of one device each; ``--num-processes`` builds from
several processes (with ``--mesh``: one mesh across them, meeting at
``--coordinator``; without: coordinated through files).
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
                   help="count and merge every genome on the device in one "
                        "stage (no per-genome k-mer set files)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="build on a mesh of N ranks, one per device "
                        "(torch.distributed: NCCL on cuda:0..N-1, Gloo with "
                        "--device cpu): distributed dictionary merge and "
                        "sharded anchoring; the same files as the one-device "
                        "build")
    p.add_argument("--mesh-strategy", choices=("range", "genomes"),
                   default="range",
                   help="mesh sharding: 'range' = key-range-sharded dict + "
                        "sequence sharding; 'genomes' = mask words split "
                        "across devices (for large genome counts)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="distributed build: total processes/hosts")
    p.add_argument("--process-id", type=int, default=0,
                   help="distributed build: this process's id")
    p.add_argument("--coordinator", default=None,
                   help="torch.distributed rendezvous address (host:port) of "
                        "a multi-process --mesh build, served by process 0")
    return p


def _add_annotate(sub):
    p = sub.add_parser("annotate",
                       help="(Re-)annotate an anchored genome from a GFF")
    p.add_argument("index_dir")
    p.add_argument("genome")
    p.add_argument("gff_file",
                   help="GFF3 file (a relative path is relative to index_dir)")
    p.add_argument("--nogene", action="store_true",
                   help="write the annotation tables only, no gene counts")
    p.add_argument("--device", default="cuda",
                   help="torch device of the popcount kernel (default cuda)")
    return p


def _run_index(args):
    from .index import Index
    from .pipeline import build_index

    if args.mesh_strategy != "range" and not args.mesh:
        raise SystemExit(
            "--mesh-strategy requires --mesh N (it selects how the mesh "
            "is sharded)")
    if args.mesh and args.num_processes > 1 and not args.coordinator:
        raise SystemExit(
            "--mesh with --num-processes runs ONE collective engine across "
            "processes (torch.distributed) and needs --coordinator host:port")

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
    build = dict(force=args.force, device=args.device,
                 device_dict=args.device_dict, mesh_devices=args.mesh,
                 mesh_strategy=args.mesh_strategy, **params)
    if args.mesh and args.num_processes > 1:
        # one mesh across processes: process i writes under <prefix>.p<i>;
        # by default each writes its ranks' bitmap rows as pieces that
        # process 0 stitches (PANAGRAM_TPU_SHARD_WRITES=0: full mirrors).
        # Start every process from equivalent stage states (fresh dirs or
        # --force): a stage one skips and another runs is refused
        if not args.prefix:
            raise SystemExit("--mesh with --num-processes requires -o PREFIX")
        prefix = args.prefix.rstrip("/")
        if args.process_id:
            prefix += f".p{args.process_id}"
        idx = build_index(args.input, prefix=prefix,
                          num_processes=args.num_processes,
                          process_id=args.process_id,
                          coordinator=args.coordinator, **build)
        print(f"Index built at {idx.prefix} "
              f"(process {args.process_id}/{args.num_processes})")
    elif args.num_processes > 1:
        from .parallel.distributed import build_index_distributed

        idx = build_index_distributed(
            args.input, prefix=args.prefix, num_processes=args.num_processes,
            process_id=args.process_id, force=args.force, device=args.device,
            **params)
        if idx is not None:
            print(f"Index built at {idx.prefix}")
        else:
            print(f"Process {args.process_id} finished its shard")
    else:
        idx = build_index(args.input, prefix=args.prefix, **build)
        print(f"Index built at {idx.prefix}")


def _run_annotate(args):
    from .index import Index
    from .pipeline import resolve_device

    dev = resolve_device(args.device)
    Index(args.index_dir).genomes[args.genome].run_annotate(
        args.gff_file, nogene=args.nogene, device=dev)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="panagram_tpu_torch",
        description="Pan-genome k-mer index build on PyTorch devices")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_index(sub)
    _add_annotate(sub)
    args = parser.parse_args(argv)
    {"index": _run_index, "annotate": _run_annotate}[args.cmd](args)


if __name__ == "__main__":
    main()
