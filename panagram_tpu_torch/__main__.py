"""CLI: python -m panagram_tpu_torch index samples.tsv -k 31 --prefix idx
     python -m panagram_tpu_torch annotate idx genome genes.gff
     python -m panagram_tpu_torch bitdump idx genome chrom [start end step]
     python -m panagram_tpu_torch view idx [genome chrom start end]
     python -m panagram_tpu_torch intros config.yaml|simulate|bed2txt|heatmap

The subcommands of panagram_tpu's CLI with the same arguments.  ``index``
runs on one device (``--device``, default cuda), or with ``--mesh N`` on N
ranks of one device each; ``--num-processes`` builds from several
processes (with ``--mesh``: one mesh across them, meeting at
``--coordinator``; without: coordinated through files).  ``bitdump``
prints bitmap rows of a window, host work only: with ``-v`` the genome
names and one line of bits per row, else the table panagram_tpu prints
through pandas (``frame_text``).  ``view`` (the browser's server) and
``intros`` (the introgression pipeline and its sub-tools) are host work
too, as in panagram_tpu.
"""

from __future__ import annotations

import argparse
import shutil
import sys

import numpy as np


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
        idx = Index(args.input, mode="w", prefix=args.prefix, **params)
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
    idx = Index(args.index_dir)
    try:
        idx[args.genome].run_annotate(args.gff_file, nogene=args.nogene,
                                      device=dev)
    finally:
        idx.close()


def _add_bitdump(sub):
    p = sub.add_parser("bitdump", help="Query the pan-kmer bitmap")
    p.add_argument("index_dir")
    p.add_argument("genome")
    p.add_argument("chrom")
    p.add_argument("start", type=int, nargs="?", default=None)
    p.add_argument("end", type=int, nargs="?", default=None)
    p.add_argument("step", type=int, nargs="?", default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _run_bitdump(args):
    from .index import Index

    idx = Index(args.index_dir)
    try:
        bits = idx.query_bitmap(args.genome, args.chrom, args.start,
                                args.end, args.step)
        if args.verbose:
            print(" ".join(idx.genomes))
            # one line of space-separated 0/1 per row
            text = np.full((len(bits.values), 2 * idx.ngenomes), ord(" "),
                           np.uint8)
            text[:, 0::2] = bits.values + ord("0")
            text[:, -1] = ord("\n")
            sys.stdout.write(text.tobytes().decode())
        else:
            # panagram_tpu's genome columns are named after their
            # samples.tsv column
            print(frame_text(bits, columns_name="name"))
    finally:
        idx.close()


def _add_view(sub):
    p = sub.add_parser("view", help="Serve the pan-genome browser")
    p.add_argument("index_dir")
    p.add_argument("genome", nargs="?", default=None)
    p.add_argument("chrom", nargs="?", default=None)
    p.add_argument("start", type=int, nargs="?", default=None)
    p.add_argument("end", type=int, nargs="?", default=None)
    p.add_argument("--port", default="8050")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--ndebug", action="store_true")
    p.add_argument("--max-chr-bins", type=int, default=350)
    p.add_argument("--bookmarks", default=None)
    p.add_argument("--order", nargs="*", default=None,
                   help="fixed genome row order for heatmaps (default: "
                        "ward-clustering order)")
    return p


def _run_view(args):
    from .view.server import serve

    serve(args)


def _add_intros(sub):
    p = sub.add_parser("intros", help="Introgression calling pipeline")
    p.add_argument("target", help="config.yaml, or one of: heatmap, bed2txt, simulate")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("extra", nargs=argparse.REMAINDER)
    return p


def _run_intros(args):
    from .intros.runner import main as intros_main

    intros_main(args)


def _column_kind(col: np.ndarray) -> str:
    """The pandas dtype a column of a Table would have: "int", "float" or
    "str" (object)."""
    if col.dtype.kind in "iu":
        return "int"
    if col.dtype.kind == "f":
        return "float"
    if all(isinstance(v, (int, np.integer)) for v in col):
        return "int"
    if all(isinstance(v, (int, float, np.integer, np.floating)) for v in col):
        return "float"
    return "str"


def _float_cells(values) -> list:
    """pandas' FloatArrayFormatter at its default precision for values of
    magnitude in [1e-6, 1e6] or 0: six decimals, then trailing zeros
    trimmed from all numbers alike, at least one kept; NaN as "NaN"."""
    cells = ["NaN" if v != v else f"{v: .{PRECISION}f}" for v in values]
    nums = [i for i, c in enumerate(cells) if c != "NaN"]
    while nums and all(cells[i].endswith("0") for i in nums):
        for i in nums:
            cells[i] = cells[i][:-1]
    return [c + "0" if c.endswith(".") else c for c in cells]


# pandas' display defaults (display.max_rows, display.min_rows,
# display.max_seq_items, display.precision)
MAX_ROWS, MIN_ROWS, MAX_SEQ_ITEMS, PRECISION = 60, 10, 100, 6


def frame_text(t, columns_name=None) -> str:
    """The text ``print(DataFrame)`` gives in a plain Python interpreter for
    a Table (rows labelled by its index; `columns_name` the name of the
    column labels, printed above the row labels), pandas' defaults in
    force: int columns as pandas prints int64, str columns as object,
    float columns as float64 (see _float_cells); more than MAX_ROWS rows
    show the first and last MIN_ROWS // 2; columns are dropped from the
    middle until the lines fit the terminal's width
    (shutil.get_terminal_size: $COLUMNS, the terminal, else 80) and a "..."
    column stands for them; when anything is dropped the dimensions
    follow."""
    values, names = t.values, [str(c) for c in t.columns]
    nrows, ncols = values.shape
    width = shutil.get_terminal_size()[0]
    dims = f"\n\n[{nrows} rows x {ncols} columns]"
    if nrows == 0 or ncols == 0:
        def seq(items):
            items = [str(x) for x in items]
            if len(items) > MAX_SEQ_ITEMS:
                items = items[:MAX_SEQ_ITEMS] + ["..."]
            return "[" + ", ".join(items) + "]"
        return (f"Empty DataFrame\nColumns: {seq(names)}\n"
                f"Index: {seq(t.index)}" + (dims if ncols > width else ""))
    rows = list(range(nrows))
    row_cut = None
    if nrows > MAX_ROWS:
        row_cut = MIN_ROWS // 2
        rows = rows[:row_cut] + rows[-row_cut:]
    kinds = [_column_kind(values[:, c]) for c in range(ncols)]
    cols, col_cut = list(range(ncols)), None

    def cut_columns(fitted):
        nonlocal cols, col_cut
        if fitted and ncols > fitted:
            col_cut = fitted // 2
            cols = cols[:col_cut] + cols[len(cols) - col_cut:]

    def cells(c):
        shown = values[rows, c]
        if kinds[c] == "int":
            return [f"{v: d}" for v in shown]
        if kinds[c] == "float":
            return _float_cells(shown)
        return [f" {v}" for v in shown]

    def strcols():
        index = [str(t.index[r]) for r in rows]
        iw = max(map(len, index))
        out = [[columns_name or ""] + [s.ljust(iw) for s in index]]
        for c in cols:
            head = names[c] if kinds[c] == "str" else " " + names[c]
            body = cells(c)
            w = max(len(head), *map(len, body))
            out.append([head.rjust(w)] + [v.rjust(w) for v in body])
        if col_cut is not None:
            out.insert(col_cut + 1, [" ..."] * (len(rows) + 1))
        if row_cut is not None:
            for ix, col in enumerate(out):
                dot_col = col_cut is not None and ix == col_cut + 1
                cw = 4 if dot_col else len(col[row_cut])
                dots = "..." if cw > 3 else ".."
                col.insert(row_cut + 1,
                           dots.ljust(cw) if ix == 0 else dots.rjust(cw))
        return out

    def adjoin(columns):
        widths = [max(map(len, c)) + 1 for c in columns[:-1]]
        widths.append(max(map(len, columns[-1])))
        return "\n".join("".join(s.ljust(w) for s, w in zip(line, widths))
                         for line in zip(*columns))

    cut_columns(width if ncols > width else 0)
    sc = strcols()
    # drop columns from the middle until the lines fit the width
    lens = [max(map(len, c)) for c in sc]
    over = len(adjoin(sc).split("\n")[0]) - width + 1
    while over > 0 and len(lens) > 1:
        over -= lens.pop(round(len(lens) / 2)) + 1
    cut_columns(max(len(lens) - 1, 2))
    text = adjoin(strcols())
    if row_cut is not None or col_cut is not None:
        text += dims
    return text


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="panagram_tpu_torch",
        description="Pan-genome k-mer index build on PyTorch devices")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_index(sub)
    _add_view(sub)
    _add_bitdump(sub)
    _add_annotate(sub)
    _add_intros(sub)
    args = parser.parse_args(argv)
    {"index": _run_index, "view": _run_view, "bitdump": _run_bitdump,
     "annotate": _run_annotate, "intros": _run_intros}[args.cmd](args)


if __name__ == "__main__":
    main()
