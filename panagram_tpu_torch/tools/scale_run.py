"""A measured end-to-end scale run of the index build, tools/scale_run.py's:

    python -m panagram_tpu_torch.tools.scale_run [--genomes 30] [--mbp 5]
        [--k 31] [--anchors 2] [--workdir DIR] [--keep] [--device cuda]

generates a founder-structured pan-genome (seed 0: 4 founders at 1%
divergence from one random base, each genome a founder with 0.1% private
variation), writes it as FASTA with a samples.tsv, builds the index
through pipeline.build_index with the device dictionary (device_dict=True,
as tools/scale_run.py), anchoring the first --anchors genomes, and prints
the total wall and each stage's wall from the build's logs/*.benchmark.txt
with the aggregate rates.  The work directory (default panagram_scale under
the temporary directory) is emptied first and removed after the run unless
--keep is given.  --device cpu runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 80):
    """One record of `codes` (0..3) in lines of `width` bases."""
    seq = np.frombuffer(b"ACGT", np.uint8)[codes]
    full = len(seq) // width * width
    lines = np.concatenate(
        [seq[:full].reshape(-1, width),
         np.full((full // width, 1), ord("\n"), np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(lines.tobytes())
        if full < len(seq):
            f.write(seq[full:].tobytes() + b"\n")


def founder_genomes(ngenomes: int, bp: int, rng):
    """Yields `ngenomes` founder-structured genomes of `bp` bases (codes
    uint8 in 0..3), the generator of tools/scale_run.py and bench.py (the
    same calls on `rng`, in the same order): 4 founders at 1% divergence
    from one random base, then each genome a founder (g % 4) with 0.1%
    private variation."""
    base = rng.integers(0, 4, bp, dtype=np.uint8)
    founders = []
    for _ in range(4):
        mut = base.copy()
        pos = rng.choice(bp, bp // 100, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        founders.append(mut)
    for g in range(ngenomes):
        mut = founders[g % 4].copy()
        pos = rng.choice(bp, bp // 1000, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        yield mut


def stage_seconds(prefix: str) -> dict:
    """{stage: wall seconds} from the index's logs/*.benchmark.txt."""
    logdir = os.path.join(prefix, "logs")
    out = {}
    for fn in sorted(os.listdir(logdir)):
        if fn.endswith(".benchmark.txt"):
            with open(os.path.join(logdir, fn)) as f:
                f.readline()
                out[fn[:-len(".benchmark.txt")]] = float(
                    f.readline().split("\t")[0])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=30)
    ap.add_argument("--mbp", type=float, default=5.0)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--anchors", type=int, default=2)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "panagram_scale"))
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from panagram_tpu_torch.pipeline import build_index, resolve_device

    dev = resolve_device(args.device)
    work = args.workdir
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "fa"))

    print(f"device={dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                             if dev.type == "cuda" else ""), flush=True)
    print(f"generating {args.genomes} x {args.mbp} Mbp "
          f"(founder-structured)...", flush=True)
    names = []
    for g, mut in enumerate(founder_genomes(
            args.genomes, int(args.mbp * 1e6), np.random.default_rng(0))):
        name = f"g{g:02d}"
        write_fasta(os.path.join(work, "fa", f"{name}.fa"), "chr1", mut)
        names.append(name)

    with open(os.path.join(work, "samples.tsv"), "w") as f:
        f.write("name\tfasta\n")
        for n in names:
            f.write(f"{n}\tfa/{n}.fa\n")

    t0 = time.perf_counter()
    idx = build_index(os.path.join(work, "samples.tsv"),
                      prefix=os.path.join(work, "idx"), device_dict=True,
                      device=args.device, k=args.k,
                      anchor_genomes=names[: args.anchors])
    wall = time.perf_counter() - t0
    total_mbp = args.genomes * args.mbp
    anchored_mbp = args.anchors * args.mbp

    print(f"\n=== scale run: {args.genomes} genomes x {args.mbp} Mbp, "
          f"k={args.k}, {args.anchors} anchors ===", flush=True)
    print(f"total wall: {wall:.1f} s "
          f"({total_mbp / wall:.2f} Mbp/s of input)", flush=True)
    stage_s = stage_seconds(os.path.join(work, "idx"))
    count_s = sum(v for s, v in stage_s.items() if s.startswith("kmc."))
    anchor_s = sum(v for s, v in stage_s.items() if s.startswith("anchor."))
    dict_s = stage_s.get("dict", 0.0)
    if count_s:
        print(f"counting: {count_s:.1f} s "
              f"({total_mbp * 1e6 / max(count_s, 1e-9) / 1e6:.1f} M kmers/s)",
              flush=True)
    print(f"dictionary (count+merge on device): {dict_s:.1f} s "
          f"({total_mbp / max(dict_s + count_s, 1e-9):.2f} Mbp/s)",
          flush=True)
    print(f"anchoring ({args.anchors} genomes): {anchor_s:.1f} s "
          f"({anchored_mbp / max(anchor_s, 1e-9):.2f} Mbp/s)", flush=True)
    for stage, v in sorted(stage_s.items()):
        print(f"  {stage:28s} {v:8.1f} s", flush=True)

    print(f"index at {idx.prefix}", flush=True)
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
