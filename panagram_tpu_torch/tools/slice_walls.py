"""chip_smoke.py's slice phase from several trees in turns, on one card:

    python -m panagram_tpu_torch.tools.slice_walls [--out DIR] ROOT [ROOT ...]

runs ``chip_smoke.slice_phase`` (30 founder-structured genomes of 5 Mbp,
k=31, anchors g0-g2, through the CLI) once per ROOT, in the order given,
each in a process of its own started in ROOT, so that it imports ROOT's
chip_smoke.py and panagram_tpu_torch (each tree builds its own kernels at
first use).  To set two versions side by side, unpack the other one
(``git archive <commit> chip_smoke.py panagram_tpu_torch``) into a
directory that .gitignore lists and give the roots in the order old, new,
new, old.  Prints, per run, the lines of its output that hold stage walls,
phases and anchored k-mers/s; with --out, each run's whole output goes to
DIR/slice_walls.<n>.txt.  Needs a CUDA device; a run that fails makes the
exit code 1.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

KEEP = ("bgzf compressor", "stage walls", "count", "dict", "layout",
        "anchor", "mash.triangle", "phases", "copy-back", "anchored k-mers/s",
        "index build")

RUN_SLICE = (
    "import sys, tempfile, torch\n"
    "sys.path.insert(0, '.')\n"
    "import chip_smoke\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit('slice_walls: no CUDA device')\n"
    "card = chip_smoke.card_line()\n"
    "with tempfile.TemporaryDirectory() as work:\n"
    "    chip_smoke.slice_phase(work, card)\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rc = 0
    for n, root in enumerate(args.roots):
        res = subprocess.run([sys.executable, "-c", RUN_SLICE],
                             cwd=os.path.abspath(root), text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             timeout=1800)
        print(f"=== run {n}: {root} (exit {res.returncode})", flush=True)
        for line in res.stdout.splitlines():
            if any(k in line for k in KEEP) and "INFO" not in line:
                print(line, flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"slice_walls.{n}.txt"), "w") as f:
                f.write(res.stdout)
        if res.returncode != 0:
            print(res.stdout[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
