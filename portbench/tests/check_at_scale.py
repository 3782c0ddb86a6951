"""The anchor check at a plant pan-genome's size, with no program table: 30
genomes of A. thaliana's five TAIR10 chromosome lengths (119,146,348 bp)
from founder_chromosomes at genome_seed 0, k = 31; one pass of every
member, each chromosome in the index's chunks, and every chunk checked
against records of zeros (so the bad_* counts read the reference's
non-zero answers, not a fault).  Prints the check's seconds and the
device's peak memory over it as one JSON line.

    python3 -m portbench.tests.check_at_scale [--genomes 30] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from portbench import kinds, run
from portbench.kinds import anchor
from portbench.trace import no_mark

# TAIR10's chromosomes 1-5, bp
TAIR10 = [30427671, 19698289, 23459830, 18585056, 26975502]


def zeros_stream(codes, nkmers, chunk, buf, table, bd, nbytes, ngenomes, k,
                 **_kw):
    """The stream's items, every answer zero."""
    for start in range(0, nkmers, chunk):
        m = min(chunk, nkmers - start)
        yield (start, m, np.zeros((m, nbytes), np.uint8),
               np.zeros(m, np.int32), np.zeros(ngenomes, np.int64))


def rehearse(ngenomes: int, chromosome_bp: list, seed: int, device,
             log) -> dict:
    """One pass of each of `ngenomes` founder genomes of `chromosome_bp`
    through the harness's pass, then its check, timed."""
    _cell, cfg, mix = run.cell_spec(
        run.load_json(os.path.join(run.ROOT, "BENCHMARK.json")),
        "pan30_k31.anchor_member")
    cfg = dict(cfg, genomes=ngenomes, generator="founder_chromosomes",
               chromosome_bp=list(chromosome_bp))
    del cfg["genome_bp"]
    cell = anchor.Cell(cfg, mix, seed, device, log)
    t = time.perf_counter()
    cell.prepare(kinds.genomes(cfg))
    gen_s = time.perf_counter() - t
    cell.stream, cell.table, cell.bd = zeros_stream, None, None
    cell.passes, cell.recs = list(range(ngenomes)), []
    positions = sum(cell._pass(i, e, {}, cell.recs, no_mark)
                    for i, e in enumerate(cell.passes))
    log(f"generation {gen_s:.3f} s, {len(cell.recs)} chunks, chunk "
        f"{sorted(set(cell.chunks))}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        free = torch.cuda.mem_get_info(device)[0]
    t = time.perf_counter()
    chk = cell.check(least_bytes=True)
    if cuda:
        torch.cuda.synchronize(device)
    out = {"seconds": time.perf_counter() - t, "chunks": len(cell.recs),
           "positions": positions, "generation_s": gen_s,
           "checks": {n: v for n, (v, _lim) in chk.numbers.items()},
           "least_bytes": chk.least_bytes}
    if cuda:
        out.update(peak_bytes=torch.cuda.max_memory_allocated(device),
                   free_bytes_before=free,
                   card=run.card_line())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=30)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("no CUDA card")
        return 1
    out = rehearse(args.genomes, TAIR10, args.seed, torch.device("cuda", 0),
                   run.log)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
