"""The control: the reference put in the program's place with one of the
configuration's guarantees broken, which the comparison has to refuse.

    python3 -m portbench.control --workload <cell> --seed N --seconds S

The guarantee broken is the canonical k-mer (configs' "canonical"): the
control reads each position's forward k-mer and never its reverse
complement, the step a later change could be tempted to drop.  In an
anchor cell the control's stream answers each chunk from the reference's
(canonical, exact) dictionary, merged one genome's set at a time, with
forward words; in a build cell its
builder counts forward words, merges them as the reference does and lays
the result out through the program's layout.  It runs the cell as
portbench.run does, short window and all, and prints the same lines; the
benchmark's own runs never run it.  Exit 0 when the result says
correct false, 1 when it does not.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.kinds import anchor  # noqa: E402
from portbench.reference import kmers as ref  # noqa: E402


def _forward_stream(keys, mask, device):
    """A stream with stream_anchor_chunks' arguments and items whose rows
    are the forward k-mers' presence rows."""
    def stream(codes, nkmers, chunk, buf, table, bd, nbytes, ngenomes, k,
               state=None, capacity=None, trace=False, *, phase=None):
        for start in range(0, nkmers, chunk):
            m = min(chunk, nkmers - start)
            win = torch.from_numpy(codes[start:start + m + k - 1]).to(device)
            words, valid = ref.kmer_words(win, k, canonical=False)
            rows = ref.rows(words, valid, keys, mask)
            full = ref.row_bytes(rows)
            yield (start, m, full[:, :nbytes].cpu().numpy(),
                   ref.popcount(full).cpu().numpy(),
                   ref.column_sums(rows, ngenomes).cpu().numpy())
    return stream


class _ForwardBuilder:
    """A builder with the builders' build(): forward-word sets, the
    reference's merge, the program's layout."""

    @staticmethod
    def build(genomes, cfg, device, span=None):
        from panagram_tpu_torch.ops import lookup

        k, n = cfg["k"], len(genomes)
        sets = [ref.kmer_set(torch.from_numpy(g).to(device), k,
                             canonical=False) for g in genomes]
        keys = ref.union_keys(sets)
        mask = ref.masks(keys, sets)
        bd = lookup.BucketedDict.build_device(keys, mask, n, k, device=device)
        (table,) = bd.device_arrays(device=device)
        pan = types.SimpleNamespace(
            keys=keys.cpu().numpy().view(np.uint64),
            masks=mask.cpu().numpy().view(np.uint32))
        return bd, table, pan


class _GenomeSets:
    """The anchor cell's genomes' canonical k-mer sets, each made from its
    chromosomes when it is read, so that one is held at a time."""

    def __init__(self, cell):
        self.cell = cell

    def __len__(self):
        return len(self.cell.chrs)

    def __getitem__(self, g):
        return anchor.genome_set(self.cell.chrs[g], self.cell.k,
                                 self.cell.device)


def control(cell):
    """Puts the control in the set-up cell's program's place."""
    if cell.mix["kind"] == "anchor":
        sets = _GenomeSets(cell)
        keys = torch.zeros(0, dtype=torch.int64, device=cell.device)
        for g in range(len(sets)):
            keys = ref.union_keys([keys, sets[g]])
        cell.stream = _forward_stream(keys, ref.masks(keys, sets), cell.device)
    elif cell.mix["kind"] == "build":
        cell.builder = _ForwardBuilder
    else:
        raise ValueError(f"control: no control for kind {cell.mix['kind']!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
    _cell, cfg, mix = run.cell_spec(spec, args.workload)
    if not torch.cuda.is_available():
        run.log("no CUDA card")
        return 1
    result = run.run_cell(args.workload, cfg, mix,
                          run.cell_metrics(spec, args.workload, False),
                          args.seed, args.seconds, False,
                          torch.device("cuda", 0), system=control,
                          t_start=T_START)
    for n, c in result["checks"].items():
        run.log(f"control check {n} = {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0 if not result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
