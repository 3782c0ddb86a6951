"""Probe of the four u32 operations the fused pack+mix kernel design rests
on: exact u32 multiply, roll by one element, 16x32 multiply, unsigned
compare-select.  The counterpart of panagram_tpu's tools/mosaic_probe.py,
run through the mosaic_probe CUDA kernel (ops/kernels.py):

    python -m panagram_tpu_torch.tools.mosaic_probe [--device cuda:0]

It draws the same inputs (numpy default_rng(0), n = 1024), prints one
"... ok: True/False" line per operation against numpy, and exits non-zero
if any is False.  It needs a CUDA device: the kernel has no CPU form.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

N = 1024


def probe_inputs(n: int = N):
    """The probe's inputs: a, b uint32 [n] from numpy default_rng(0)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    b = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return a, b


def expected(a: np.ndarray, b: np.ndarray):
    """The four results numpy gives for the probe's inputs."""
    prod = (a.astype(np.uint64) * b.astype(np.uint64)).astype(np.uint32)
    roll = np.roll(a, -1)
    hi16 = ((a >> 16).astype(np.uint64) * (b & 0xFFFF)).astype(np.uint32)
    return prod, roll, hi16, np.where(a < b, prod, roll)


def main(argv=None) -> int:
    from ..ops import kernels

    p = argparse.ArgumentParser(prog="panagram_tpu_torch.tools.mosaic_probe",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="CUDA device to run the kernel on (default cuda)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda":
        raise SystemExit(f"mosaic_probe: device {dev} is not a CUDA device; "
                         "the probe runs the CUDA kernel")
    if not torch.cuda.is_available():
        raise SystemExit("mosaic_probe: torch.cuda.is_available() is false")
    print(f"device={torch.cuda.get_device_name(dev)}", flush=True)
    a, b = probe_inputs()
    out = kernels.mosaic_probe(torch.from_numpy(a.view(np.int32)).to(dev),
                               torch.from_numpy(b.view(np.int32)).to(dev))
    out = out.cpu().numpy().view(np.uint32)
    ok = [np.array_equal(out[:, i], w) for i, w in enumerate(expected(a, b))]
    print("u32 mul exact:", ok[0])
    print("roll ok:      ", ok[1])
    print("16x32 mul ok: ", ok[2])
    print("select ok:    ", ok[3])
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
