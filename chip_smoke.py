#!/usr/bin/env python3
"""Smoke run of panagram_tpu_torch on one CUDA card: python3 chip_smoke.py

1. Names the card (nvidia-smi name and power limit) and the torch build.
2. Builds the CUDA kernels from panagram_tpu_torch/csrc with nvcc (one
   process per source, in parallel).
3. Kernel phase: at the anchor path's shapes (a 2^22-position chunk, k=31;
   W=1 with 30 genomes and W=2 with 40) each anchor kernel's output is
   compared bit for bit with its plain torch version on the card, and both
   are timed (median of CUDA-event-timed repetitions); so is mosaic_probe
   at n = 1024 and 2^24.
4. The mosaic probe tool: ``panagram_tpu_torch.tools.mosaic_probe.main()``
   in process must print four True lines and launch its kernel.
5. The slice: 30 founder-structured genomes of 5 Mbp (seed 0) are written
   as FASTA and indexed through the CLI entry point,
   ``main(["index", ..., "-k", "31", "--anchor-genomes", "g0", "g1", "g2"])``,
   with the bucket table laid out on the card.  Every anchor kernel's
   launch counter must have risen during that run, every output file must
   exist and be consistent, and the first 2^17 positions of g0's bitmap
   must equal the numpy oracle against the saved dictionary.  The count
   stage's peak device memory is printed.
6. The device-dict slice: the same genomes through ``--device-dict``.  Its
   pandict.npz must be the slice's dictionary mixed (keys in unsigned mixed
   order), its anchor files byte-identical to the slice's, and pack_mix
   must have run once per sequence chunk in its dict stage.
7. Layout phase: ~1e8 mixed keys drawn on the card (W=1) laid out by
   BucketedDict.build_device, the single-pass route and the chunked route;
   the three tables must be equal and a sample of keys must find their
   masks.
8. Prints the kernels JSON line, the card line, and last
   {"ok": true, "device": {...}}.  Any failed check raises, so the script
   exits non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import filecmp
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import panagram_tpu_torch  # noqa: F401  (fails early outside the repo)

K = 31
CHUNK = 1 << 22
GENOMES, GENOME_BP, ANCHORS = 30, 5_000_000, ("g0", "g1", "g2")
ORACLE_POSITIONS = 1 << 17
DICT_KEYS = 13_000_000    # kernel-phase table: the slice's dictionary size
LAYOUT_KEYS = 100_000_000  # layout phase: a ~1e8-key W=1 table
MOSAIC_SIZES = (1024, 1 << 24)
REPS = 10

KERNELS = [  # (wrapper, CUDA source, TPU kernel it replaces)
    ("pack_mix", "panagram_tpu_torch/csrc/pack_mix.cu",
     "panagram_tpu/ops/pallas_kernels.py:429"),
    ("probe_sorted", "panagram_tpu_torch/csrc/probe_sorted.cu",
     "panagram_tpu/ops/pallas_kernels.py:228"),
    ("fused_popcount_colsums", "panagram_tpu_torch/csrc/popcount_colsums.cu",
     "panagram_tpu/ops/pallas_kernels.py:93"),
    ("masks_to_bytes", "panagram_tpu_torch/csrc/masks_to_bytes.cu",
     "panagram_tpu/ops/pallas_kernels.py:512"),
    ("mosaic_probe", "panagram_tpu_torch/csrc/mosaic_probe.cu",
     "tools/mosaic_probe.py:50"),
]
ANCHOR_KERNELS = [n for n, _, _ in KERNELS if n != "mosaic_probe"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of fn() on the card, each call between two CUDA
    events, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_abs_err(got, want) -> int:
    """Largest |difference| over the outputs, compared as unsigned ints."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)} {g.dtype} "
                                 f"!= {tuple(w.shape)} {w.dtype}")
        if g.dtype == torch.int32:
            g, w = g.to(torch.int64) & 0xFFFFFFFF, w.to(torch.int64) & 0xFFFFFFFF
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def kernel_phase(dev, ngenomes: int, rng) -> dict:
    """Each kernel against its plain version on a main-path-sized chunk.
    Returns {name: (max_abs_err, ms, plain_ms)}."""
    from panagram_tpu_torch.ops import kernels
    from panagram_tpu_torch.ops.codec import pack_bases_np, pack_kmers, u64_np
    from panagram_tpu_torch.ops.lookup import BucketedDict, plan_probe

    L = CHUNK + K - 1
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.choice(L, L // 50, replace=False)] = 255
    # a dictionary the size of the slice's (~1.3e7 keys): half of this
    # chunk's k-mers plus absent keys, masks over ngenomes bits
    canon, valid = pack_kmers(torch.from_numpy(codes).to(dev), K)
    keys = u64_np(torch.unique(canon[valid]))
    keys = keys[rng.random(len(keys)) < 0.5]
    keys = np.unique(np.concatenate(
        [keys, rng.integers(0, 1 << 62, max(DICT_KEYS - len(keys), 0),
                            dtype=np.uint64)]))
    W = (ngenomes + 31) // 32
    masks = rng.integers(1, 1 << 32, (len(keys), W), dtype=np.uint64)
    masks[:, -1] &= np.uint64((1 << (ngenomes - 32 * (W - 1))) - 1)
    bd = BucketedDict.build_device(keys, masks.astype(np.uint32), ngenomes, K,
                                   dev)
    nbytes = (ngenomes + 7) // 8
    print(f"  N={ngenomes} W={W}: table 2^{bd.nbits} x {bd.stride} u32 "
          f"({bd.table.numel() * 4 / 2**30:.2f} GiB), {len(keys)} keys",
          flush=True)

    packed, nmask, _ = pack_bases_np(codes)
    p, n = torch.from_numpy(packed).to(dev), torch.from_numpy(nmask).to(dev)
    hi, lo = kernels.pack_mix(p, n, L, K, CHUNK)
    plan = plan_probe(hi, lo, bd.nbits)
    pargs = (plan.qhi, plan.qlo, plan.blo, bd.table, bd.nbits, bd.cap,
             bd.nwords, plan.span, plan.tile_q)
    rows = kernels.probe_sorted(*pargs)
    torch.cuda.synchronize()
    hit_frac = float((rows != 0).any(dim=1).float().mean())
    print(f"  probe: span {plan.span} rows, {int(plan.out_span.sum())} "
          f"queries out of span, {hit_frac:.3f} of positions hit", flush=True)

    cases = {
        "pack_mix": (lambda: kernels.pack_mix(p, n, L, K, CHUNK),
                     lambda: kernels.pack_mix_plain(p, n, L, K, CHUNK)),
        "probe_sorted": (lambda: (kernels.probe_sorted(*pargs),),
                         lambda: (kernels.probe_sorted_plain(*pargs),)),
        "fused_popcount_colsums": (
            lambda: kernels.fused_popcount_colsums(rows, 32 * W),
            lambda: kernels.fused_popcount_colsums_plain(rows, 32 * W)),
        "masks_to_bytes": (lambda: (kernels.masks_to_bytes(rows, nbytes),),
                           lambda: (kernels.masks_to_bytes_plain(rows, nbytes),)),
    }
    out = {name: compare(name, f"N={ngenomes}", kern, plain)
           for name, (kern, plain) in cases.items()}
    del bd, rows, plan
    torch.cuda.empty_cache()
    return out


def compare(name: str, what: str, kern, plain):
    """Kernel against plain version on the card: (max_abs_err, ms,
    plain_ms); raises unless bit-exact."""
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name} ({what}): kernel differs from its "
                             f"plain version, max |err| {err}")
    res = (err, time_ms(kern), time_ms(plain))
    print(f"  {name:24s} bit-exact  kernel {res[1]:9.4f} ms  "
          f"plain {res[2]:9.4f} ms", flush=True)
    return res


def mosaic_phase(dev) -> tuple[dict, int]:
    """mosaic_probe against its plain version at MOSAIC_SIZES, then the
    probe tool in process.  Returns ({n: (err, ms, plain_ms)}, the tool
    run's kernel launches)."""
    from panagram_tpu_torch.ops import kernels
    from panagram_tpu_torch.tools import mosaic_probe

    out = {}
    for n in MOSAIC_SIZES:
        a, b = mosaic_probe.probe_inputs(n)
        ta = torch.from_numpy(a.view(np.int32)).to(dev)
        tb = torch.from_numpy(b.view(np.int32)).to(dev)
        print(f"  mosaic_probe n={n}:", flush=True)
        out[n] = compare("mosaic_probe", f"n={n}",
                         lambda: (kernels.mosaic_probe(ta, tb),),
                         lambda: (kernels.mosaic_probe_plain(ta, tb),))
    kernels.reset_launches()
    buf = io.StringIO()
    sys_stdout, sys.stdout = sys.stdout, buf
    try:
        rc = mosaic_probe.main([])
    finally:
        sys.stdout = sys_stdout
    launches = kernels.launches["mosaic_probe"]
    print("  tool: " + " | ".join(buf.getvalue().strip().splitlines()),
          flush=True)
    if rc != 0 or launches <= 0:
        raise AssertionError(f"mosaic_probe tool: rc {rc}, {launches} launches")
    return out, launches


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 80):
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


def make_genomes(work: str) -> dict:
    """The founder-structured scale row: 4 founders at 1% divergence from
    one random base, each genome a founder with 0.1% private variation."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, GENOME_BP, dtype=np.uint8)
    founders = []
    for _ in range(4):
        mut = base.copy()
        pos = rng.choice(GENOME_BP, GENOME_BP // 100, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        founders.append(mut)
    os.makedirs(os.path.join(work, "fa"))
    seqs = {}
    for g in range(GENOMES):
        mut = founders[g % 4].copy()
        pos = rng.choice(GENOME_BP, GENOME_BP // 1000, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        write_fasta(os.path.join(work, "fa", f"g{g}.fa"), "chr1", mut)
        if f"g{g}" in ANCHORS:
            seqs[f"g{g}"] = mut
    with open(os.path.join(work, "samples.tsv"), "w") as f:
        f.write("name\tfasta\n")
        for g in range(GENOMES):
            f.write(f"g{g}\tfa/g{g}.fa\n")
    return seqs


def stage_walls(prefix: str) -> dict:
    walls = {}
    logs = os.path.join(prefix, "logs")
    for fn in sorted(os.listdir(logs)):
        if fn.endswith(".benchmark.txt"):
            with open(os.path.join(logs, fn)) as f:
                f.readline()
                walls[fn[:-len(".benchmark.txt")]] = float(f.readline().split("\t")[0])
    return walls


def count_peaks(pipeline, peaks: list):
    """Wrap pipeline.count_genome so that each call appends the peak device
    memory it allocated above what was allocated before it."""
    real = pipeline.count_genome

    def counted(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    return real, counted


def slice_phase(work: str, card: str) -> dict:
    """Drive the index build through the CLI and check what it wrote.
    Returns the launch counts of the run."""
    from panagram_tpu_torch import pipeline
    from panagram_tpu_torch.__main__ import main
    from panagram_tpu_torch.io.bgzf import BgzfReader, decompress_file
    from panagram_tpu_torch.ops import kernels
    from panagram_tpu_torch.ops.dictionary import PanKmerDict
    from panagram_tpu_torch.ops.ref_impl import anchor_np, masks_to_bytes_np

    t0 = time.perf_counter()
    seqs = make_genomes(work)
    print(f"generated {GENOMES} x {GENOME_BP / 1e6:g} Mbp genomes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prefix = os.path.join(work, "idx")
    peaks: list = []
    real, pipeline.count_genome = count_peaks(pipeline, peaks)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        main(["index", os.path.join(work, "samples.tsv"), "-k", str(K),
              "--prefix", prefix, "--anchor-genomes", *ANCHORS])
        torch.cuda.synchronize()
    finally:
        pipeline.count_genome = real
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print(f"index build: {wall:.2f} s wall, launches {launches}", flush=True)
    for name in ANCHOR_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the build")
    print(f"count stage peak device memory [{card}]: "
          f"{max(peaks) / 2**20:.1f} MiB (largest of {len(peaks)} genomes, "
          f"2^22-position chunks)", flush=True)

    N, nbytes = GENOMES, (GENOMES + 7) // 8
    need = [os.path.join(prefix, f) for f in
            ("samples.tsv", "config.yaml", "genome_dist.tsv", "kmc/pandict.npz")]
    need += [os.path.join(prefix, "kmc", f"g{g}.kmers.npz") for g in range(N)]
    for a in ANCHORS:
        d = os.path.join(prefix, "anchor", a)
        need += [os.path.join(d, f) for f in (
            "bitmap.1.gz", "bitmap.1.gzi", "bitmap.100.gz", "bitmap.100.gzi",
            "chrs.tsv", "bitsum.bins.tsv", "total_paircounts.csv")]
    missing = [f for f in need if not os.path.exists(f)]
    if missing:
        raise AssertionError(f"missing outputs: {missing}")

    pan = PanKmerDict.load(os.path.join(prefix, "kmc", "pandict.npz"))
    print(f"dictionary: {len(pan)} keys x {pan.nwords} words", flush=True)
    nk = GENOME_BP - K + 1
    for a in ANCHORS:
        d = os.path.join(prefix, "anchor", a)
        with BgzfReader(os.path.join(d, "bitmap.1.gz"),
                        os.path.join(d, "bitmap.1.gzi")) as r:
            head = r.read_at(0, ORACLE_POSITIONS * nbytes)
        if a == "g0":
            rows = anchor_np(seqs[a][:ORACLE_POSITIONS + K - 1], K,
                             pan.keys, pan.masks)
            if head != masks_to_bytes_np(rows, nbytes).tobytes():
                raise AssertionError("g0 bitmap differs from the numpy oracle "
                                     "over its first 2^17 positions")
            print(f"oracle: g0 bitmap.1 first {ORACLE_POSITIONS} positions "
                  "match ref_impl.anchor_np", flush=True)
        full = decompress_file(os.path.join(d, "bitmap.1.gz"))
        low = decompress_file(os.path.join(d, "bitmap.100.gz"))
        by = np.frombuffer(full, np.uint8).reshape(-1, nbytes)
        if by.shape[0] != nk or low != by[::100].tobytes():
            raise AssertionError(f"{a}: bitmap sizes {by.shape} / {len(low)}")
        popc = np.unpackbits(by, axis=1, bitorder="little").sum(axis=1).astype(np.int64)
        if popc.min() < 0 or popc.max() > N or (popc == 0).mean() > 0.01:
            raise AssertionError(f"{a}: implausible occupancy")
        with open(os.path.join(d, "bitsum.bins.tsv")) as f:
            f.readline()
            hist = np.array([[int(x) for x in line.split("\t")[2:]]
                             for line in f])
        if hist.sum() != nk or not np.array_equal(
                hist.sum(axis=0), np.bincount(popc, minlength=N + 1)):
            raise AssertionError(f"{a}: bitsum.bins.tsv disagrees with bitmap")
        with open(os.path.join(d, "total_paircounts.csv")) as f:
            rows_tp = [line.rstrip("\n").split(",") for line in f][1:]
        own = dict((r[0], r[2]) for r in rows_tp)[a]
        if own != "1.0" or len(rows_tp) != N:
            raise AssertionError(f"{a}: total_paircounts.csv {own}")
    with open(os.path.join(prefix, "genome_dist.tsv")) as f:
        nd = sum(1 for _ in f)
    if nd != N * (N - 1) // 2:
        raise AssertionError(f"genome_dist.tsv has {nd} lines")

    walls = stage_walls(prefix)
    count_s = sum(v for s, v in walls.items() if s.startswith("kmc."))
    anchor_s = sum(v for s, v in walls.items() if s.startswith("anchor."))
    print(f"stage walls [{card}]:", flush=True)
    print(f"  count (30 genomes)  {count_s:9.3f} s", flush=True)
    for s in ["dict", "layout"] + [f"anchor.{a}" for a in ANCHORS] + ["mash.triangle"]:
        print(f"  {s:18s}  {walls[s]:9.3f} s", flush=True)
    for a in ANCHORS:
        with open(os.path.join(prefix, "logs", f"anchor.{a}.log.txt")) as f:
            phases = [line for line in f if "anchor phases:" in line]
        print(f"  {a} {phases[-1].split('] ', 1)[1].strip()}", flush=True)
    print(f"anchored k-mers/s [{card}]: {len(ANCHORS) * nk / anchor_s:.4g} "
          f"({len(ANCHORS)} x {nk} positions in {anchor_s:.3f} s of anchor "
          f"stages); peak device memory after the count stage "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches


class _Lines(logging.Handler):
    """Keeps the messages logged while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def device_dict_phase(work: str, card: str) -> dict:
    """The same genomes through --device-dict; its dictionary and anchor
    files must equal the slice's.  Returns the run's launch counts."""
    from panagram_tpu_torch.__main__ import main
    from panagram_tpu_torch.ops import kernels
    from panagram_tpu_torch.ops.dictionary import PanKmerDict
    from panagram_tpu_torch.ops.lookup import mix64_np

    prefix = os.path.join(work, "idx_dd")
    lines = _Lines()
    pkg = logging.getLogger("panagram_tpu_torch")
    pkg.addHandler(lines)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        main(["index", os.path.join(work, "samples.tsv"), "-k", str(K),
              "--prefix", prefix, "--device-dict", "--anchor-genomes",
              *ANCHORS])
        torch.cuda.synchronize()
    finally:
        pkg.removeHandler(lines)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print(f"index --device-dict build: {wall:.2f} s wall, launches "
          f"{launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    # the anchor stages launch pack_mix once per chunk, as probe_sorted;
    # the rest ran in the dict stage, once per sequence chunk
    chunks = GENOMES * -(-(GENOME_BP - K + 1) // CHUNK)
    dict_launches = launches["pack_mix"] - launches["probe_sorted"]
    if dict_launches != chunks:
        raise AssertionError(f"pack_mix ran {dict_launches} times in the "
                             f"device-dict stage, not once per chunk ({chunks})")
    for name in ANCHOR_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "--device-dict build")

    ref = PanKmerDict.load(os.path.join(work, "idx", "kmc", "pandict.npz"))
    got = PanKmerDict.load(os.path.join(prefix, "kmc", "pandict.npz"))
    mixed = mix64_np(ref.keys)
    order = np.argsort(mixed)
    if got.key_space != "mixed" or not np.array_equal(got.keys, mixed[order]) \
            or not np.array_equal(got.masks, ref.masks[order]):
        raise AssertionError("--device-dict pandict.npz is not the slice's "
                             "dictionary in mixed space")
    print(f"device dictionary: {len(got)} keys equal the slice's dictionary "
          "mixed", flush=True)
    for a in ANCHORS:
        for f in ("bitmap.1.gz", "bitmap.1.gzi", "bitmap.100.gz",
                  "bitmap.100.gzi", "chrs.tsv", "bitsum.bins.tsv",
                  "total_paircounts.csv"):
            if not filecmp.cmp(os.path.join(prefix, "anchor", a, f),
                               os.path.join(work, "idx", "anchor", a, f),
                               shallow=False):
                raise AssertionError(f"--device-dict anchor/{a}/{f} differs "
                                     "from the slice's")
    print(f"--device-dict anchor files of {', '.join(ANCHORS)} are "
          "byte-identical to the slice's", flush=True)

    walls = stage_walls(prefix)
    print(f"--device-dict stage walls [{card}]:", flush=True)
    for s in ["dict", "layout"] + [f"anchor.{a}" for a in ANCHORS] + ["mash.triangle"]:
        print(f"  {s:18s}  {walls[s]:9.3f} s", flush=True)
    phases = [m for m in lines.lines if m.startswith("dict phases:")]
    print(f"  builder: {phases[-1]}", flush=True)
    return launches


def layout_phase(dev, card: str):
    """~1e8 mixed keys (W=1) laid out through build_device, the single-pass
    route and the chunked route; the tables must be equal."""
    from panagram_tpu_torch.ops import lookup
    from panagram_tpu_torch.ops.codec import mix64, sort_u64, split64

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    keys = torch.randint(0, 1 << 62, (LAYOUT_KEYS,), generator=g, device=dev)
    m = torch.unique_consecutive(sort_u64(mix64(keys)))
    del keys
    D = m.shape[0]
    masks = torch.randint(1, 1 << 30, (D, 1), generator=g, device=dev,
                          dtype=torch.int32)
    torch.cuda.synchronize()
    route = lookup.layout_route(D, 1, dev, True)
    nbits0, cap, stride = lookup.table_geometry(D, 1)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bd = lookup.BucketedDict.build_device(m, masks, 30, K, dev, mixed=True,
                                          count=D, sorted_input=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() - base
    nbits = bd.nbits
    table = bd.table.view(-1)
    print(f"layout phase [{card}]: {D} keys, W=1: build_device took route "
          f"{route}, nbits {nbits0} -> {nbits}, table 2^{nbits} x {stride} "
          f"u32 = {table.numel() * 4 / 2**30:.2f} GiB, {build_s:.3f} s "
          f"(with the retry), peak {build_peak / 2**30:.2f} GiB above the "
          "inputs", flush=True)

    for name, run, model in (
            ("single", lambda: lookup._layout_device(m, masks, nbits, cap,
                                                     stride, pre_sorted=True),
             lookup.layout_bytes(D, 1, "sorted") - 12 * D),
            ("chunked", lambda: lookup._layout_device_chunked(
                m, masks, nbits, cap, stride),
             lookup.layout_bytes(D, 1, "chunked") - 12 * D)):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got, overflow = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trans = torch.cuda.max_memory_allocated() - before - table.numel() * 4
        if int(overflow) != 0 or not torch.equal(got, table):
            raise AssertionError(f"{name} layout at 2^{nbits}: overflow "
                                 f"{int(overflow)}, tables differ")
        del got
        print(f"  {name:8s} route at 2^{nbits}: {wall:.3f} s, equal table, "
              f"overflow 0; transients beside its table and the inputs "
              f"{trans / 2**30:.2f} GiB (byte model {model / 2**30:.2f} GiB)",
              flush=True)

    # a sample of keys finds its masks, absent keys find nothing
    idx = torch.randint(0, D, (1 << 20,), generator=g, device=dev)
    hi, lo = split64(m[idx])
    rows = lookup.bucket_query(hi, lo, bd.table, nbits, bd.cap, 1)
    miss = lookup.bucket_query(hi ^ 1, lo, bd.table, nbits, bd.cap, 1)
    if not torch.equal(rows, masks[idx]) or bool(miss.any()):
        raise AssertionError("layout phase: sampled keys do not find their masks")
    print("  2^20 sampled keys find their masks; flipped keys miss", flush=True)
    del bd, table, m, masks
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on a CUDA card")
    from panagram_tpu_torch import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    build_s = _build.build(force=True)
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a)", flush=True)
    with open(_build.LOG_PATH) as f:
        kernel = "?"
        for line in f:
            if "Compiling entry function" in line:
                kernel = next((n for n, src, _ in KERNELS
                               if os.path.basename(src)[:-3] in line),
                              line.split("'")[1])
            elif "Used" in line and "registers" in line:
                print(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}",
                      flush=True)

    rng = np.random.default_rng(1)
    print(f"kernel phase [{card}] (2^22-position chunk, k={K}):", flush=True)
    measured = {n: kernel_phase(dev, n, rng) for n in (30, 40)}
    mosaic, mosaic_launches = mosaic_phase(dev)

    with tempfile.TemporaryDirectory() as work:
        launches = slice_phase(work, card)
        device_dict_phase(work, card)
    launches["mosaic_probe"] = mosaic_launches
    layout_phase(dev, card)

    rows = []
    for name, source, replaces in KERNELS:
        if name == "mosaic_probe":
            err = max(r[0] for r in mosaic.values())
            _, ms, plain_ms = mosaic[MOSAIC_SIZES[-1]]
        else:
            err = max(measured[n][name][0] for n in measured)
            _, ms, plain_ms = measured[30][name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
