"""Sharded big-dictionary run, tools/bigdict_mesh.py's: build a >= 1e8-key
range-sharded dictionary over a mesh of ranks and hold it, and an anchor
through its sharded probe, to a host oracle.

    python -m panagram_tpu_torch.tools.bigdict_mesh [--mbp 26] [--genomes 4]
        [--devices 8] [--anchor-mbp 2] [--k 21] [--device cuda]

`--genomes` random genomes of `--mbp` Mbp (np.random.default_rng(11), one
rng.integers(0, 4, glen, dtype=np.uint8) per genome, in order, so they are
the JAX tool's genomes; at the defaults their union is 103,997,462 keys)
are counted into sorted distinct canonical sets, and `--devices` ranks
build the range-sharded dictionary from them
(parallel.shard.sharded_build_dictionary with return_host_dict=True), then
anchor `--anchor-mbp` of genome 0 through make_halo_chunks and
sharded_anchor_chunk, 2^18 positions per rank and chunk.  The writer's
host dictionary must equal the mixed-sorted distinct union with the
presence bits OR'd, and the anchored bytes, popcounts and column sums the
numpy oracle's; any difference raises.  It prints the JAX tool's lines in
its order, ending with the RESULT line.

Where it differs from the JAX tool:

* Ranks: the JAX tool's mesh is 8 virtual devices of one CPU process.
  Here each rank is a process of its own, spawned by parallel.mesh.launch:
  `--device cpu` runs `--devices` Gloo ranks on the CPU (the JAX tool's
  measured run is `--devices 8 --device cpu`); the default, cuda, runs one
  NCCL rank per card, so `--devices N` needs N visible cards and raises
  naming the count before any work otherwise.  On one card `--devices 1`
  holds the whole range-sharded dictionary: 2^25 x 64 u32 = 8 GiB at the
  defaults, the JAX tool's 8 x 1 GiB.
* Sets: ops.ref_impl.genome_sets (np.sort and a diff: numpy 2's np.unique
  is far slower at 1e7 keys) written as .npy files to a temporary
  directory, which each rank maps (mmap_mode="r") and reads its slice of;
  the writer saves the host dictionary there, so that neither travels
  through launch's pipes.  The directory is removed at the end, also when
  the run fails.
* Budget: on cuda each rank calls lookup.check_hbm_budget against its
  card's free memory with the range shard's "bucket" layout.  On the CPU
  no device budget exists: the line prints the model's bytes per shard
  (table_geometry and layout_bytes) beside the shard's table and says that
  nothing was checked.  Each rank's peak is its peak device memory on cuda
  (RankResult.peak_bytes), on the CPU its own peak resident set as a
  thread samples it (getrusage's maxrss would be the parent's, carried
  across the spawned rank's exec, and not every kernel's /proc has
  VmHWM).
* Anchor: the ranks return dense rows (panagram_tpu's run-length rows and
  their unpack_rle2 / rle2_colsums are not ported), and positions past the
  end of genome 0 are not anchored.
* Oracle: the union of the sets with np.sort and a diff and their bits by
  searchsorted (ref_impl.union_dict), ordered by mixed key (mix64 is a
  bijection, so this is the JAX tool's merge oracle); the anchor against
  ref_impl.anchor_np over that union.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

# positions per rank of an anchor chunk (the JAX tool's; tests set smaller
# ones, which run() passes to the ranks)
CHUNK_PER_DEV = 1 << 18
SEED = 11
# seconds between two readings of a rank's resident set
RSS_EVERY_S = 0.02


@dataclasses.dataclass
class BigDictMesh:
    """What one run measured and made (run())."""

    D: int                  # keys of the writer's host dictionary
    host_D: int             # the host's exact distinct count of the sets
    k: int
    ngenomes: int
    nwords: int
    nbytes: int             # bitmap bytes per position
    n_shards: int
    device: str             # "cpu" or "cuda"
    nbits: int              # per-shard geometry (the same on every rank)
    cap: int
    stride: int
    shard_bytes: int        # one shard's table
    model: dict             # per-shard model: "table", "layout" bytes
    budget_checked: bool    # check_hbm_budget ran against a device's memory
    checked_bytes: list     # per rank: the most the build's checks counted
    peaks: list             # per rank: (bytes or None, what the figure is)
    walls: dict             # s: "sets", "build", "anchor", "oracle", "launch"
    launches: list          # per rank: its kernel launches
    keys: np.ndarray        # the writer's host dictionary, mixed keys
    masks: np.ndarray
    nk: int                 # anchored positions
    bytes: np.ndarray       # anchored bitmap bytes [nk, nbytes]
    popc: np.ndarray        # popcounts [nk]
    colsums: np.ndarray     # int64 [ngenomes]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sample_rss(stop: threading.Event, peak: list):
    """Keep in peak[0] the largest resident set of this process, read from
    /proc/self/statm every RSS_EVERY_S s until stop is set; peak[0] stays
    None where there is no such file."""
    page = os.sysconf("SC_PAGE_SIZE")
    while True:
        try:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * page
        except OSError:
            return
        peak[0] = max(peak[0] or 0, rss)
        if stop.wait(RSS_EVERY_S):
            return


def _rank(mesh, set_paths, ngenomes: int, k: int, anchor_path: str,
          workdir: str, cpd: int) -> dict:
    """One rank: the sharded build from the mapped sets, the writer's host
    dictionary saved to workdir, the budget check on a card, then the
    anchor in chunks of cpd positions per rank, gathered to the writer.
    Returns small values only (the anchored rows on the writer)."""
    from panagram_tpu_torch.ops.lookup import check_hbm_budget
    from panagram_tpu_torch.parallel.mesh import (
        all_sum,
        barrier,
        gather_to_writers,
    )
    from panagram_tpu_torch.parallel.shard import (
        make_halo_chunks,
        sharded_anchor_chunk,
        sharded_build_dictionary,
    )

    dev, S = mesh.device, mesh.size
    stop, host_peak = threading.Event(), [None]
    sampler = threading.Thread(target=_sample_rss, args=(stop, host_peak),
                               daemon=True)
    sampler.start()
    sets = [np.load(p, mmap_mode="r") for p in set_paths]
    barrier(mesh)
    t0 = time.perf_counter()
    sbd, pan = sharded_build_dictionary(sets, mesh, ngenomes=ngenomes, k=k,
                                        return_host_dict=True)
    _sync(dev)
    t_build = time.perf_counter() - t0
    out = {"rank": mesh.rank, "nbits": sbd.nbits, "cap": sbd.cap,
           "stride": sbd.stride, "n_shards": sbd.n_shards,
           "shard_bytes": sbd.table.numel() * 4,
           "checked_bytes": sbd.checked_bytes, "build_s": t_build}
    if pan is not None:
        out["keys"] = os.path.join(workdir, "keys.npy")
        out["masks"] = os.path.join(workdir, "masks.npy")
        np.save(out["keys"], pan.keys)
        np.save(out["masks"], pan.masks)
    D = int(all_sum(mesh, torch.tensor(
        [len(pan.keys) if mesh.rank == 0 else 0], device=dev)))
    del pan
    out["budget_checked"] = dev.type == "cuda"
    if dev.type == "cuda":
        check_hbm_budget(D, sbd.nwords, n_shards=S,
                         what="bigdict_mesh verification",
                         device_layout="bucket", device=dev)

    codes = np.load(anchor_path, mmap_mode="r")
    nk = len(codes) - k + 1
    parts, colsums = [], np.zeros(ngenomes, np.int64)
    barrier(mesh)
    t0 = time.perf_counter()
    for pos in range(0, nk, S * cpd):
        span = min(S * cpd, nk - pos)
        chunks, n = make_halo_chunks(codes[pos:pos + span + k - 1], S, k,
                                     chunk_per_dev=cpd)
        by, popc, cs = sharded_anchor_chunk(mesh, sbd, chunks[mesh.rank])
        bys = gather_to_writers(mesh, by)
        popcs = gather_to_writers(mesh, popc)
        css = gather_to_writers(mesh, cs)
        if not mesh.writer:
            continue
        for d in range(S):
            real = min(max(n - d * cpd, 0), cpd)
            if real == 0:
                break
            parts.append((bys[d][:real].cpu().numpy(),
                          popcs[d][:real].cpu().numpy()))
        for c in css:
            colsums += c.cpu().numpy()[:ngenomes]
    _sync(dev)
    out["anchor_s"] = time.perf_counter() - t0
    stop.set()
    sampler.join()
    out["host_peak"] = host_peak[0]
    if mesh.writer:
        nbytes = sbd.nbytes_row
        out["bytes"] = (np.concatenate([p[0] for p in parts]) if parts
                        else np.zeros((0, nbytes), np.uint8))
        out["popc"] = (np.concatenate([p[1] for p in parts]) if parts
                       else np.zeros(0, np.int32))
        out["colsums"] = colsums
    return out


def _gib(b: int) -> str:
    return f"{b / 2**30:.2f} GiB"


def run(genomes: int = 4, mbp: float = 26.0, devices: int = 8,
        anchor_mbp: float = 2.0, k: int = 21, *, device="cuda",
        timeout: float | None = None) -> BigDictMesh:
    """The JAX tool's run on `devices` ranks of `device`, printing its
    lines: the genomes and their sets, the sharded build, each shard's
    geometry beside the budget model, dictionary parity against the host
    oracle, the anchor of `anchor_mbp` Mbp of genome 0 and its parity, the
    RESULT line.  Raises on any difference, on a failed rank, and when the
    ranks outlast `timeout` seconds."""
    from panagram_tpu_torch.ops.lookup import (
        layout_bytes,
        mix64_np,
        table_geometry,
    )
    from panagram_tpu_torch.ops.ref_impl import (
        anchor_np,
        genome_sets,
        masks_to_bytes_np,
        popcount_np,
        union_dict,
    )
    from panagram_tpu_torch.parallel.mesh import check_ranks, launch
    from panagram_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    check_ranks(devices, dev.type)
    glen = int(mbp * 1e6)
    W, nbytes = (genomes + 31) // 32, (genomes + 7) // 8
    rng = np.random.default_rng(SEED)
    print(f"generating {genomes} x {mbp} Mbp random genomes...", flush=True)
    codes = [rng.integers(0, 4, glen, dtype=np.uint8) for _ in range(genomes)]
    t0 = time.perf_counter()
    sets = genome_sets(codes, k)
    walls = {"sets": time.perf_counter() - t0}
    for g, s in enumerate(sets):
        print(f"  genome {g}: {len(s)} distinct", flush=True)
    print(f"aggregate (with overlap): {sum(len(s) for s in sets)}",
          flush=True)
    nk = max(0, min(int(anchor_mbp * 1e6), glen - k + 1))
    anchor = codes[0][:nk + k - 1]

    workdir = tempfile.mkdtemp(prefix="bigdict_mesh_")
    try:
        paths = [os.path.join(workdir, f"set{g}.npy") for g in range(genomes)]
        for p, s in zip(paths, sets):
            np.save(p, s)
        apath = os.path.join(workdir, "anchor.npy")
        np.save(apath, anchor)
        t0 = time.perf_counter()
        ranks = launch(_rank, (paths, genomes, k, apath, workdir,
                               CHUNK_PER_DEV), devices, dev.type,
                       timeout=timeout)
        walls["launch"] = time.perf_counter() - t0
        w = ranks[0].value
        keys, masks = np.load(w["keys"]), np.load(w["masks"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    walls["build"], walls["anchor"] = w["build_s"], w["anchor_s"]
    D = len(keys)
    geo = [(r.value["nbits"], r.value["cap"], r.value["stride"])
           for r in ranks]
    if len(set(geo)) != 1:
        raise AssertionError(f"ranks disagree on the shard geometry: {geo}")
    nbits, cap, stride = geo[0]
    print(f"sharded build: D={D} distinct keys across {w['n_shards']} "
          f"shards in {walls['build']:.1f} s", flush=True)

    # ---- layout vs the budget model --------------------------------------
    rows, shard_bytes = 1 << nbits, w["shard_bytes"]
    print(f"per-shard table: [{rows} buckets x {stride} u32] = "
          f"{_gib(shard_bytes)}; cap={cap} (aggregate "
          f"{_gib(devices * shard_bytes)})", flush=True)
    per_shard = -(-D // devices)
    mb, _, ms = table_geometry(max(per_shard, 1), W)
    model = {"table": (1 << mb) * ms * 4,
             "layout": layout_bytes(per_shard, W, "bucket", n_buckets=rows)}
    if w["budget_checked"]:
        print("check_hbm_budget: sharded layout fits its model (each "
              "rank's card, its free memory)", flush=True)
    else:
        print(f"budget model per shard: table {_gib(model['table'])} + "
              f"bucket layout {_gib(model['layout'])}, beside the shard's "
              f"table of {_gib(shard_bytes)}; no device budget checked (the "
              "ranks run on the CPU)", flush=True)
    if dev.type == "cuda":
        peaks = [(r.peak_bytes, "peak device memory") for r in ranks]
    else:
        peaks = [(r.value["host_peak"], "host peak RSS") for r in ranks]
    line = "rank peaks: " + ", ".join(
        f"{r.rank} {'not measured' if b is None else _gib(b)} ({what})"
        for r, (b, what) in zip(ranks, peaks))
    if w["budget_checked"]:
        line += "; the build's budget checks counted " + ", ".join(
            _gib(r.value["checked_bytes"]) for r in ranks)
    print(line, flush=True)

    # ---- dictionary correctness vs the host oracle -----------------------
    t0 = time.perf_counter()
    ukeys, umasks = union_dict(sets)
    mixed = mix64_np(ukeys)
    order = np.argsort(mixed)
    if not np.array_equal(keys, mixed[order]):
        raise AssertionError("sharded keys != host oracle")
    if not np.array_equal(masks, umasks[order]):
        raise AssertionError("sharded masks != host oracle")
    del mixed, order
    print(f"dictionary parity vs host oracle OK ({len(ukeys)} keys)",
          flush=True)

    # ---- the anchor through the sharded probe + all_to_all ---------------
    by, popc, colsums = w["bytes"], w["popc"], w["colsums"]
    print(f"sharded anchor: {nk} positions in {walls['anchor']:.1f} s "
          f"({nk / max(walls['anchor'], 1e-9) / 1e6:.1f} M kmers/s on "
          f"{devices} {dev.type} rank(s))", flush=True)
    want = anchor_np(anchor, k, ukeys, umasks)
    if not np.array_equal(by, masks_to_bytes_np(want, nbytes)):
        raise AssertionError("sharded anchored bytes != oracle")
    if not np.array_equal(popc, popcount_np(want)):
        raise AssertionError("popc mismatch")
    bits = np.unpackbits(want.astype("<u4").view(np.uint8), axis=1,
                         bitorder="little")[:, :genomes]
    if not np.array_equal(colsums, bits.sum(axis=0)):
        raise AssertionError("colsums mismatch")
    walls["oracle"] = time.perf_counter() - t0
    print("anchored byte parity vs single-device oracle OK", flush=True)
    print(f"walls: sets {walls['sets']:.1f} s, ranks {walls['launch']:.1f} s "
          f"(spawn, build, anchor), oracle {walls['oracle']:.1f} s",
          flush=True)
    print(f"RESULT D={D} shards={devices} "
          f"per_shard_gib={shard_bytes / 2**30:.2f} "
          f"build_s={walls['build']:.1f} anchor_s={walls['anchor']:.1f}",
          flush=True)
    return BigDictMesh(
        D=D, host_D=len(ukeys), k=k, ngenomes=genomes, nwords=W,
        nbytes=nbytes, n_shards=devices, device=dev.type, nbits=nbits,
        cap=cap, stride=stride, shard_bytes=shard_bytes, model=model,
        budget_checked=w["budget_checked"],
        checked_bytes=[r.value["checked_bytes"] for r in ranks], peaks=peaks,
        walls=walls, launches=[r.launches for r in ranks], keys=keys,
        masks=masks, nk=nk, bytes=by, popc=popc, colsums=colsums)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mbp", type=float, default=26.0)
    ap.add_argument("--genomes", type=int, default=4)
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the mesh (on cuda, one card each)")
    ap.add_argument("--anchor-mbp", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--device", default="cuda",
                    help="torch device type of the ranks (default cuda: one "
                    "NCCL rank per card; cpu: Gloo ranks on the CPU)")
    args = ap.parse_args(argv)
    run(args.genomes, args.mbp, args.devices, args.anchor_mbp, args.k,
        device=args.device)
    return 0


if __name__ == "__main__":
    main()
