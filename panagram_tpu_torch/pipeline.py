"""Index build: the stage DAG of panagram_tpu.pipeline on one device.

  count[g]   per-genome distinct canonical k-mer set  -> kmc/<g>.kmers.npz
             (a FASTQ read set keeps k-mers seen at least twice)
  dict       merged presence-mask dictionary          -> kmc/pandict.npz
  layout     bucket table, laid out on the device once for all anchors
  anchor[g]  per-anchor bitmaps + summaries           -> anchor/<g>/*
  dist       exact-Jaccard genome distances           -> genome_dist.tsv

With device_dict=True (``--device-dict``) one stage replaces count and
dict: every genome streams through the device-resident builder
(ops/devdict.py), and pandict.npz holds mixed keys.

A stage is skipped when its outputs exist and are no older than its inputs,
and each stage that runs writes its wall time to logs/<stage>.benchmark.txt
(the names of panagram_tpu's: kmc.<g>, dict, anchor.<g>, mash.triangle,
plus layout).  Every device step runs on the `device` given.  With
cores > 1 the anchor genomes run in that many threads, each with its own
CUDA stream, against the one bucket table.

With mesh_devices=N (``--mesh N``) the same DAG runs on N ranks, one per
device (parallel/): the writer rank counts, the dictionary is merged and
sharded across the ranks, every rank anchors its share of each chunk, and
the writer writes every file.  Stage-skip decisions are checked equal on
every rank.
"""

from __future__ import annotations

import gzip
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .distances import write_genome_dist
from .index import Index
from .io.fasta import iter_fasta, seq_to_codes
from .ops.count import counted_kmers_chunked, distinct_kmers_chunked
from .ops.devdict import DeviceDictBuilder
from .ops.dictionary import PanKmerDict, build_dictionary, npz_member
from .ops.lookup import BucketedDict
from .parallel.mesh import (
    Mesh,
    barrier,
    launch,
    lockstep_decision,
    sharded_writes_enabled,
    writes_pieces,
)
from .parallel.shard import (
    shard_dictionary,
    shard_dictionary_genomes,
    sharded_build_dictionary,
)
from .umap_embed import preload as preload_embedding_modules

logger = logging.getLogger(__name__)
_LOG_FORMAT = "[%(asctime)s %(levelname)s] %(message)s"
_LOG_DATEFMT = "%Y-%m-%d %H:%M:%S"

# FASTQ reads must hold a k-mer this many times to count (KMC's -ci2)
FASTQ_MIN_COUNT = 2


def resolve_device(device) -> torch.device:
    """torch.device for `device`; asking for CUDA without a usable card
    raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is false")
    return dev


def _benchmark(prefix: str, name: str, t0: float):
    os.makedirs(os.path.join(prefix, "logs"), exist_ok=True)
    s = time.time() - t0
    hms = time.strftime("%H:%M:%S", time.gmtime(s))
    with open(os.path.join(prefix, "logs", f"{name}.benchmark.txt"), "w") as f:
        f.write("s\th:m:s\n")
        f.write(f"{s:.4f}\t{hms}\n")


def _outputs_fresh(outputs, inputs) -> bool:
    if not outputs or not all(os.path.exists(o) for o in outputs):
        return False
    out_mtime = min(os.path.getmtime(o) for o in outputs)
    in_mtime = max(
        (os.path.getmtime(i) for i in inputs if i and os.path.exists(i)), default=0
    )
    return out_mtime >= in_mtime


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _iter_fastq(path):
    """Yield ("read", sequence) for each 4-line FASTQ record (gzip when the
    name ends in .gz) with a non-empty sequence line."""
    opn = gzip.open if str(path).endswith(".gz") else open
    with opn(path, "rt") as f:
        while True:
            if not f.readline():
                break
            seq = f.readline().strip()
            f.readline()
            f.readline()
            if seq:
                yield "read", seq


def _timed(items, phase: dict, key: str):
    """Yield from `items`, adding the seconds spent producing each item to
    phase[key]."""
    it = iter(items)
    end = object()
    while True:
        t0 = time.perf_counter()
        item = next(it, end)
        phase[key] += time.perf_counter() - t0
        if item is end:
            return
        yield item


def count_genome(index: Index, name: str, device: torch.device,
                 force=False) -> str:
    """Stage count[g]: distinct canonical k-mers of one genome: every k-mer
    of a FASTA, those seen FASTQ_MIN_COUNT times or more in a FASTQ read
    set.  Logs its phases: parse (reading the sequence file into codes),
    device (the counting, on `device`) and write (the npz)."""
    out = index.kmer_set_fname(name)
    g = index.genomes[name]
    fasta = g._fasta_path
    if not force and index.conf.kmc.use_existing and os.path.exists(out):
        return out
    if not force and _outputs_fresh([out], [fasta]):
        return out
    t0 = time.time()
    os.makedirs(index.kmer_dir, exist_ok=True)
    phase = {"parse": 0.0}
    tp = time.perf_counter()
    if g.is_fastq:
        codes = _timed((seq_to_codes(seq) for _, seq in _iter_fastq(fasta)),
                       phase, "parse")
        kmers = counted_kmers_chunked(codes, index.k, device,
                                      min_count=FASTQ_MIN_COUNT)
    else:
        codes = _timed((seq_to_codes(seq) for _, seq in iter_fasta(fasta)),
                       phase, "parse")
        kmers = distinct_kmers_chunked(codes, index.k, device)
    phase["device"] = time.perf_counter() - tp - phase["parse"]
    tp = time.perf_counter()
    tmp = out + f".tmp.{os.getpid()}.npz"
    np.savez(tmp, kmers=kmers, k=index.k)
    os.replace(tmp, out)
    phase["write"] = time.perf_counter() - tp
    _benchmark(index.prefix, f"kmc.{name}", t0)
    logger.info(f"counted {name}: {len(kmers)} distinct {index.k}-mers")
    logger.info(f"count phases {name}: " + " ".join(
        f"{k}={v:.3f}s" for k, v in phase.items()))
    return out


def _sequence_size_estimate(path) -> int:
    """Decompressed byte size of a (possibly gzipped) sequence file: for
    .gz the ISIZE trailer (uncompressed length mod 2^32), or 4x the
    compressed size when that is implausibly small (a >4 GB genome wrapped
    around, or a multi-member file)."""
    raw = os.path.getsize(path)
    if not str(path).endswith(".gz"):
        return raw
    try:
        with open(path, "rb") as f:
            f.seek(-4, os.SEEK_END)
            isize = int.from_bytes(f.read(4), "little")
        if isize >= raw // 2:
            return isize
    except OSError:
        pass
    return raw * 4


def build_dict_device(index: Index, device: torch.device, force=False) -> str:
    """Stage dict of --device-dict, in place of count and dict: every
    genome streams through the device-resident builder; no per-genome set
    files, and resume granularity is the whole dictionary."""
    out = index.dict_fname
    fastq = [n for n in index.genome_names if index.genomes[n].is_fastq]
    if fastq:
        # panagram_tpu's device builder reads a FASTQ file as FASTA and
        # finds no record in it: refuse instead of an empty presence column
        raise ValueError(
            f"--device-dict cannot count the FASTQ read set(s) {fastq}: "
            "build without --device-dict (the default route counts reads "
            "with min-count 2)")
    fastas = [index.genomes[n]._fasta_path for n in index.genome_names]
    if not force and _outputs_fresh([out], fastas):
        return out
    t0 = time.time()
    os.makedirs(index.kmer_dir, exist_ok=True)
    # capacity hint: the largest genome plus headroom (the union of related
    # genomes is far below their sum; the builder grows past the hint)
    sizes = [_sequence_size_estimate(f) for f in fastas
             if f and os.path.exists(f)]
    hint = int(max(sizes) * 1.5) if sizes else None
    b = DeviceDictBuilder(index.k, index.ngenomes, device, capacity_hint=hint)
    phase = {"io": 0.0, "device": 0.0}
    for gid, name in enumerate(index.genome_names):
        g = index.genomes[name]
        if g.fasta is None:
            continue
        for _, seq in iter_fasta(g._fasta_path):
            tp = time.perf_counter()
            codes = seq_to_codes(seq)
            phase["io"] += time.perf_counter() - tp
            tp = time.perf_counter()
            b.add_sequence(gid, codes)
            phase["device"] += time.perf_counter() - tp
        tp = time.perf_counter()
        n_keys = b.synced_count()    # flushes the genome's buffered merge
        phase["device"] += time.perf_counter() - tp
        logger.info(f"device dict: merged {name} ({n_keys} keys)")
    tp = time.perf_counter()
    d = b.to_host()
    d.save(out)
    save_s = time.perf_counter() - tp
    w = b.walls
    logger.info(
        f"dict phases: io={phase['io']:.1f}s device={phase['device']:.1f}s "
        f"to_host+save={save_s:.1f}s | pack={w['pack']:.1f}s "
        f"chunk_disp={w['chunk_dispatch']:.1f}s "
        f"union_disp={w['union_dispatch']:.1f}s "
        f"merge_disp={w['merge_dispatch']:.1f}s sync={w['sync']:.1f}s "
        f"(first {w['first_sync']:.1f}s) over {w['flushes']} flushes")
    _benchmark(index.prefix, "dict", t0)
    logger.info(f"device dictionary: {len(d)} keys x {d.nwords} words")
    return out


def _load_sets(index: Index, mmap: bool = False) -> list[np.ndarray]:
    """The per-genome k-mer sets in genome-id (samples.tsv row) order; a
    genome without sequence contributes an empty set.  mmap=True maps the
    sets read-only (npz_member), for a rank that reads a slice of them."""
    sets = []
    for name in index.genome_names:
        if index.genomes[name].fasta is None:
            sets.append(np.zeros(0, np.uint64))
            continue
        f = index.kmer_set_fname(name)
        k = int(npz_member(f, "k"))
        if k != index.k:
            raise ValueError(f"{f}: k={k} != index k={index.k}")
        sets.append(npz_member(f, "kmers", mmap))
    return sets


def build_dict_stage(index: Index, device: torch.device, force=False) -> str:
    """Stage dict: merge the per-genome sets (_load_sets)."""
    out = index.dict_fname
    set_files = [index.kmer_set_fname(n) for n in index.genome_names
                 if index.genomes[n].fasta is not None]
    if not force and _outputs_fresh([out], set_files):
        return out
    t0 = time.time()
    tp = time.perf_counter()
    sets = _load_sets(index)
    t_read = time.perf_counter() - tp
    d = build_dictionary(sets, index.k, ngenomes=index.ngenomes,
                         device=device)
    t_device = time.perf_counter() - tp - t_read
    d.save(out)
    t_write = time.perf_counter() - tp - t_read - t_device
    _benchmark(index.prefix, "dict", t0)
    logger.info(f"dictionary: {len(d)} keys x {d.nwords} words")
    logger.info(f"dict phases: read={t_read:.3f}s device={t_device:.3f}s "
                f"write={t_write:.3f}s")
    return out


def layout_stage(index: Index, pan_dict: PanKmerDict,
                 device: torch.device) -> BucketedDict:
    """Lay the dictionary out as the bucket table on the device, once;
    every anchor genome probes the same table.  Keys and masks go up, the
    table is built there (BucketedDict.build_device); a mixed dictionary
    (--device-dict) is already sorted in mixed space, so its layout skips
    the grouping sort."""
    t0 = time.time()
    mixed = pan_dict.key_space == "mixed"
    bd = BucketedDict.build_device(pan_dict.keys, pan_dict.masks,
                                   index.ngenomes, index.k, device,
                                   mixed=mixed, sorted_input=mixed)
    _sync(device)
    _benchmark(index.prefix, "layout", t0)
    logger.info(f"bucket table: 2^{bd.nbits} buckets x {bd.stride} u32")
    return bd


def anchor_outputs(index: Index, name: str) -> list[str]:
    g = index.genomes[name]
    return [g.chrs_fname, g.bins_fname] + [g.bitmap_gz_fname(s)
                                           for s in index.steps]


def anchor_stage(index: Index, name: str, bucketed: BucketedDict | None,
                 per_stage_logfile=True, mesh=None, sharded=None):
    """Stage anchor[g], with its log in logs/anchor.<g>.log.txt when
    per_stage_logfile (a threaded run has no per-anchor log: the package
    logger is shared by every thread, as panagram_tpu's threaded path).
    On a mesh every rank calls it with its `sharded` dictionary; only
    writers log and time the stage."""
    if mesh is not None and not mesh.writer:
        index.genomes[name].run_anchor(mesh=mesh, sharded=sharded)
        return
    t0 = time.time()
    handler = None
    pkg = logging.getLogger("panagram_tpu_torch")
    if per_stage_logfile:
        log = os.path.join(index.prefix, "logs", f"anchor.{name}.log.txt")
        handler = logging.FileHandler(log, mode="w")
        handler.setFormatter(logging.Formatter(_LOG_FORMAT, _LOG_DATEFMT))
        pkg.addHandler(handler)
    try:
        index.genomes[name].run_anchor(bucketed, mesh, sharded)
    finally:
        if handler is not None:
            pkg.removeHandler(handler)
            handler.close()
    _benchmark(index.prefix, f"anchor.{name}", t0)


def dist_stage(index: Index, pan_dict: PanKmerDict | None,
               device: torch.device, force=False) -> str:
    out = index.genome_dist_fname
    if not force and _outputs_fresh([out], [index.dict_fname]):
        return out
    t0 = time.time()
    if pan_dict is None:
        pan_dict = PanKmerDict.load(index.dict_fname)
    write_genome_dist(pan_dict, index.genome_names, out, device)
    _benchmark(index.prefix, "mash.triangle", t0)
    return out


def build_dict_mesh(index: Index, mesh: Mesh, force=False):
    """Stage dict of a range-strategy mesh build, on every rank: the
    per-genome sets merged by the distributed builder (parallel/shard.py),
    whose host copy the writers save as pandict.npz (mixed key space).  A
    fresh pandict.npz is sharded instead; every rank must take the same
    branch.  Each rank reads only its slice of the sets (or of the fresh
    dictionary).  Returns (this rank's ShardedBucketedDict, the
    PanKmerDict on writers, None on the other ranks)."""
    out = index.dict_fname
    set_files = [index.kmer_set_fname(n) for n in index.genome_names
                 if index.genomes[n].fasta is not None]
    fresh = lockstep_decision(mesh, "dict-cache", lambda: bool(
        not force and _outputs_fresh([out], set_files)))
    if fresh:
        pan = PanKmerDict.load(out, mmap=not mesh.writer)
        return shard_dictionary(pan, mesh), pan if mesh.writer else None
    t0 = time.time()
    sets = _load_sets(index, mmap=True)
    t1 = time.time()
    sbd, pan = sharded_build_dictionary(sets, mesh, ngenomes=index.ngenomes,
                                        k=index.k)
    del sets
    t2 = time.time()
    if mesh.writer:
        pan.save(out)
        _benchmark(index.prefix, "dict", t0)
        logger.info(f"mesh dictionary: {len(pan)} keys x {pan.nwords} words "
                    f"over {mesh.size} ranks; load {t1 - t0:.3f}s, build and "
                    f"gather {t2 - t1:.3f}s, save {time.time() - t2:.3f}s")
    return sbd, pan


def _mesh_rank(mesh: Mesh, prefix: str, force: bool, strategy: str) -> dict:
    """The build DAG on one rank of a mesh (parallel/mesh.launch): the
    writer counts every genome, the dictionary is sharded by key range
    (merged by the distributed builder) or by mask words (merged by the
    writer), every anchor genome runs through the sharded engine, and the
    writer writes the distances.  Returns the rank's peak device memory
    up to the end of the dict stage ({"dict_peak_bytes": ...}; 0 on the
    CPU)."""
    logging.basicConfig(level=logging.INFO if mesh.writer else logging.WARNING,
                        format=_LOG_FORMAT, datefmt=_LOG_DATEFMT)
    index = Index(prefix, mode="w")
    dev = mesh.device
    if mesh.writer and index.anchor_genomes:
        preload_embedding_modules()    # only writers embed
    if mesh.writer:
        for name in index.genome_names:
            if index.genomes[name].fasta is not None:
                count_genome(index, name, dev, force=force)
    if strategy == "genomes":
        if mesh.writer:
            build_dict_stage(index, dev, force=force)
        barrier(mesh)
        pan = PanKmerDict.load(index.dict_fname, mmap=not mesh.writer)
        sharded = shard_dictionary_genomes(pan, mesh)
    else:
        sharded, pan = build_dict_mesh(index, mesh, force=force)
    dict_peak = (torch.cuda.max_memory_allocated(dev)
                 if dev.type == "cuda" else 0)
    pieces = strategy == "range" and sharded_writes_enabled(mesh)
    for name in index.anchor_genomes:
        g = index.genomes[name]
        outs = anchor_outputs(index, name)
        if pieces:
            # the stitched bitmap exists only under process 0's prefix: every
            # process decides on that copy, or a partial rerun desyncs
            outs = outs[:2] + [g.primary_bitmap_fname(s, mesh.process_index)
                               for s in index.steps]
        skip = lockstep_decision(mesh, f"anchor-skip:{name}", lambda: bool(
            not force and _outputs_fresh(
                outs, [index.dict_fname, g._fasta_path])))
        if not skip:
            anchor_stage(index, name, None, mesh=mesh, sharded=sharded)
    if mesh.writer:
        dist_stage(index, pan, dev, force=force)
    return {"dict_peak_bytes": dict_peak}


def build_index(samples_or_dir: str, prefix=None, force=False,
                device="cuda", device_dict=False, mesh_devices=None,
                mesh_strategy="range", num_processes=1, process_id=0,
                coordinator=None, **params) -> Index:
    """Run the build DAG.  `samples_or_dir` is a samples.tsv (fresh build)
    or an initialized index dir (resume).  device_dict=True counts and
    merges on the device in one stage (build_dict_device).

    mesh_devices=N builds on a mesh of N ranks, one per device (`device`
    "cuda": cuda:0 .. cuda:N-1 on NCCL; "cpu": Gloo), started here
    (parallel/mesh.launch); mesh_strategy "range" shards the dictionary by
    key range and each chunk by position, "genomes" by mask words.  With
    num_processes > 1 this process is process_id of that many, holding
    N / num_processes of the ranks, all meeting at `coordinator`
    (host:port, served by process 0); device_dict does not apply.  A mesh
    build leaves this process's ranks' parallel.mesh.RankResults (their
    kernel launches, peak device memory and _mesh_rank's report) in the
    returned Index's mesh_ranks.  Returns the index in read mode, as
    panagram_tpu does (in write mode on a process of a piece-writing build
    other than 0, whose prefix holds no bitmap)."""
    dev = resolve_device(device)
    # INFO to stderr unless the process configured logging already (what
    # panagram_tpu's init_logger does); anchor logs also go to logs/
    logging.basicConfig(level=logging.INFO, format=_LOG_FORMAT,
                        datefmt=_LOG_DATEFMT)
    if mesh_devices and mesh_strategy not in ("range", "genomes"):
        raise ValueError(f"unknown mesh strategy '{mesh_strategy}'")
    index = Index(samples_or_dir, mode="w", prefix=prefix, **params)
    os.makedirs(os.path.join(index.prefix, "logs"), exist_ok=True)
    if mesh_devices:
        ranks = launch(
            _mesh_rank, (index.prefix, force, mesh_strategy), mesh_devices,
            dev.type, num_processes, process_id, coordinator)
        if process_id and writes_pieces(num_processes):
            # this process's prefix holds the tables only: process 0's
            # holds the stitched bitmaps
            index.mesh_ranks = ranks
            return index
        index = Index(index.prefix)
        index.mesh_ranks = ranks
        return index

    if index.anchor_genomes:
        preload_embedding_modules()
    if device_dict:
        build_dict_device(index, dev, force=force)
    else:
        for name in index.genome_names:
            if index.genomes[name].fasta is not None:
                count_genome(index, name, dev, force=force)
        build_dict_stage(index, dev, force=force)
    pan_dict = PanKmerDict.load(index.dict_fname)

    todo = [n for n in index.anchor_genomes
            if force or not _outputs_fresh(
                anchor_outputs(index, n),
                [index.dict_fname, index.genomes[n]._fasta_path])]
    if todo:
        bucketed = layout_stage(index, pan_dict, dev)
        cores = max(int(index.conf.cores or 1), 1)
        if cores > 1 and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=cores) as ex:
                futures = [ex.submit(anchor_stage, index, n, bucketed, False)
                           for n in todo]
                for f in futures:
                    f.result()
        else:
            for name in todo:
                anchor_stage(index, name, bucketed)
        del bucketed

    dist_stage(index, pan_dict, dev, force=force)
    return Index(index.prefix)
