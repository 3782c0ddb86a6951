"""Index build: the stage DAG of panagram_tpu.pipeline on one device.

  count[g]   per-genome distinct canonical k-mer set  -> kmc/<g>.kmers.npz
  dict       merged presence-mask dictionary          -> kmc/pandict.npz
  layout     bucket table, built on the host, uploaded once for all anchors
  anchor[g]  per-anchor bitmaps + summaries           -> anchor/<g>/*
  dist       exact-Jaccard genome distances           -> genome_dist.tsv

A stage is skipped when its outputs exist and are no older than its inputs,
and each stage that runs writes its wall time to logs/<stage>.benchmark.txt
(the names of panagram_tpu's: kmc.<g>, dict, anchor.<g>, mash.triangle,
plus layout).  Every device step runs on the `device` given.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from .distances import write_genome_dist
from .index import Index
from .io.fasta import iter_fasta, seq_to_codes
from .ops.count import distinct_kmers_chunked
from .ops.dictionary import PanKmerDict, build_dictionary
from .ops.lookup import BucketedDict

logger = logging.getLogger(__name__)
_LOG_FORMAT = "[%(asctime)s %(levelname)s] %(message)s"
_LOG_DATEFMT = "%Y-%m-%d %H:%M:%S"

# what a later step of ROADMAP.md's port queue brings, by unsupported input
_LATER = {
    "gff": "GFF annotation (gene/anno tabix, run_annotate)",
    "fastq": "FASTQ read-set counting (counted_kmers_chunked)",
    "device_dict": "--device-dict (the device-resident dictionary)",
    "mesh": "--mesh (parallel/ on torch.distributed)",
    "cores": "--cores > 1 (threaded anchoring of several genomes)",
}


def not_in_slice(what: str):
    return NotImplementedError(
        f"{_LATER[what]} is not ported to panagram_tpu_torch yet; it is a "
        "later step of ROADMAP.md's port queue (panagram_tpu builds it)")


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


def count_genome(index: Index, name: str, device: torch.device,
                 force=False) -> str:
    """Stage count[g]: distinct canonical k-mers of one genome (FASTA)."""
    out = index.kmer_set_fname(name)
    fasta = index.genomes[name]._fasta_path
    if not force and index.conf.kmc.use_existing and os.path.exists(out):
        return out
    if not force and _outputs_fresh([out], [fasta]):
        return out
    t0 = time.time()
    os.makedirs(index.kmer_dir, exist_ok=True)
    codes = (seq_to_codes(seq) for _, seq in iter_fasta(fasta))
    kmers = distinct_kmers_chunked(codes, index.k, device)
    tmp = out + f".tmp.{os.getpid()}.npz"
    np.savez(tmp, kmers=kmers, k=index.k)
    os.replace(tmp, out)
    _benchmark(index.prefix, f"kmc.{name}", t0)
    logger.info(f"counted {name}: {len(kmers)} distinct {index.k}-mers")
    return out


def build_dict_stage(index: Index, device: torch.device, force=False) -> str:
    """Stage dict: merge the per-genome sets; genome id = samples.tsv row,
    and a genome without sequence contributes an empty set."""
    out = index.dict_fname
    set_files = [index.kmer_set_fname(n) for n in index.genome_names
                 if index.genomes[n].fasta is not None]
    if not force and _outputs_fresh([out], set_files):
        return out
    t0 = time.time()
    sets = []
    for name in index.genome_names:
        if index.genomes[name].fasta is None:
            sets.append(np.zeros(0, np.uint64))
            continue
        f = index.kmer_set_fname(name)
        z = np.load(f)
        if int(z["k"]) != index.k:
            raise ValueError(f"{f}: k={int(z['k'])} != index k={index.k}")
        sets.append(z["kmers"])
    d = build_dictionary(sets, index.k, ngenomes=index.ngenomes, device=device)
    d.save(out)
    _benchmark(index.prefix, "dict", t0)
    logger.info(f"dictionary: {len(d)} keys x {d.nwords} words")
    return out


def layout_stage(index: Index, pan_dict: PanKmerDict,
                 device: torch.device) -> BucketedDict:
    """Lay the dictionary out as the bucket table (numpy, on the host) and
    upload it once; every anchor genome probes the same device table."""
    t0 = time.time()
    bd = BucketedDict.build(pan_dict.keys, pan_dict.masks, index.ngenomes,
                            index.k, mixed=pan_dict.key_space == "mixed")
    bd = bd.to(device)
    _sync(device)
    _benchmark(index.prefix, "layout", t0)
    logger.info(f"bucket table: 2^{bd.nbits} buckets x {bd.stride} u32")
    return bd


def anchor_outputs(index: Index, name: str) -> list[str]:
    g = index.genomes[name]
    return [g.chrs_fname, g.bins_fname] + [g.bitmap_gz_fname(s)
                                           for s in index.steps]


def anchor_stage(index: Index, name: str, bucketed: BucketedDict):
    """Stage anchor[g], with its log in logs/anchor.<g>.log.txt."""
    t0 = time.time()
    log = os.path.join(index.prefix, "logs", f"anchor.{name}.log.txt")
    handler = logging.FileHandler(log, mode="w")
    handler.setFormatter(logging.Formatter(_LOG_FORMAT, _LOG_DATEFMT))
    pkg = logging.getLogger("panagram_tpu_torch")
    pkg.addHandler(handler)
    try:
        index.genomes[name].run_anchor(bucketed)
    finally:
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


def check_slice(index: Index):
    """Raise NotImplementedError for inputs this slice of the port does not
    build (see _LATER)."""
    for g in index.genomes.values():
        if g.gff is not None:
            raise not_in_slice("gff")
        if g.is_fastq:
            raise not_in_slice("fastq")
    if int(index.conf.cores or 1) > 1:
        raise not_in_slice("cores")


def build_index(samples_or_dir: str, prefix=None, force=False,
                device="cuda", device_dict=False, mesh_devices=None,
                **params) -> Index:
    """Run the build DAG on one device.  `samples_or_dir` is a samples.tsv
    (fresh build) or an initialized index dir (resume)."""
    if device_dict:
        raise not_in_slice("device_dict")
    if mesh_devices:
        raise not_in_slice("mesh")
    dev = resolve_device(device)
    # INFO to stderr unless the process configured logging already (what
    # panagram_tpu's init_logger does); anchor logs also go to logs/
    logging.basicConfig(level=logging.INFO, format=_LOG_FORMAT,
                        datefmt=_LOG_DATEFMT)
    index = Index(samples_or_dir, prefix=prefix, **params)
    check_slice(index)
    os.makedirs(os.path.join(index.prefix, "logs"), exist_ok=True)

    for name in index.genome_names:
        if index.genomes[name].fasta is not None:
            count_genome(index, name, dev, force=force)
    build_dict_stage(index, dev, force=force)
    pan_dict = PanKmerDict.load(index.dict_fname)

    bucketed = None
    for name in index.anchor_genomes:
        g = index.genomes[name]
        if not force and _outputs_fresh(anchor_outputs(index, name),
                                        [index.dict_fname, g._fasta_path]):
            continue
        if bucketed is None:
            bucketed = layout_stage(index, pan_dict, dev)
        anchor_stage(index, name, bucketed)
    del bucketed

    dist_stage(index, pan_dict, dev, force=force)
    return index
