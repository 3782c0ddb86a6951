"""Multi-process index build coordinated through files (panagram_tpu's
parallel/distributed.py): ``index --num-processes P --process-id i`` without
``--mesh``.

Every process counts the genomes it owns (round-robin by genome id) and
anchors its share of the anchor genomes; process 0 merges the dictionary
once all counts have landed and writes the distances once all anchors have.
Processes wait for each other's done markers and outputs on the shared index
directory and use no collective, so several may share one card.  A rerun
skips what is complete, as the single-process build does.
"""

from __future__ import annotations

import logging
import os
import time

from ..config import config_path, samples_path
from ..index import Index

logger = logging.getLogger(__name__)

_POLL_S = 0.5


def _wait_for(paths, timeout=86400, poll=_POLL_S):
    t0 = time.time()
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not os.path.exists(p)]
        if not missing:
            return
        if time.time() - t0 > timeout:
            raise TimeoutError(f"timed out waiting for {missing[:3]} ...")
        time.sleep(poll)


def _done_marker(prefix, stage, pid):
    return os.path.join(prefix, "logs", f".done.{stage}.{pid}")


def _clear_done_markers(prefix, pid):
    """Remove this process's markers of an earlier run before any peer can
    see them; each process clears only its own."""
    for stage in ("count", "anchor"):
        try:
            os.remove(_done_marker(prefix, stage, pid))
        except FileNotFoundError:
            pass


def _mark_done(prefix, stage, pid):
    os.makedirs(os.path.join(prefix, "logs"), exist_ok=True)
    with open(_done_marker(prefix, stage, pid), "w") as f:
        f.write(str(time.time()))


def build_index_distributed(samples_or_dir, prefix=None, num_processes=1,
                            process_id=0, force=False, device="cuda",
                            **params):
    """Build as process `process_id` of `num_processes` over a shared
    filesystem.  Returns the Index in read mode on process 0, None on the
    others."""
    from ..ops.dictionary import PanKmerDict
    from ..pipeline import (
        _outputs_fresh,
        anchor_outputs,
        anchor_stage,
        build_dict_stage,
        count_genome,
        dist_stage,
        layout_stage,
        preload_embedding_modules,
        resolve_device,
    )

    dev = resolve_device(device)
    if process_id == 0:
        index = Index(samples_or_dir, mode="w", prefix=prefix, **params)
    else:
        # process 0 writes config.yaml and samples.tsv
        target = prefix or samples_or_dir
        _wait_for([config_path(target), samples_path(target)])
        index = Index(target, mode="w")
    _clear_done_markers(index.prefix, process_id)
    if index.anchor_genomes[process_id::num_processes]:
        preload_embedding_modules()

    mine = [n for i, n in enumerate(index.genome_names)
            if i % num_processes == process_id
            and index.genomes[n].fasta is not None]
    for name in mine:
        count_genome(index, name, dev, force=force)
        logger.info(f"[p{process_id}] counted {name}")
    _mark_done(index.prefix, "count", process_id)

    if process_id == 0:
        _wait_for([_done_marker(index.prefix, "count", p)
                   for p in range(num_processes)])
        _wait_for([index.kmer_set_fname(n) for n in index.genome_names
                   if index.genomes[n].fasta is not None])
        build_dict_stage(index, dev, force=force)
    else:
        _wait_for([index.dict_fname])

    todo = [a for i, a in enumerate(index.anchor_genomes)
            if i % num_processes == process_id
            and (force or not _outputs_fresh(
                anchor_outputs(index, a),
                [index.dict_fname, index.genomes[a]._fasta_path]))]
    if todo:
        bucketed = layout_stage(index, PanKmerDict.load(index.dict_fname),
                                dev)
        for name in todo:
            anchor_stage(index, name, bucketed)
            logger.info(f"[p{process_id}] anchored {name}")
        del bucketed
    _mark_done(index.prefix, "anchor", process_id)

    if process_id == 0:
        _wait_for([_done_marker(index.prefix, "anchor", p)
                   for p in range(num_processes)])
        dist_stage(index, None, dev, force=force)
        return Index(index.prefix)
    return None
