#!/usr/bin/env python3
"""Smoke run of panagram_tpu_torch on one CUDA card: python3 chip_smoke.py

1. Names the card (nvidia-smi name and power limit) and the torch build.
2. Builds the CUDA kernels from panagram_tpu_torch/csrc with nvcc (one
   process per source, in parallel).
3. Kernel phase: at the anchor path's shapes (a 2^22-position chunk, k=31;
   W=1 with 30 genomes, W=2 with 40, W=3 with 70 and W=4 with 100:
   KERNEL_GENOMES) each anchor kernel's output is
   compared bit for bit with its plain torch version on the card; so is
   mosaic_probe at n = 1024 and 2^24.  Each kernel is timed on the card's
   own clock (panagram_tpu_torch/tools/kernel_times.py): warm, 50 launches
   back to back behind a blocker, and cold, the L2 flushed before each
   launch (the reading of an empty event pair is printed beside it and not
   subtracted); the reading of one call between two events, which holds
   the host's enqueue, is printed beside them.  Its bound is
   kernels.bound_bytes over MEM_RATE (for probe_sorted with the table
   bytes its queries need, kernels.probe_need_bytes, counted on the card;
   the earlier count, every touched row read whole, is printed beside it
   with its share, labelled whole rows): the kernels do integer
   work only, for which the data sheet names no peak, and none needs more
   time for it than for its bytes.  The share of the bound is bound / cold
   time.  masks_to_bytes is timed beside the one torch call that computes
   it (library_masks_to_bytes).  Then one whole ops.anchor.anchor_chunk_fast on
   the same inputs: it must make no host synchronisation (torch's sync
   debug mode set to "error" around it), and its warm and cold times are
   printed beside the sums of its four kernels as a line of its own,
   {"chunk": {...}}; the difference is the library operations between the
   kernels.
4. The mosaic probe tool: ``panagram_tpu_torch.tools.mosaic_probe.main()``
   in process must print four True lines and launch its kernel.
4a. The bench phase: ``bench_torch.main([])`` in process, bench.py's
   configuration (30 genomes of 2^21 bp, k=21, a 2^25-bp anchor streamed
   in 2^22-position chunks).  It must have passed its oracle check and its
   host-anchorer check (it raises otherwise), printed bench.py's dictionary
   and table (BENCH_KEYS keys x 1 word, a BENCH_TABLE table), launched
   each anchor kernel BENCH_LAUNCHES times (counts from 0 around it) and
   no other kernel, and every rate of its line, its best pass's host
   packing and its copy-back must be above 0.  Prints its line, the best
   pass's pack / copy split and its wall.
4b. The bigdict phase, the JAX repo's 1e8-key run (tools/bigdict_run.py)
   through the port's tool, panagram_tpu_torch/tools/bigdict_run.run, with
   the tool's own arguments (BIGDICT_RUNS): W=1, 4 random genomes of 26 Mbp
   (an 8-GiB table), and W=4, 100 of 1.04 Mbp (16 GiB), each through the
   device dictionary builder, the layout from its arrays and a 32-Mbp
   anchor (genome 0 tiled) streamed once to warm up and 3 times timed.
   With the kernel counts from 0 around a run, each anchor kernel must
   launch once per anchor chunk of the 4 passes (pack_mix also once per
   builder chunk) and no other kernel; D must equal the host's exact
   distinct count of the genomes' canonical k-mers (np.sort and a diff);
   the stream's bytes and popcounts at ORACLE_POSITIONS random positions
   and at every window across a tile junction, and the bytes, popcounts
   and column sums of the chunk that holds the first junction, must equal
   the truth of the genomes' own sorted k-mer sets (ref_impl.truth_rows,
   which never reads the dictionary); the table must have been laid out
   on a device route ("single" or "chunked"; the tool raises rather than
   lay it out on the host); that chunk through anchor_chunk_fast must
   equal it through the kernels' plain versions (plain_kernels), which
   must launch no kernel; real_probe reads probe_sorted on it at 2^25 rows,
   printed beside the kernel phase's reading at a 1.3e7-key table; the
   builder's peak must stay within what its budget check counts
   (devdict.merge_bytes) and the layout's transients within
   lookup.layout_bytes; the best pass's copy-back share must be above 0.
   Prints D, the count+merge and layout walls, the route, the geometry,
   the peaks of the builder and the layout, each pass's k-mers/s with its
   packing and copy-back, and the best pass beside the bench phase's
   value.
5. The slice: 30 founder-structured genomes of 5 Mbp (seed 0) are written
   as FASTA and indexed through the CLI entry point,
   ``main(["index", ..., "-k", "31", "--anchor-genomes", "g0", "g1", "g2"])``,
   with the bucket table laid out on the card.  Every anchor kernel's
   launch counter must have risen during that run, every output file must
   exist and be consistent, and the first 2^17 positions of g0's bitmap
   must equal the numpy oracle against the saved dictionary.  The count
   stage's peak device memory is printed; the dict stage's must stay under
   DICT_PEAK_PER_PAIR bytes per (key, genome) pair.  Anchored k-mers/s is
   printed over the whole anchor stages and over them less their finish
   phase (the embeddings).  It prints which BGZF compressor ran ("bgzf
   compressor: native", or "zlib (<why>)"), the count stage's phases
   (FASTA parsing, device, npz write) summed over the genomes, the dict
   stage's (npz read, device, npz write), each anchor's (encode, pack,
   wait, copy, write, bins, finish) and the copy-back's share of the
   anchor stages, which must be above 0.
6. The device-dict slice: the same genomes through ``--device-dict``.  Its
   pandict.npz must be the slice's dictionary mixed (keys in unsigned mixed
   order), its anchor files byte-identical to the slice's, and pack_mix
   must have run once per sequence chunk in its dict stage.
6a. The scale100 phase, the repo's 100-genome scale row (tools/
   scale_run.py --genomes 100 --mbp 2 --k 21 --anchors 2): 100 founder-
   structured genomes of 2 Mbp (make_genomes, seed 0), W=4 and 13 bitmap
   bytes per position, k=21, anchors g0 and g1 (one 2^21-position chunk
   each), through the CLI on the default route and with --device-dict.
   Every anchor kernel must launch, and --device-dict's dict stage must
   launch pack_mix once per sequence chunk; each anchor's whole chunk
   through anchor_chunk_fast must equal the same chunk through the
   kernels' plain versions on the card (plain_kernels) and bitmap.1.gz,
   its first 2^17 positions the numpy oracle (real_probe also holds
   probe_sorted on g0's chunk to its plain version and prints its hit
   share, bytes needed and cold time); the --device-dict dictionary
   must be the default one mixed and the anchor files byte-identical; the
   default dict stage must peak under DICT_PEAK_PER_PAIR bytes per pair;
   the copy-back share must be above 0 on both routes; and the read API
   must return 100 columns equal to the oracle on a window.  Prints the
   stage walls, anchor phases, peaks and launches.
6b. The w4_steady phase: the JAX repo's tools/w4_steady.py through the
   port's tool on scale100's default-route index (W=4) with its defaults
   and --chunk 21 (W4_MBP, W4_REPS, W4_CHUNK): each anchor kernel must
   launch once per chunk of the reps + 1 sequences (counts from 0 around
   the run); rep 1 streamed again through the kernels must give the run's
   k-mers, hits and column sums, and through the kernels' plain versions
   (no launch) the same bytes, k-mers, hits and column sums.  Prints each rep's wall,
   rate, packing, copy-back and hit share (the sequences are random, so
   nearly every query misses), and the best steady rate.
7. The full-index phase: the same genomes plus a FASTQ read set `reads`
   (150-bp reads at 10x of g3, 0.5% substitutions, seed 0) and GFF3 files
   for g0-g2 (a gene every ~5 kbp with one mRNA and four exons, a
   repeat_region every 50 kbp), indexed through the CLI with --cores 3 and
   again with --cores 1.  The two trees must be identical (anno_types.txt
   as a set, config.yaml apart), `reads` counted on the card must equal
   the plain CPU count, g0's gene histograms in its first 2^17 positions
   must equal the numpy oracle's, every gene's must equal the bitmap's,
   both UMAP CSVs must hold one finite row per 100-kbp bin, and
   ``annotate g1 <gff>`` through the CLI must count its genes from the
   bitmap with the fused_popcount_colsums kernel.  Prints the FASTQ count
   wall and reads/s, the anchor stage's wall at --cores 3 and 1, the
   annotate wall and the embedding walls.
8. The read phase: the slice's index and the annotated tree opened with
   ``Index(prefix)`` in read mode.  query_bitmap of g0 over random
   windows, windows across BGZF block edges and the chromosome's last row
   must equal the decompressed bitmap.1.gz, steps 100 and 200 step 1
   sliced, ``bitdump -v`` through the CLI the numpy oracle; query_genes
   must return every gene with the bitmap's popcounts, query_anno every
   annotation type of the GFFs; genome_sizes must equal chrs.tsv and each
   bitfreq_totals row sum to 1.  Prints the host's times for opening an
   index, a 1-Mbp query, a whole chromosome at step 100 and a whole
   chromosome's gene fetch.
9. The mesh phase: the slice's genomes through ``--mesh 1`` (one spawned
   rank on NCCL) under ``--mesh-strategy range`` and ``genomes``, and
   through the two-process ``--num-processes 2`` build on the one card.
   Each tree must equal the slice's file for file (one writer per file, so
   byte for byte; the range build's pandict.npz must be the slice's
   dictionary mixed), the mesh builds go through ``build_index`` (the
   CLI's call), whose rank must launch each kernel of its path
   (MESH_KERNELS) once per chunk and the others never (the rank's own
   counts, sent back by parallel.mesh.launch), each anchor's phases line
   must name only the phases the mesh route times (MESH_PHASES, its host
   staging above 0), and ``--mesh 2`` must
   raise naming the card count.  Prints each build's wall, its dict and
   anchor stage walls, and the rank's peak device memory beside the
   one-device build's.
9a. The bigdict_mesh phase: the JAX repo's sharded 1e8-key build
   (tools/bigdict_mesh.py) through the port's tool,
   ``panagram_tpu_torch.tools.bigdict_mesh.run``, which raises unless the
   writer's host dictionary equals the host merge oracle (the mixed-sorted
   distinct union with OR'd presence bits) and the anchored bytes,
   popcounts and column sums the numpy oracle's.  (a) The JAX tool's full
   size, 4 random genomes of 26 Mbp (seed 11), k=21, a 2-Mbp anchor of
   genome 0, on one NCCL rank that holds the whole range-sharded
   dictionary (2^25 x 64 u32 = 8 GiB): D must be the host's exact count
   and 103,997,462, the rank must launch each kernel of the range path
   once per anchor chunk (8 chunks of 2^18) and probe_sorted never, and
   its peak device memory must stay within what the build's budget checks
   counted (routing, merge and layout).  (b) The mid-size leg, 4 x 0.26
   Mbp (~1.04e6 keys) on 8 Gloo ranks on the host's CPU: the same parity,
   no launch.  (c) More ranks than cards on cuda must raise naming the
   card count.  Prints each part's walls, the geometry, the peak beside
   the checks' figure and the phase's wall.
10. The api phase, on the slice's index: every name the package, ops, io
   and parallel export resolves and ``panagram_tpu_torch.Index(prefix)``
   opens the tree.  ops.anchor_lookup of g0's first 2^22 canonical
   k-mers against pandict.npz, then mask_popcount, genome_column_sums,
   masks_to_bytes of the whole rows and occupancy_histogram, with the
   kernel counts set to 0 just before and read just after: each op of a
   kernel must launch it once (fused_popcount_colsums twice,
   masks_to_bytes once, no other).  The rows must equal those of one
   ops.anchor.anchor_chunk_fast of the same bases (bytes, popcounts, column
   sums; its table laid out by BucketedDict.build_device called
   positionally in panagram_tpu's order, on the card by default) and the
   numpy oracle's over the first 2^17 positions; each op its plain
   version; the histogram the CPU's.  anchor_lookup's and
   anchor_chunk_fast's warm times per chunk are printed, and real_probe
   holds probe_sorted on g0's first chunk against the slice's table (W=1)
   to its plain version and prints its hit share, bytes needed and cold
   time.  Then calls
   written for panagram_tpu: lookup.bucket_query_sorted on the chunk's
   canonical k-mers must launch probe_sorted once (counts from 0 around
   it) and give bucket_query's, anchor_lookup's and the oracle's rows;
   anchor_chunk_fast must give the stream's bitmap.1.gz rows and make no
   host synchronisation; anchor_chunk(codes, keys, masks, k) the oracle's
   rows with one fused_popcount_colsums launch; counted_kmers_chunked(
   codes, k, 3), distinct_kmers_chunked(codes, k, chunk),
   pairwise_shared(block) and DeviceDictBuilder(k, ngenomes, chunk,
   capacity_hint), called positionally, must run on the card (min-count
   3 where 3 is given) and equal the CPU's.  bucket_query_sorted's warm
   time per 2^22 queries is printed beside anchor_chunk_fast's, each call's
   wall beside them.  The host anchorer
   (native/anchor_cpu, built with g++ from the checkout) over
   pandict.npz's canonical keys anchors g0 whole at API_THREADS threads
   and at os.cpu_count(); its bytes and popcounts must equal bitmap.1.gz.
   Prints its build seconds, anchor seconds and k-mers/s.  The six
   scripts of panagram_tpu_torch/scripts run in process on the index,
   each output checked (pairwise_matrix on the card against
   pairwise_shared on the CPU; write_umaps must rewrite g0's CSVs
   byte for byte; plot_umaps renders where matplotlib imports and
   otherwise must raise naming it), and make_bins_bits again through
   ``python -m``; their walls are printed.  Last, the shell wrappers:
   panagram_tpu_torch/scripts/preprocess.sh on the full-index phase's
   samples (the card by default) must reproduce every file of that
   phase's --cores 1 CLI tree but config.yaml and samples.tsv's anchor
   column (the wrapper, as panagram_tpu's, anchors every assembly; the
   CLI run named three), and run_umaps.sh on the slice's index must write
   g0's CSVs as the build did, then stop at plot_umaps naming matplotlib
   where it is missing; their walls are printed.
11. Layout phase: ~1e8 mixed keys drawn on the card (W=1) laid out by
   BucketedDict.build_device, the single-pass route, the chunked route and
   the single-pass route of the keys shuffled; the tables must be equal and
   a sample of keys must find their masks.  Each of these routes and the
   range-sharded layout (low-bit buckets, "bucket" mode) must hold its
   transients within lookup.layout_bytes and above MODEL_FLOOR of it.
12. Prints one line per kernel (bytes, bound, share, launches
   of the slice, library call), the kernel phase's W=2-4 readings, the
   kernels JSON line (the W=1 readings), the card line, and
   last {"ok": true, "device": {...}}.  Any failed check raises, so the script
   exits non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from bench_torch import card_line
from panagram_tpu_torch.tools.kernel_times import (
    CHUNK,
    K,
    MEM_RATE,
    Flush,
    chunk_inputs,
    chunk_times,
    cold_ms,
    host_syncs,
    kernel_cases,
    one_call_ms,
    probe_case,
    probe_line,
    warm_ms,
)
from panagram_tpu_torch.tools.scale_run import founder_genomes, write_fasta

GENOMES, GENOME_BP, ANCHORS = 30, 5_000_000, ("g0", "g1", "g2")
ORACLE_POSITIONS = 1 << 17
READ_LEN, READ_COVERAGE, READ_SUBST = 150, 10, 0.005
GENE_EVERY, REPEAT_EVERY = 5_000, 50_000
UMAP_BIN = 100_000
READ_WINDOWS, READ_MBP = 24, 1_000_000   # read phase: random windows, query
LAYOUT_KEYS = 100_000_000  # layout phase: a ~1e8-key W=1 table
# the share of its lookup.layout_bytes model a layout's measured transients
# must reach: the model may over-count by at most a fifth
MODEL_FLOOR = 0.8
MOSAIC_SIZES = (1024, 1 << 24)
# kernel phase: genomes per chunk case, W = 1, 2, 3 and 4 mask words
KERNEL_GENOMES = (30, 40, 70, 100)
# bytes of device memory per (key, genome) pair the one-device dict stage
# may peak at: the merge's sort holds about 52 (ops/dictionary._merge_sets)
DICT_PEAK_PER_PAIR = 64
# bench phase: bench_torch's dictionary and table at bench.py's full size
# (bench.py's own output), and each anchor kernel's launches in one run:
# 8 chunks of warm-up, 1 of the oracle check, 3 x 8 timed, 4 compute-only;
# pack_bases runs in the 33 streamed chunks only
BENCH_KEYS, BENCH_TABLE, BENCH_LAUNCHES = 4_291_328, (1_048_576, 64), 37
BENCH_STREAMED = 33
# the repo's 100-genome scale row (tools/scale_run.py, BASELINE.md): W=4
SCALE_GENOMES, SCALE_BP, SCALE_K, SCALE_ANCHORS = 100, 2_000_000, 21, ("g0", "g1")
# tools/bigdict_run.py's two runs (label, --genomes, --mbp), each with its
# --anchor-mbp 32 and --k 21 and main's floor of 1e8 keys: the defaults
# (W=1), and 100 genomes of 1.04 Mbp (W=4)
BIGDICT_RUNS = (("W=1", 4, 26.0), ("W=4", 100, 1.04))
BIGDICT_ANCHOR_MBP, BIGDICT_K, BIGDICT_MIN_KEYS = 32.0, 21, 100_000_000
# the W=1 run's distinct keys from the JAX tool's generator (BASELINE.md)
BIGDICT_W1_KEYS = 103_997_432
# tools/w4_steady.py's defaults: --mbp 8 --reps 3, and --chunk 21 as the
# 100-genome row anchors
W4_MBP, W4_REPS, W4_CHUNK = 8.0, 3, 21

KERNELS = [  # (wrapper, CUDA source, TPU kernel it replaces)
    ("pack_bases", "panagram_tpu_torch/csrc/pack_bases.cu",
     "none: panagram_tpu packs on the host (ops/codec.py pack_bases_np)"),
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
# the four kernels of one anchor chunk (ops.anchor.anchor_chunk_fast), and
# with pack_bases those of each chunk of the stream (stream_anchor_chunks)
ANCHOR_KERNELS = ["pack_mix", "probe_sorted", "fused_popcount_colsums",
                  "masks_to_bytes"]
STREAM_KERNELS = ["pack_bases", *ANCHOR_KERNELS]


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


def kernel_phase(dev, ngenomes: int, rng, flush) -> dict:
    """Each kernel against its plain version on a main-path-sized chunk,
    then one whole anchor_chunk_fast on the same inputs, which must make no host
    synchronisation.  Returns {name: compare()'s dict}."""
    inp = chunk_inputs(dev, ngenomes, rng)
    bd = inp.bd
    print(f"  N={ngenomes} W={inp.W}: table 2^{bd.nbits} x {bd.stride} u32 "
          f"({bd.table.numel() * 4 / 2**30:.2f} GiB), {inp.nkeys} keys",
          flush=True)
    kc = kernel_cases(inp)
    print(f"  probe: window of {kc.plan.span} rows (the whole table), "
          f"{kc.hit_frac:.3f} of positions hit; {probe_line(kc.probe, bd)}",
          flush=True)
    library = {"masks_to_bytes":
               lambda: library_masks_to_bytes(kc.rows, inp.nbytes)}
    whole = {"probe_sorted": kc.probe.whole_rows}
    out = {name: compare(name, f"N={ngenomes}", kern, plain, kc.shapes[name],
                         flush, library.get(name), whole.get(name))
           for name, (kern, plain) in kc.cases.items()}
    chunk = chunk_times(inp, flush, {
        n: {"warm_ms": r["warm_ms"], "cold_ms": r["cold_ms"]}
        for n, r in out.items()})
    if chunk["host_syncs"]:
        raise AssertionError("anchor_chunk_fast made the host wait for the card "
                             "(torch's sync debug mode raised)")
    print(f"  anchor_chunk_fast, whole  no host synchronisation; warm "
          f"{chunk['warm_ms']:.5f} ms, cold {chunk['cold_ms']:.5f} ms; its "
          f"four kernels {chunk['kernels_warm_ms']:.5f} / "
          f"{chunk['kernels_cold_ms']:.5f} ms; the library operations "
          f"between them {chunk['around_kernels_warm_ms']:.5f} / "
          f"{chunk['around_kernels_cold_ms']:.5f} ms; host time per call "
          f"{chunk['host_ms']:.5f} ms", flush=True)
    print(json.dumps({"chunk": chunk}), flush=True)
    torch.cuda.empty_cache()
    return out


def library_masks_to_bytes(rows, nbytes: int):
    """The one torch call that computes masks_to_bytes: the words' bytes,
    cut, copied into a new tensor (.contiguous() would copy nothing when
    nothing is cut).  A yardstick for the kernel's time; nothing in the
    package calls it."""
    return (rows.view(torch.uint8)[:, :nbytes]
            .clone(memory_format=torch.contiguous_format),)


def compare(name: str, what: str, kern, plain, shape: dict, flush,
            library=None, whole_rows=None) -> dict:
    """Kernel against plain version on the card (raises unless bit-exact),
    its times, and its bound at `shape`; for probe_sorted also the bound
    with every touched row read whole (`whole_rows`, bound_bytes'
    arguments of the earlier count) and its share."""
    from panagram_tpu_torch.ops import kernels

    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name} ({what}): kernel differs from its "
                             f"plain version, max |err| {err}")
    nbytes = kernels.bound_bytes(name, **shape)
    cold, empty = cold_ms(kern, flush)
    res = {"err": err, "warm_ms": warm_ms(kern), "cold_ms": cold,
           "empty_pair_ms": empty, "old_timer_ms": one_call_ms(kern),
           # one call per reading: a plain version of many small kernels
           # (fused_popcount_colsums_plain: a few per genome) overflows
           # the launch queue behind the blocker when several are queued
           "plain_ms": warm_ms(plain, launches=1, runs=3),
           "bytes": nbytes, "bound_ms": nbytes / MEM_RATE * 1e3,
           "library_ms": None, "library_warm_ms": None}
    res["share"] = res["bound_ms"] / cold
    print(f"  {name:24s} bit-exact  warm {res['warm_ms']:.5f} ms  cold "
          f"{cold:.5f} ms (empty pair {empty:.5f}, not subtracted)  one call "
          f"between events {res['old_timer_ms']:.5f} ms  plain "
          f"{res['plain_ms']:.4f} ms", flush=True)
    print(f"  {'':24s} {nbytes} B: bound {res['bound_ms']:.5f} ms by bytes, "
          f"share of bound {res['share']:.3f} (less the empty pair "
          f"{res['bound_ms'] / (cold - empty):.3f})", flush=True)
    if whole_rows is not None:
        wb = kernels.bound_bytes(name, **whole_rows)
        res["whole_row_bytes"] = wb
        res["whole_row_bound_ms"] = wb / MEM_RATE * 1e3
        res["whole_row_share"] = res["whole_row_bound_ms"] / cold
        print(f"  {'':24s} whole rows (the earlier count) {wb} B: bound "
              f"{res['whole_row_bound_ms']:.5f} ms, share "
              f"{res['whole_row_share']:.3f}", flush=True)
    if library is not None:
        if max_abs_err(library(), want) != 0:
            raise AssertionError(f"{name} ({what}): the library call differs")
        res["library_ms"], _ = cold_ms(library, flush)
        res["library_warm_ms"] = warm_ms(library)
        print(f"  {'':24s} library call: warm {res['library_warm_ms']:.5f} ms"
              f"  cold {res['library_ms']:.5f} ms", flush=True)
    return res


def real_probe(what: str, p, n, L: int, k: int, Ppad: int, bd,
               card: str) -> dict:
    """probe_sorted on a real chunk, as the anchor stream feeds it: pack_mix
    of the bases (p, n) against the table bd that the calling phase built.
    Raises unless bit-exact against the plain version; prints the hit
    share, the bytes the queries need and the cold time against both
    bounds.  Its launches fall outside every counted window."""
    from panagram_tpu_torch.ops import kernels

    hi, lo = kernels.pack_mix(p, n, L, k, Ppad)
    pc = probe_case(hi, lo, bd)
    err = max_abs_err((pc.rows,), (kernels.probe_sorted_plain(*pc.args),))
    if err != 0:
        raise AssertionError(f"probe_sorted on {what}: kernel differs from "
                             f"its plain version, max |err| {err}")
    cold, empty = cold_ms(lambda: kernels.probe_sorted(*pc.args), Flush(p.device))
    res = {"cold_ms": cold, "hit_share": pc.hit_share,
           "table_bytes": pc.shape["table_bytes"]}
    for key, shape in (("bound_ms", pc.shape), ("whole_row_bound_ms",
                                                pc.whole_rows)):
        res[key] = kernels.bound_bytes("probe_sorted", **shape) / MEM_RATE * 1e3
    print(f"  probe_sorted on {what} [{card}]: bit-exact; {probe_line(pc, bd)}"
          f"; cold {cold:.5f} ms (empty pair {empty:.5f}), share of bound "
          f"{res['bound_ms'] / cold:.3f}, of the whole-row bound "
          f"{res['whole_row_bound_ms'] / cold:.3f}", flush=True)
    torch.cuda.empty_cache()
    return res


def mosaic_phase(dev, flush) -> tuple[dict, int]:
    """mosaic_probe against its plain version at MOSAIC_SIZES, then the
    probe tool in process.  Returns ({n: compare()'s dict}, the tool
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
                         lambda: (kernels.mosaic_probe_plain(ta, tb),),
                         dict(n=n), flush)
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


class _Tee(io.StringIO):
    """Keeps what is written to it and passes it on to `out`."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s):
        self.out.write(s)
        return super().write(s)

    def flush(self):
        self.out.flush()


def bench_phase(card: str) -> dict:
    """bench_torch.main([]) in process, held to bench.py's problem and to
    BENCH_LAUNCHES launches of each anchor kernel and BENCH_STREAMED of
    pack_bases; returns its line."""
    import bench_torch

    print(f"bench phase [{card}]: bench_torch.main([]), bench.py's "
          "configuration", flush=True)
    err, out = _Tee(sys.stderr), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        line, counts, wall = _launched(lambda: bench_torch.main([]))
    text = err.getvalue()
    print(f"  bench_torch line: {out.getvalue().strip()}", flush=True)
    m = re.search(r"dict (\d+) keys x (\d+) words", text)
    if not m or (int(m[1]), int(m[2])) != (BENCH_KEYS, 1):
        raise AssertionError(f"bench phase: dictionary {m and m[0]}, want "
                             f"{BENCH_KEYS} keys x 1 words")
    m = re.search(r"bucketed \((\d+), (\d+)\) stride (\d+)", text)
    if not m or (int(m[1]), int(m[2]), int(m[3])) != (*BENCH_TABLE,
                                                      BENCH_TABLE[1]):
        raise AssertionError(f"bench phase: table {m and m[0]}, want "
                             f"{BENCH_TABLE}")
    for want in ("device parity vs oracle OK",
                 "cpu baseline bytes equal the stream's"):
        if want not in text:
            raise AssertionError(f"bench phase: no '{want}' line")
    want = {n: BENCH_LAUNCHES for n in ANCHOR_KERNELS}
    want["pack_bases"] = BENCH_STREAMED
    if counts != want:
        raise AssertionError(f"bench phase: launches {counts}, want {want}")
    m = re.search(r"best rep wall ([0-9.]+) s: pack ([0-9.]+) s, copy "
                  r"([0-9.]+) s", text)
    rates = (line["value"], line["vs_baseline"],
             line["device_compute_kmers_per_s"])
    if not m or min(rates) <= 0 or float(m[2]) <= 0 or float(m[3]) <= 0:
        raise AssertionError(f"bench phase: a rate, the packing or the "
                             f"copy-back at 0: {line}, {m and m[0]}")
    print(f"  best pass of the stream: wall {m[1]} s, host staging {m[2]} s, "
          f"copy-back {m[3]} s (card time); launches {counts}; phase wall "
          f"{wall:.1f} s", flush=True)
    return line


def make_genomes(work: str, ngenomes: int | None = None,
                 bp: int | None = None, keep=None) -> dict:
    """The founder-structured scale row (seed 0): 4 founders at 1%
    divergence from one random base, each of `ngenomes` (GENOMES) genomes
    of `bp` (GENOME_BP) bases a founder with 0.1% private variation,
    written to work/fa with work/samples.tsv.  Returns the codes of the
    genomes named in `keep` (the anchors and g3)."""
    ngenomes = GENOMES if ngenomes is None else ngenomes
    bp = GENOME_BP if bp is None else bp
    keep = ANCHORS + ("g3",) if keep is None else keep
    os.makedirs(os.path.join(work, "fa"))
    seqs = {}
    for g, mut in enumerate(founder_genomes(ngenomes, bp,
                                            np.random.default_rng(0))):
        write_fasta(os.path.join(work, "fa", f"g{g}.fa"), "chr1", mut)
        if f"g{g}" in keep:
            seqs[f"g{g}"] = mut
    with open(os.path.join(work, "samples.tsv"), "w") as f:
        f.write("name\tfasta\n")
        for g in range(ngenomes):
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


def stage_peaks(real, peaks: list):
    """Wrap a stage function of pipeline so that each call appends the peak
    device memory it allocated above what was allocated before it."""

    def counted(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    return counted


def slice_phase(work: str, card: str) -> tuple[dict, dict, int]:
    """Drive the index build through the CLI and check what it wrote.
    Returns the launch counts of the run, the generated sequences and the
    build's peak device memory after its count stage."""
    from panagram_tpu_torch import pipeline
    from panagram_tpu_torch.__main__ import main
    from panagram_tpu_torch.io.bgzf import BgzfReader, decompress_file
    from panagram_tpu_torch.native import bgzf_native
    from panagram_tpu_torch.ops import kernels
    from panagram_tpu_torch.ops.dictionary import PanKmerDict, npz_member
    from panagram_tpu_torch.ops.ref_impl import anchor_np, masks_to_bytes_np

    print(f"bgzf compressor: {bgzf_native.status()}", flush=True)
    t0 = time.perf_counter()
    seqs = make_genomes(work)
    print(f"generated {GENOMES} x {GENOME_BP / 1e6:g} Mbp genomes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prefix = os.path.join(work, "idx")
    peaks: list = []
    dict_peaks: list = []
    real = pipeline.count_genome, pipeline.build_dict_stage
    pipeline.count_genome = stage_peaks(real[0], peaks)
    pipeline.build_dict_stage = stage_peaks(real[1], dict_peaks)
    lines = _Lines()
    pkg = logging.getLogger("panagram_tpu_torch")
    pkg.addHandler(lines)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        main(["index", os.path.join(work, "samples.tsv"), "-k", str(K),
              "--prefix", prefix, "--anchor-genomes", *ANCHORS])
        torch.cuda.synchronize()
    finally:
        pipeline.count_genome, pipeline.build_dict_stage = real
        pkg.removeHandler(lines)
    wall = time.perf_counter() - t0
    # stage_peaks resets the peak before the dict stage: this is the peak
    # of that stage and of every stage after it
    build_peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.launches)
    print(f"index build: {wall:.2f} s wall, launches {launches}", flush=True)
    for name in STREAM_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the build")
    print(f"count stage peak device memory [{card}]: "
          f"{max(peaks) / 2**20:.1f} MiB (largest of {len(peaks)} genomes, "
          f"2^22-position chunks)", flush=True)
    pairs = sum(len(npz_member(os.path.join(prefix, "kmc", f"g{g}.kmers.npz"),
                               "kmers", mmap=True)) for g in range(GENOMES))
    (dict_peak,) = dict_peaks
    print(f"dict stage peak device memory [{card}]: "
          f"{dict_peak / 2**30:.3f} GiB for {pairs} (key, genome) pairs, "
          f"{dict_peak / pairs:.1f} B per pair", flush=True)
    if dict_peak > DICT_PEAK_PER_PAIR * pairs:
        raise AssertionError(f"the dict stage peaked at {dict_peak / pairs:.1f}"
                             f" B per pair, over {DICT_PEAK_PER_PAIR}")

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
    counted = [phase_values(m) for m in lines.lines
               if m.startswith("count phases")]
    print("  count phases, the 30 genomes' sums: " + " ".join(
        f"{k}={sum(c[k] for c in counted):.3f}s" for k in counted[0]),
        flush=True)
    for s in ["dict", "layout"] + [f"anchor.{a}" for a in ANCHORS] + ["mash.triangle"]:
        print(f"  {s:18s}  {walls[s]:9.3f} s", flush=True)
    print("  " + next(m for m in lines.lines if m.startswith("dict phases")),
          flush=True)
    phases = anchor_phases(prefix, ANCHORS)
    finish_s = sum(ph["finish"] for ph in phases.values())
    copy_share(phases, anchor_s, card)
    print(f"anchored k-mers/s [{card}]: {len(ANCHORS) * nk / anchor_s:.4g} "
          f"over the whole anchor stages ({len(ANCHORS)} x {nk} positions in "
          f"{anchor_s:.3f} s), {len(ANCHORS) * nk / (anchor_s - finish_s):.4g} "
          f"over the anchor stages less their finish phase (the embeddings, "
          f"{finish_s:.3f} s); peak device memory after the count stage "
          f"{build_peak / 2**30:.3f} GiB", flush=True)
    return launches, seqs, build_peak


def phase_values(line: str) -> dict:
    """{name: seconds} of a logged phases line ("... a=0.1s b=0.2s")."""
    return {k: float(v.rstrip("s")) for k, v in
            (w.split("=") for w in line.split() if "=" in w)}


def anchor_phases(prefix: str, anchors) -> dict:
    """{anchor: {phase: seconds}} of the last "anchor phases" line of each
    anchor's log in a tree; prints each line."""
    out = {}
    for a in anchors:
        with open(os.path.join(prefix, "logs", f"anchor.{a}.log.txt")) as f:
            line = [ln for ln in f if "anchor phases:" in ln][-1]
        print(f"  {a} {line.split('] ', 1)[1].strip()}", flush=True)
        out[a] = phase_values(line.split("anchor phases:")[1])
    return out


def copy_share(phases: dict, anchor_s: float, card: str) -> float:
    """The copy-back's card time summed over one-device anchor stages
    (anchor_phases' dict) over their wall `anchor_s`.  Prints it and raises
    unless it is above 0: the strike of the run-length transfers rests on
    this share, and a timer that stops adding reads 0."""
    copy_s = sum(ph.get("copy", 0.0) for ph in phases.values())
    share = copy_s / anchor_s
    print(f"copy-back of the anchor chunks' results [{card}]: {copy_s:.6f} s "
          f"of the card's time in {anchor_s:.3f} s of anchor stages (share "
          f"{share:.6f})", flush=True)
    if not share > 0:
        raise AssertionError("the anchor stages logged no copy-back time "
                             f"({sorted(next(iter(phases.values())))})")
    return share


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
    for name in STREAM_KERNELS:
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


@contextlib.contextmanager
def plain_kernels():
    """The stream's five kernels' wrappers swapped for their plain torch
    versions (ops/kernels.py's *_plain) while it is open: the route around
    them runs as it stands, on the same device, and launches no kernel."""
    from panagram_tpu_torch.ops import kernels

    saved = {n: getattr(kernels, n) for n in STREAM_KERNELS}
    try:
        for n in STREAM_KERNELS:
            setattr(kernels, n, getattr(kernels, n + "_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def scale100_phase(work: str, card: str, dev) -> dict:
    """The repo's 100-genome scale row (tools/scale_run.py --genomes 100
    --mbp 2 --k 21 --anchors 2; BASELINE.md): SCALE_GENOMES founder-
    structured genomes of SCALE_BP (make_genomes, seed 0), W=4 mask words
    and 13 bitmap bytes per position, indexed through the CLI with k=21 and
    anchors g0 and g1 (one 2^21-position chunk each) on the default route
    and with --device-dict.  Every anchor kernel must launch; each
    --device-dict dict-stage pack_mix launch is one sequence chunk; each
    anchor's first ORACLE_POSITIONS positions must equal the numpy oracle
    and its whole chunk through anchor_chunk_fast on the card's kernels
    must equal the same chunk through their plain versions (and the
    bitmap); the --device-dict dictionary must be the default one mixed and
    the anchor files byte-identical; the default dict stage must peak
    under DICT_PEAK_PER_PAIR bytes per pair; the copy-back share must be
    above 0 on both routes; the read API must return SCALE_GENOMES columns
    equal to the oracle on a window.  Returns the default build's launch
    counts."""
    from panagram_tpu_torch import pipeline
    from panagram_tpu_torch.__main__ import main
    from panagram_tpu_torch.index import Index
    from panagram_tpu_torch.io.bgzf import decompress_file
    from panagram_tpu_torch.ops import kernels
    from panagram_tpu_torch.ops.anchor import anchor_chunk_fast
    from panagram_tpu_torch.ops.codec import pack_bases_np
    from panagram_tpu_torch.ops.dictionary import PanKmerDict, npz_member
    from panagram_tpu_torch.ops.lookup import BucketedDict, mix64_np
    from panagram_tpu_torch.ops.ref_impl import anchor_np, masks_to_bytes_np

    work = os.path.join(work, "scale100")
    N, k, anchors = SCALE_GENOMES, SCALE_K, SCALE_ANCHORS
    nbytes, nk = (N + 7) // 8, SCALE_BP - k + 1
    chunk = 1 << max(int(np.ceil(np.log2(nk))), 18)   # index.py's ladder
    t0 = time.perf_counter()
    seqs = make_genomes(work, N, SCALE_BP, anchors)
    print(f"scale100 [{card}]: generated {N} x {SCALE_BP / 1e6:g} Mbp "
          f"genomes in {time.perf_counter() - t0:.1f} s; k={k}, anchors "
          f"{', '.join(anchors)}, {nbytes} B per position, {chunk}-position "
          "chunks", flush=True)
    samples = os.path.join(work, "samples.tsv")
    runs = {}
    for route, stage in (("default", "build_dict_stage"),
                         ("--device-dict", "build_dict_device")):
        prefix = os.path.join(work, "idx" if route == "default" else "idx_dd")
        peaks: list = []
        real = getattr(pipeline, stage)
        setattr(pipeline, stage, stage_peaks(real, peaks))
        lines = _Lines()
        pkg = logging.getLogger("panagram_tpu_torch")
        pkg.addHandler(lines)
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            main(["index", samples, "-k", str(k), "--prefix", prefix,
                  "--anchor-genomes", *anchors]
                 + (["--device-dict"] if route != "default" else []))
            torch.cuda.synchronize()
        finally:
            setattr(pipeline, stage, real)
            pkg.removeHandler(lines)
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        (peak,) = peaks
        runs[route] = prefix, launches
        print(f"scale100 {route} build [{card}]: {wall:.2f} s wall, launches "
              f"{launches}, dict stage peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
        for name in ANCHOR_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"scale100 {route}: kernel {name} was "
                                     "not launched")
        if route == "default":
            pairs = sum(len(npz_member(os.path.join(
                prefix, "kmc", f"g{g}.kmers.npz"), "kmers", mmap=True))
                for g in range(N))
            print(f"  dict stage: {pairs} (key, genome) pairs, "
                  f"{peak / pairs:.1f} B per pair", flush=True)
            if peak > DICT_PEAK_PER_PAIR * pairs:
                raise AssertionError(f"scale100: the dict stage peaked at "
                                     f"{peak / pairs:.1f} B per pair, over "
                                     f"{DICT_PEAK_PER_PAIR}")
        else:
            # the anchor stages launch pack_mix once per chunk, as
            # probe_sorted; the rest ran in the dict stage, once per
            # sequence chunk of the DeviceDictBuilder
            want = N * -(-nk // CHUNK)
            got = launches["pack_mix"] - launches["probe_sorted"]
            if got != want:
                raise AssertionError(f"scale100: pack_mix ran {got} times in "
                                     f"the device-dict stage, not {want}")
            print(f"  dict stage: pack_mix launched once per sequence chunk "
                  f"({got})", flush=True)
        walls = stage_walls(prefix)
        count_s = sum(v for st, v in walls.items() if st.startswith("kmc."))
        anchor_s = sum(walls[f"anchor.{a}"] for a in anchors)
        print(f"  stage walls [{card}]: "
              + (f"count ({N} genomes) {count_s:.3f}s " if count_s else "")
              + " ".join(f"{st}={walls[st]:.3f}s" for st in
                         ["dict", "layout"] + [f"anchor.{a}" for a in anchors]
                         + ["mash.triangle"]), flush=True)
        print("  " + next(m for m in lines.lines
                          if m.startswith("dict phases")), flush=True)
        copy_share(anchor_phases(prefix, anchors), anchor_s, card)
        print(f"  anchored k-mers/s [{card}]: {len(anchors) * nk / anchor_s:.4g}"
              f" over the whole anchor stages", flush=True)

    ref, dd = runs["default"][0], runs["--device-dict"][0]
    pan = PanKmerDict.load(os.path.join(ref, "kmc", "pandict.npz"))
    got = PanKmerDict.load(os.path.join(dd, "kmc", "pandict.npz"))
    mixed = mix64_np(pan.keys)
    order = np.argsort(mixed)
    if pan.nwords != 4 or got.key_space != "mixed" \
            or not np.array_equal(got.keys, mixed[order]) \
            or not np.array_equal(got.masks, pan.masks[order]):
        raise AssertionError("scale100: the --device-dict pandict.npz is not "
                             "the default dictionary in mixed space")
    for a in anchors:
        for f in ("bitmap.1.gz", "bitmap.1.gzi", "bitmap.100.gz",
                  "bitmap.100.gzi", "chrs.tsv", "bitsum.bins.tsv",
                  "total_paircounts.csv"):
            if not filecmp.cmp(os.path.join(dd, "anchor", a, f),
                               os.path.join(ref, "anchor", a, f),
                               shallow=False):
                raise AssertionError(f"scale100: --device-dict anchor/{a}/{f} "
                                     "differs from the default route's")
    print(f"scale100: dictionary of {len(pan)} keys x {pan.nwords} words; the "
          "--device-dict one equals it mixed; the anchor files of both routes "
          "are byte-identical", flush=True)

    # each anchor's chunk as the stream feeds it, through the card's kernels
    # and through their plain versions on the card
    bd = BucketedDict.build_device(pan.keys, pan.masks, N, k, device=dev)
    print(f"  table 2^{bd.nbits} x {bd.stride} u32 "
          f"({bd.table.numel() * 4 / 2**20:.0f} MiB), cap {bd.cap}", flush=True)
    L = chunk + k - 1
    for a in anchors:
        buf = np.full(L, 255, np.uint8)
        buf[:SCALE_BP] = seqs[a]
        packed, nmask, _ = pack_bases_np(buf)
        p = torch.from_numpy(packed).to(dev)
        n = torch.from_numpy(nmask).to(dev)

        def run():
            return anchor_chunk_fast(p, n, bd.table, L, k, bd.nbits, bd.cap,
                                     bd.nwords, nbytes)

        kernels.reset_launches()
        by, popc, cols = run()
        torch.cuda.synchronize()
        once = dict(kernels.launches)
        with plain_kernels():
            want = run()
        torch.cuda.synchronize()
        if any(once[nm] != 1 for nm in ANCHOR_KERNELS) \
                or kernels.launches != once:
            raise AssertionError(f"scale100 {a}: launches {once} then "
                                 f"{kernels.launches} around the plain run")
        err = max_abs_err((by, popc, cols), want)
        bits = decompress_file(os.path.join(ref, "anchor", a, "bitmap.1.gz"))
        if err != 0 or by[:nk].cpu().numpy().tobytes() != bits:
            raise AssertionError(f"scale100 {a}: the chunk through the "
                                 f"kernels differs from the plain versions "
                                 f"(max |err| {err}) or from bitmap.1.gz")
        rows = anchor_np(seqs[a][:ORACLE_POSITIONS + k - 1], k, pan.keys,
                         pan.masks)
        if bits[:ORACLE_POSITIONS * nbytes] != \
                masks_to_bytes_np(rows, nbytes).tobytes():
            raise AssertionError(f"scale100 {a}: bitmap differs from the "
                                 "numpy oracle over its first positions")
        print(f"  {a}: the {chunk}-position chunk through the four kernels "
              "equals their plain versions on the card and bitmap.1.gz; its "
              f"first {ORACLE_POSITIONS} positions equal ref_impl.anchor_np",
              flush=True)
        if a == anchors[0]:
            real_probe(f"scale100's {a} chunk (W={bd.nwords})", p, n, L, k,
                       chunk, bd, card)
    del bd
    torch.cuda.empty_cache()

    s, e = SCALE_BP // 2, SCALE_BP // 2 + 5000
    idx = Index(ref)
    tab = idx.query_bitmap("g0", "chr1", s, e)
    rows = anchor_np(seqs["g0"][s:e + k - 1], k, pan.keys, pan.masks)
    want = np.unpackbits(rows.astype("<u4").view(np.uint8), axis=1,
                         bitorder="little")[:, :N]
    if tab.values.shape != (e - s, N) or len(tab.columns) != N \
            or not np.array_equal(tab.values, want):
        raise AssertionError(f"scale100: query_bitmap g0 chr1 {s}-{e} differs "
                             "from the numpy oracle")
    print(f"scale100: Index(prefix).query_bitmap g0 chr1 {s}-{e} returns "
          f"{len(tab.columns)} columns equal to the numpy oracle", flush=True)
    return runs["default"][1]


def _junction_windows(glen: int, alen: int, k: int, nk: int) -> np.ndarray:
    """Start positions of the windows of an anchor of `alen` bases, genome 0
    of `glen` bases tiled, that cross a tile junction."""
    starts = [np.arange(j - k + 1, j) for j in range(glen, alen, glen)]
    out = np.concatenate(starts) if starts else np.zeros(0, np.int64)
    return out[out < nk]


def bigdict_phase(card: str, dev, bench_value: int, measured: dict):
    """tools/bigdict_run.py's two runs through the port's tool
    (panagram_tpu_torch/tools/bigdict_run.run, BIGDICT_RUNS): the genomes
    counted and merged by the device builder, the table laid out from its
    arrays, a BIGDICT_ANCHOR_MBP anchor streamed.  Each run's launches must
    be its chunks' (counts from 0 around it), D the host's exact distinct
    count; the stream's bytes and popcounts at ORACLE_POSITIONS random
    positions and at every window across a tile junction, and the bytes,
    popcounts and column sums of the chunk with the first junction, must
    equal truth_rows of the genomes' own sets; that chunk through the
    kernels must equal it through their plain versions; the builder's peak
    must stay within its budget check and the layout's transients within
    layout_bytes; the copy-back share of the best pass must be above 0.
    real_probe reads probe_sorted on that chunk."""
    from panagram_tpu_torch.ops import kernels
    from panagram_tpu_torch.ops.anchor import anchor_chunk_fast
    from panagram_tpu_torch.ops.codec import pack_bases_np
    from panagram_tpu_torch.ops.devdict import DeviceDictBuilder, merge_bytes
    from panagram_tpu_torch.ops.lookup import layout_bytes
    from panagram_tpu_torch.ops.ref_impl import (
        canonical_kmers_np,
        distinct_count,
        genome_sets,
        masks_to_bytes_np,
        popcount_np,
        truth_rows,
    )
    from panagram_tpu_torch.tools import bigdict_run as B

    k = BIGDICT_K
    for label, n, mbp in BIGDICT_RUNS:
        print(f"bigdict {label} [{card}]: bigdict_run.run({n}, {mbp}, "
              f"{BIGDICT_ANCHOR_MBP}, {k})", flush=True)
        r, launches, wall = _launched(lambda: B.run(
            n, mbp, BIGDICT_ANCHOR_MBP, k, device=dev,
            min_keys=BIGDICT_MIN_KEYS))
        glen, alen = len(r.genomes[0]), len(r.anchor_codes)
        nk, W, nbytes = r.nkmers, r.nwords, r.nbytes
        per_pass = -(-nk // B.CHUNK)
        want = {name: (1 + B.PASSES) * per_pass for name in STREAM_KERNELS}
        # the builder packs and mixes each of its chunks on the card
        for name in ("pack_bases", "pack_mix"):
            want[name] += n * -(-(glen - k + 1) // B.CHUNK)
        if launches != want:
            raise AssertionError(f"bigdict {label}: launches {launches}, want "
                                 f"{want} (the builder's chunks and "
                                 f"{1 + B.PASSES} passes of {per_pass})")

        t0 = time.perf_counter()
        sets = genome_sets(r.genomes, k)
        exact = distinct_count(sets)
        t_sets = time.perf_counter() - t0
        print(f"  D = {r.D:,} keys x {W} words; the host's exact distinct "
              f"count {exact:,} (np.sort and a diff, {t_sets:.1f} s)"
              + (f"; the JAX tool's generator gave {BIGDICT_W1_KEYS:,}"
                 if label == "W=1" else ""), flush=True)
        if r.D != exact:
            raise AssertionError(f"bigdict {label}: D {r.D} != the exact "
                                 f"count {exact}")

        # the stream's outputs against the truth of the genomes' own sets
        t0 = time.perf_counter()
        canon, valid = canonical_kmers_np(r.anchor_codes, k)
        junctions = _junction_windows(glen, alen, k, nk)
        pos = np.union1d(np.random.default_rng(11).choice(
            nk, ORACLE_POSITIONS, replace=False), junctions)
        rows = truth_rows(sets, canon[pos], valid[pos])
        if not np.array_equal(r.bytes[pos], masks_to_bytes_np(rows, nbytes)) \
                or not np.array_equal(r.popc[pos], popcount_np(rows)):
            raise AssertionError(f"bigdict {label}: bytes or popcounts differ "
                                 "from the genomes' truth at the sampled "
                                 "positions")
        c = glen // B.CHUNK
        s, m, cols = r.colsums[c]
        rows = truth_rows(sets, canon[s:s + m], valid[s:s + m])
        bits = np.unpackbits(rows.view(np.uint8), axis=1,
                             bitorder="little")[:, :n]
        if not np.array_equal(r.bytes[s:s + m],
                              masks_to_bytes_np(rows, nbytes)) \
                or not np.array_equal(r.popc[s:s + m], popcount_np(rows)) \
                or not np.array_equal(cols, bits.sum(axis=0)) \
                or int(r.popc.sum()) != sum(int(x[2].sum())
                                            for x in r.colsums):
            raise AssertionError(f"bigdict {label}: chunk {c} differs from the "
                                 "genomes' truth, or the column sums from "
                                 "the popcounts")
        hit = float(np.count_nonzero(r.popc[pos])) / len(pos)
        print(f"  the stream equals the genomes' truth at {len(pos)} "
              f"positions ({ORACLE_POSITIONS} random, {len(junctions)} "
              f"across {alen // glen} tile junctions; {hit:.4f} of them hit) "
              f"and over chunk {c} ({m} positions: bytes, popcounts, column "
              f"sums); the column sums of all {len(r.colsums)} chunks add up "
              f"to the popcounts ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        del sets, canon, valid, rows, bits

        # that chunk through the kernels and through their plain versions
        L = B.CHUNK + k - 1
        buf = np.full(L, 255, np.uint8)
        buf[:m + k - 1] = r.anchor_codes[s:s + m + k - 1]
        packed, nmask, _ = pack_bases_np(buf)
        p = torch.from_numpy(packed).to(dev)
        nm = torch.from_numpy(nmask).to(dev)
        bd = r.bd

        def chunk():
            return anchor_chunk_fast(p, nm, bd.table, L, k, bd.nbits, bd.cap,
                                     bd.nwords, nbytes)

        got, once, _ = _launched(chunk)
        with plain_kernels():
            plain = chunk()
        torch.cuda.synchronize()
        after = {n: c for n, c in kernels.launches.items() if c}
        err = max_abs_err(got, plain)
        if once != {name: 1 for name in ANCHOR_KERNELS} or after != once \
                or err != 0 \
                or not np.array_equal(got[0][:m].cpu().numpy(),
                                      r.bytes[s:s + m]):
            raise AssertionError(f"bigdict {label}: chunk {c} through the "
                                 f"kernels ({once}, then {after} after the "
                                 f"plain run) differs from their plain "
                                 f"versions (max |err| {err}) or the stream")
        del got, plain
        print(f"  chunk {c} through the four kernels equals their plain "
              "versions on the card and the stream's", flush=True)
        probe = real_probe(f"the {label} 1e8-key table, chunk {c}", p, nm, L,
                           k, B.CHUNK, bd, card)
        ref = measured[KERNEL_GENOMES[W - 1]]["probe_sorted"]
        print(f"  probe_sorted at 2^{bd.nbits} rows: cold "
              f"{probe['cold_ms']:.5f} ms, share of bound "
              f"{probe['bound_ms'] / probe['cold_ms']:.3f}; the kernel phase's "
              f"chunk at a 1.3e7-key table (N={KERNEL_GENOMES[W - 1]}): cold "
              f"{ref['cold_ms']:.5f} ms, share {ref['share']:.3f}", flush=True)
        del p, nm

        # the walls, the geometry and the peaks
        base = r.peaks["layout_base"]
        trans = r.peaks["layout"] - base - r.table_bytes
        model = layout_bytes(r.D, W, "sorted") - (8 + 4 * W) * r.D
        cap, buffered = r.capacity, DeviceDictBuilder.FLUSH_CHUNKS * B.CHUNK
        budget = (8 + 4 * W) * cap + 8 * buffered \
            + merge_bytes(cap + buffered, W)
        print(f"  count+merge {r.walls['count_merge']:.3f} s "
              f"({n * glen / r.walls['count_merge'] / 1e6:.2f} Mbp/s, "
              f"{r.builder_walls['flushes']} merges); layout "
              f"{r.walls['layout']:.3f} s, route {r.route}; table 2^{r.nbits} "
              f"x {r.stride} u32 (cap {r.cap}) = "
              f"{r.table_bytes / 2**30:.3f} GiB", flush=True)
        print(f"  peak device memory: builder {r.peaks['builder'] / 2**30:.3f} "
              f"GiB (its arrays {cap} rows, {cap * (8 + 4 * W) / 2**30:.3f} "
              f"GiB; its budget check counts {budget / 2**30:.3f} GiB, ratio "
              f"{r.peaks['builder'] / budget:.3f}), layout "
              f"{r.peaks['layout'] / 2**30:.3f} GiB; the layout's transients "
              f"beside its table and inputs {trans / 2**30:.3f} GiB "
              f"(layout_bytes model {model / 2**30:.3f} GiB, ratio "
              f"{trans / model:.3f})", flush=True)
        if r.route not in ("single", "chunked"):
            raise AssertionError(f"bigdict {label}: the table was laid out on "
                                 f"route {r.route!r}, not on the device")
        if r.peaks["builder"] > budget or (r.route == "single"
                                           and trans > model):
            raise AssertionError(f"bigdict {label}: the builder's peak over "
                                 f"its budget check ({r.peaks['builder']} > "
                                 f"{budget} B) or the layout's transients "
                                 f"over layout_bytes ({trans} > {model} B)")
        for i, ps in enumerate(r.passes):
            print(f"  pass {i}: {ps['kmers_per_s']:.6g} k-mers/s, wall "
                  f"{ps['wall']:.6f} s, pack {ps['pack']:.6f} s, copy "
                  f"{ps['copy']:.6f} s (card time)", flush=True)
        best = r.best_pass
        share = best["copy"] / best["wall"]
        print(f"  best pass {r.best:.6g} k-mers/s against bench_torch's value "
              f"{bench_value:.6g} in this run ({r.best / bench_value:.3f}x); "
              f"copy-back share of the best pass {share:.6f}; phase wall "
              f"{wall:.1f} s", flush=True)
        if not share > 0:
            raise AssertionError(f"bigdict {label}: the best pass logged no "
                                 "copy-back time")
        del r, bd
        torch.cuda.empty_cache()


def w4_steady_phase(work: str, card: str, dev):
    """tools/w4_steady.py through the port's tool on scale100's
    default-route index (W=4) with --chunk 21: (reps + 1) sequences of
    W4_MBP Mbp, each chunk one launch of each anchor kernel (counts from 0
    around it); rep 1 streamed again through the kernels (one launch of
    each per chunk) must give the run's k-mers, hits and column sums, and
    through their plain versions (no launch) the same bytes, k-mers, hits
    and column sums."""
    from panagram_tpu_torch.ops import kernels
    from panagram_tpu_torch.ops.anchor import stream_anchor_chunks
    from panagram_tpu_torch.tools import w4_steady

    idx = os.path.join(work, "scale100", "idx")
    print(f"w4_steady [{card}]: w4_steady.run({idx!r}, {W4_MBP}, {W4_REPS}, "
          f"{W4_CHUNK})", flush=True)
    r, launches, wall = _launched(lambda: w4_steady.run(
        idx, W4_MBP, W4_REPS, W4_CHUNK, device=dev))
    L = int(W4_MBP * 1e6)
    size = 1 << W4_CHUNK
    nk = L - r.k + 1
    want = {name: (W4_REPS + 1) * -(-nk // size) for name in STREAM_KERNELS}
    if r.nwords != 4 or launches != want:
        raise AssertionError(f"w4_steady: W={r.nwords}, launches {launches}, "
                             f"want W=4 and {want}")
    codes = list(w4_steady.sequences(L, W4_REPS))[1]
    nbytes = (r.ngenomes + 7) // 8

    def rep1():
        """Rep 1 streamed again: its bytes, k-mers, hits and column sums."""
        out = np.empty((nk, nbytes), np.uint8)
        total = hits = 0
        colsum = np.zeros(r.ngenomes, np.int64)
        for s0, m, by, popc, cs in stream_anchor_chunks(
                codes, nk, size, None, r.bd.table, r.bd, nbytes, r.ngenomes,
                r.k):
            out[s0:s0 + m] = by
            total += m
            hits += int(np.count_nonzero(popc))
            colsum += cs
        return out, total, hits, colsum

    (kby, ktot, khits, kcols), once, _ = _launched(rep1)
    with plain_kernels():
        pby, ptot, phits, pcols = rep1()
    after = {n: c for n, c in kernels.launches.items() if c}
    per_rep = {name: -(-nk // size) for name in STREAM_KERNELS}
    if once != per_rep or after != once:
        raise AssertionError(f"w4_steady: rep 1 again launched {once}, then "
                             f"{after} after the plain run; want {per_rep} "
                             "and no launch from the plain versions")
    rep = r.reps[1]
    if (ktot, khits) != (rep["kmers"], rep["hits"]) \
            or not np.array_equal(kcols, rep["colsums"]):
        raise AssertionError("w4_steady: rep 1 streamed again differs from "
                             "the run's rep 1")
    if not np.array_equal(kby, pby) or (ktot, khits) != (ptot, phits) \
            or not np.array_equal(kcols, pcols):
        raise AssertionError("w4_steady: rep 1 through the kernels differs "
                             "from their plain versions")
    print(f"  rep 1 through the plain versions: the same {nk} x {nbytes} "
          f"bytes, {ptot} k-mers, {phits} hits and column sums (total "
          f"{int(pcols.sum())}) as through the kernels and the run",
          flush=True)
    del kby, pby
    for i, rp in enumerate(r.reps):
        print(f"  rep {i}: wall {rp['wall']:.6f} s, "
              f"{rp['kmers'] / rp['wall']:.6g} k-mers/s, pack "
              f"{rp['pack']:.6f} s, copy {rp['copy']:.6f} s, hit share "
              f"{rp['hits'] / rp['kmers']:.6f}", flush=True)
    print(f"  W=4 steady {r.best_mbp_s:.4f} Mbp/s (best of {W4_REPS}); "
          f"{r.D} keys, table {r.table_shape}, layout {r.layout_s:.3f} s; "
          f"launches {launches}; phase wall {wall:.1f} s", flush=True)
    del r
    torch.cuda.empty_cache()


def write_reads(path: str, genome: np.ndarray) -> np.ndarray:
    """READ_LEN-bp reads at READ_COVERAGE x of `genome`, uniform starts,
    READ_SUBST substitutions (seed 0), as uncompressed FASTQ.  Returns the
    reads' codes [n, READ_LEN]."""
    rng = np.random.default_rng(0)
    n = READ_COVERAGE * len(genome) // READ_LEN
    starts = rng.integers(0, len(genome) - READ_LEN + 1, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, READ_LEN)[starts]
    sub = rng.random(reads.shape) < READ_SUBST
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    seqs = np.frombuffer(b"ACGT", np.uint8)[reads]
    qual = b"I" * READ_LEN
    with open(path, "wb") as f:
        f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual)
                         for i in range(n)))
    return reads


def write_gff(path: str, seqid: str, size: int, rng, genes_only=False):
    """GFF3 with a gene every ~GENE_EVERY bp (1-3 kbp, one mRNA, four
    exons) and a 300-bp repeat_region every REPEAT_EVERY bp.  Returns the
    genes' (start, end) as written (1-based, used as 0-based slices)."""
    lines, genes = ["##gff-version 3"], []
    for i, s0 in enumerate(range(1, size - 5_000, GENE_EVERY)):
        start = s0 + int(rng.integers(0, 1_000))
        end = start + int(rng.integers(1_000, 3_000))
        genes.append((start, end))
        lines.append(f"{seqid}\tsim\tgene\t{start}\t{end}\t.\t+\t.\t"
                     f"ID=gene{i};Name=G{i}")
        if genes_only:
            continue
        lines.append(f"{seqid}\tsim\tmRNA\t{start}\t{end}\t.\t+\t.\t"
                     f"ID=mrna{i};Parent=gene{i}")
        edges = np.linspace(start, end, 9).astype(int)
        for e in range(4):
            lines.append(f"{seqid}\tsim\texon\t{edges[2 * e]}\t"
                         f"{edges[2 * e + 1]}\t.\t+\t.\t"
                         f"ID=exon{i}_{e};Parent=mrna{i}")
    if not genes_only:
        for r in range(1, size, REPEAT_EVERY):
            lines.append(f"{seqid}\tsim\trepeat_region\t{r}\t{r + 299}\t.\t"
                         f"+\t.\tID=rep{r}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return genes


def read_bed(path: str) -> list[list[str]]:
    from panagram_tpu_torch.io.bgzf import decompress_file

    return [line.split("\t")
            for line in decompress_file(path).decode().splitlines()]


def bitmap_popc(d: str, nbytes: int) -> np.ndarray:
    from panagram_tpu_torch.io.bgzf import decompress_file

    by = np.frombuffer(decompress_file(os.path.join(d, "bitmap.1.gz")),
                       np.uint8).reshape(-1, nbytes)
    return np.unpackbits(by, axis=1, bitorder="little").sum(
        axis=1, dtype=np.int64)


def check_gene_rows(rows, popc, N: int, what: str, oracle_limit=None):
    """Each gene row's genomes-present counts (columns 1 and N) against
    np.bincount of popc over its span (GFF coordinates as 0-based
    slices); genes past popc must hold zeros.  Returns rows checked."""
    checked = 0
    for r in rows:
        s, e = int(r[1]), int(r[2])
        if oracle_limit is not None and e > oracle_limit:
            continue
        want = (np.bincount(popc[s:e], minlength=N + 1) if e <= len(popc)
                else np.zeros(N + 1, np.int64))
        if (int(r[4]), int(r[5])) != (int(want[1]), int(want[N])):
            raise AssertionError(f"{what}: gene {r[:4]} holds {r[4:]}, the "
                                 f"bitmap gives {want[1]}, {want[N]}")
        checked += 1
    return checked


def same_trees(a: str, b: str, what: str = "--cores 3 and --cores 1",
               skip=("config.yaml",)) -> int:
    """Every file of tree a but logs/ and the names in skip equals b's;
    anno_types.txt as a set of lines.  Returns the files compared."""
    n = 0
    for root, _, files in os.walk(a):
        rel = os.path.relpath(root, a)
        if rel.split(os.sep)[0] == "logs":
            continue
        for fn in files:
            if fn in skip:
                continue
            p, q = os.path.join(root, fn), os.path.join(b, rel, fn)
            if fn == "anno_types.txt":
                with open(p) as f, open(q) as g:
                    same = sorted(f.read().split()) == sorted(g.read().split())
            else:
                same = filecmp.cmp(p, q, shallow=False)
            if not same:
                raise AssertionError(f"{what} differ: {rel}/{fn}")
            n += 1
    return n


def full_index_phase(work: str, seqs: dict, card: str, dev) -> dict:
    """The whole index command: a FASTQ read set, GFF annotation, --cores
    3 against --cores 1, annotate, the embeddings.  Returns the launch
    counts of the --cores 3 build."""
    from panagram_tpu_torch import pipeline
    from panagram_tpu_torch.__main__ import main
    from panagram_tpu_torch.io.fasta import seq_to_codes
    from panagram_tpu_torch.ops import count, kernels
    from panagram_tpu_torch.ops.dictionary import PanKmerDict
    from panagram_tpu_torch.ops.ref_impl import anchor_np, popcount_np

    t0 = time.perf_counter()
    reads = write_reads(os.path.join(work, "fa", "reads.fq"), seqs["g3"])
    rng = np.random.default_rng(0)
    genes = {a: write_gff(os.path.join(work, "fa", f"{a}.gff"), "chr1",
                          GENOME_BP, rng) for a in ANCHORS}
    with open(os.path.join(work, "samples_full.tsv"), "w") as f:
        f.write("name\tfasta\tgff\n")
        for g in range(GENOMES):
            gff = f"fa/g{g}.gff" if f"g{g}" in ANCHORS else ""
            f.write(f"g{g}\tfa/g{g}.fa\t{gff}\n")
        f.write("reads\tfa/reads.fq\t\n")
    print(f"full-index inputs: {len(reads)} reads of {READ_LEN} bp "
          f"({reads.size / 1e6:.1f} Mbp), "
          f"{sum(len(v) for v in genes.values())} genes in 3 GFFs, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    N = GENOMES + 1
    nbytes = (N + 7) // 8
    real_stage = pipeline.anchor_stage
    lines = _Lines()
    pkg = logging.getLogger("panagram_tpu_torch")
    out, spans = {}, {}
    for cores in (3, 1):
        prefix = os.path.join(work, f"idx_full_c{cores}")
        spans[cores] = []

        def timed_stage(*args, _s=spans[cores], **kwargs):
            t = time.perf_counter()
            real_stage(*args, **kwargs)
            _s.append((t, time.perf_counter()))

        pipeline.anchor_stage = timed_stage
        pkg.addHandler(lines)
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            main(["index", os.path.join(work, "samples_full.tsv"), "-k",
                  str(K), "--prefix", prefix, "--cores", str(cores),
                  "--anchor-genomes", *ANCHORS, "--device", str(dev)])
            if dev.type == "cuda":
                torch.cuda.synchronize()
        finally:
            pipeline.anchor_stage = real_stage
            pkg.removeHandler(lines)
        out[cores] = (prefix, time.perf_counter() - t0, dict(kernels.launches))
    finish = [float(m.split("finish=")[1].rstrip("s")) for m in lines.lines
              if m.startswith("anchor phases:")]

    (p3, wall3, launches), (p1, wall1, launches1) = out[3], out[1]
    n = same_trees(p3, p1)
    print(f"full index: --cores 3 and --cores 1 trees identical ({n} files)",
          flush=True)
    if os.path.exists(os.path.join(p3, "anchor", "reads")):
        raise AssertionError("the FASTQ read set was anchored")
    got = np.load(os.path.join(p3, "kmc", "reads.kmers.npz"))["kmers"]
    t0 = time.perf_counter()
    want = count.counted_kmers_chunked(iter(reads), K, device="cpu",
                                       min_count=pipeline.FASTQ_MIN_COUNT)
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError(f"reads.kmers.npz ({len(got)} keys) differs from "
                             f"the plain CPU count ({len(want)} keys)")
    print(f"reads: {len(got)} k-mers seen twice or more, equal to the plain "
          f"CPU count ({cpu_s:.1f} s on the host)", flush=True)

    pan = PanKmerDict.load(os.path.join(p3, "kmc", "pandict.npz"))
    rows = anchor_np(seqs["g0"][:ORACLE_POSITIONS + K - 1], K, pan.keys,
                     pan.masks)
    d0 = os.path.join(p3, "anchor", "g0")
    n_or = check_gene_rows(read_bed(os.path.join(d0, "gene.bed.gz")),
                           popcount_np(rows), N, "g0 oracle",
                           oracle_limit=ORACLE_POSITIONS)
    if n_or == 0:
        raise AssertionError("no gene of g0 inside the oracle window")
    for a in ANCHORS:
        d = os.path.join(p3, "anchor", a)
        bed = read_bed(os.path.join(d, "gene.bed.gz"))
        if len(bed) != len(genes[a]):
            raise AssertionError(f"{a}: {len(bed)} genes in gene.bed.gz")
        popc = bitmap_popc(d, nbytes)
        check_gene_rows(bed, popc, N, a)
        with open(os.path.join(d, "bitsum.genes.tsv")) as f:
            tot = [int(x) for x in f.read().splitlines()[1].split("\t")[1:]]
        want_tot = sum(np.bincount(popc[s:e], minlength=N + 1)
                       for s, e in genes[a] if e <= len(popc))
        if tot != [int(x) for x in want_tot]:
            raise AssertionError(f"{a}: bitsum.genes.tsv disagrees with the "
                                 "bitmap")
        nbins = -(-(GENOME_BP - K + 1) // UMAP_BIN)
        for fn in ("chrom_umaps.csv", "genome_umap.csv"):
            with open(os.path.join(d, fn)) as f:
                body = [r.split(",") for r in f.read().splitlines()[1:]]
            xy = np.array([[float(r[3]), float(r[4])] for r in body])
            if len(body) != nbins or not np.isfinite(xy).all() \
                    or not xy.any():
                raise AssertionError(f"{a}/{fn}: {len(body)} rows for "
                                     f"{nbins} bins, or not finite")
    print(f"genes: g0's {n_or} genes in the first {ORACLE_POSITIONS} positions "
          "match the numpy oracle; every gene of g0-g2 matches its bitmap; "
          f"UMAP CSVs hold {nbins} finite rows each", flush=True)

    new_gff = os.path.join(work, "fa", "new_g1.gff")
    new = write_gff(new_gff, "chr1", GENOME_BP, np.random.default_rng(1),
                    genes_only=True)
    with open(new_gff, "a") as f:
        f.write(f"chr1\tsim\tgene\t{GENOME_BP - 100}\t{GENOME_BP + 100}\t.\t"
                "+\t.\tID=pastend\n")
    kernels.reset_launches()
    t0 = time.perf_counter()
    main(["annotate", p3, "g1", new_gff, "--device", str(dev)])
    annotate_s = time.perf_counter() - t0
    ann_launches = kernels.launches["fused_popcount_colsums"]
    d1 = os.path.join(p3, "anchor", "g1")
    bed = read_bed(os.path.join(d1, "gene.bed.gz"))
    if len(bed) != len(new) + 1:
        raise AssertionError(f"annotate: {len(bed)} genes for {len(new) + 1}")
    check_gene_rows(bed, bitmap_popc(d1, nbytes), N, "annotate g1")
    print(f"annotate g1: {len(bed)} genes match popcounts of its bitmap",
          flush=True)

    span3 = max(e for _, e in spans[3]) - min(s for s, _ in spans[3])
    span1 = max(e for _, e in spans[1]) - min(s for s, _ in spans[1])
    walls = stage_walls(p3)
    print(f"full-index walls [{card}]:", flush=True)
    print(f"  build --cores 3 / --cores 1: {wall3:.3f} / {wall1:.3f} s",
          flush=True)
    print(f"  FASTQ count stage: {walls['kmc.reads']:.3f} s, "
          f"{len(reads) / walls['kmc.reads']:.4g} reads/s "
          f"({reads.size / walls['kmc.reads']:.4g} bases/s)", flush=True)
    print(f"  anchor stage (3 anchors, first start to last end): "
          f"--cores 3 {span3:.3f} s, --cores 1 {span1:.3f} s", flush=True)
    print(f"  annotate g1 ({len(bed)} genes): {annotate_s:.3f} s", flush=True)
    print("  embedding (finish) per anchor: --cores 3 "
          + " ".join(f"{x:.3f}" for x in finish[:3]) + " s, --cores 1 "
          + " ".join(f"{x:.3f}" for x in finish[3:]) + " s", flush=True)
    walls1 = stage_walls(p1)
    for st in ["dict", "layout"] + [f"anchor.{a}" for a in ANCHORS] \
            + ["mash.triangle"]:
        print(f"  --cores 1 {st:18s}  {walls1[st]:9.3f} s", flush=True)
    print("  --cores 1:", flush=True)
    anchor_phases(p1, ANCHORS)

    for name in STREAM_KERNELS:
        if launches[name] <= 0 or launches1[name] != launches[name]:
            raise AssertionError(f"full index: kernel {name} launched "
                                 f"{launches[name]} / {launches1[name]} times "
                                 "(--cores 3 / 1)")
    if ann_launches <= 0:
        raise AssertionError("annotate did not launch fused_popcount_colsums")
    print(f"full index launches (--cores 3): {launches}; annotate: "
          f"fused_popcount_colsums x{ann_launches}", flush=True)
    return launches


def read_phase(work: str, seqs: dict, card: str):
    """The port's read path on the card's machine: Index(prefix) in read
    mode over the slice's index and the full-index phase's annotated tree.
    query_bitmap of g0 at step 1 over READ_WINDOWS random windows (seed 0),
    windows across BGZF block edges and at the chromosome's end, against
    the rows of the decompressed bitmap.1.gz; steps 100 and 200 against
    step 1 sliced; `bitdump -v` of g0's first ORACLE_POSITIONS positions
    through the CLI against the numpy oracle; every gene of every
    chromosome by query_genes with the bitmap's popcounts, every
    annotation type of the GFFs by query_anno; the aggregates.  Prints
    the host's times for opening the index, a READ_MBP step-1 query, a
    whole chromosome at step 100 and a whole chromosome's gene fetch.
    Returns g0's presence bits over its first ORACLE_POSITIONS positions,
    from bitmap.1.gz and from the numpy oracle."""
    from panagram_tpu_torch.__main__ import main
    from panagram_tpu_torch.index import Index
    from panagram_tpu_torch.io.bgzf import MAX_BLOCK_DATA, decompress_file
    from panagram_tpu_torch.ops.dictionary import PanKmerDict
    from panagram_tpu_torch.ops.ref_impl import anchor_np

    prefix = os.path.join(work, "idx")
    N, nbytes, nk = GENOMES, (GENOMES + 7) // 8, GENOME_BP - K + 1
    t0 = time.perf_counter()
    idx = Index(prefix)
    open_s = time.perf_counter() - t0
    rows = np.frombuffer(decompress_file(os.path.join(
        prefix, "anchor", "g0", "bitmap.1.gz")), np.uint8).reshape(-1, nbytes)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :N]
    rng = np.random.default_rng(0)
    starts = rng.integers(0, nk, READ_WINDOWS)
    windows = [(int(s), int(min(s + rng.integers(1, 300_000), nk)))
               for s in starts]
    per_block = MAX_BLOCK_DATA // nbytes
    windows += [(per_block * j - 3, per_block * j + 5)
                for j in (1, 2, nk // per_block // 2, nk // per_block)]
    windows += [(nk - 1, nk), (nk - 1000, nk)]
    for s, e in windows:
        got = idx.query_bitmap("g0", "chr1", s, e)
        if not (np.array_equal(got.values, bits[s:e])
                and np.array_equal(got.index, np.arange(s, e))):
            raise AssertionError(f"query_bitmap g0 chr1 {s}-{e} differs from "
                                 "bitmap.1.gz")
    for step in (100, 200):
        if not np.array_equal(idx.query_bitmap("g0", "chr1", step=step).values,
                              bits[::step]):
            raise AssertionError(f"query_bitmap at step {step} differs from "
                                 "step 1 sliced")
        s = int(rng.integers(0, nk // 100)) * 100
        if not np.array_equal(idx.query_bitmap("g0", "chr1", s, nk - 7,
                                               step).values,
                              bits[s:nk - 7:step]):
            raise AssertionError(f"query_bitmap {s}- at step {step} differs")
    print(f"read: query_bitmap of g0 over {len(windows)} windows (block edges "
          f"every {per_block} rows, the last row) equals bitmap.1.gz; steps "
          "100 and 200 equal step 1 sliced", flush=True)

    pan = PanKmerDict.load(os.path.join(prefix, "kmc", "pandict.npz"))
    oracle = anchor_np(seqs["g0"][:ORACLE_POSITIONS + K - 1], K, pan.keys,
                       pan.masks)
    obits = np.unpackbits(oracle.astype("<u4").view(np.uint8), axis=1,
                          bitorder="little")[:, :N]
    buf = io.StringIO()
    sys_stdout, sys.stdout = sys.stdout, buf
    try:
        main(["bitdump", prefix, "g0", "chr1", "0", str(ORACLE_POSITIONS),
              "-v"])
    finally:
        sys.stdout = sys_stdout
    want = " ".join(f"g{g}" for g in range(N)) + "\n" + "".join(
        " ".join(map(str, r)) + "\n" for r in obits)
    if buf.getvalue() != want:
        raise AssertionError("bitdump -v of g0's first positions differs from "
                             "the numpy oracle")
    print(f"read: bitdump -v of g0 0-{ORACLE_POSITIONS} through the CLI equals "
          "the numpy oracle", flush=True)

    sizes = {}
    for a in ANCHORS:
        with open(os.path.join(prefix, "anchor", a, "chrs.tsv")) as f:
            f.readline()
            sizes[a] = [int(line.split("\t")[2]) for line in f]
    gs = dict(zip(idx.genome_sizes.index, idx.genome_sizes.values.tolist()))
    if gs != {a: [sum(v), len(v)] for a, v in sizes.items()} or not np.allclose(
            idx.bitfreq_totals.values.sum(axis=1), 1.0, rtol=0, atol=1e-12):
        raise AssertionError(f"read aggregates: genome_sizes {gs}")
    s = max(0, min(1_000_000, nk - READ_MBP))
    t0 = time.perf_counter()
    idx.query_bitmap("g0", "chr1", s, s + READ_MBP)
    mbp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.query_bitmap("g0", "chr1", step=100)
    chrom_s = time.perf_counter() - t0
    idx.close()

    full = os.path.join(work, "idx_full_c3")
    nb = (N + 1 + 7) // 8
    t0 = time.perf_counter()
    idx = Index(full)
    open_full_s = time.perf_counter() - t0
    gffs = {"g0": "g0.gff", "g1": "new_g1.gff", "g2": "g2.gff"}
    fetch_s, ngenes = None, 0
    for a in ANCHORS:
        d = os.path.join(full, "anchor", a)
        bed = read_bed(os.path.join(d, "gene.bed.gz"))
        got = []
        for chrom, _, _, _ in idx.genomes[a].chrs:
            t0 = time.perf_counter()
            t = idx.query_genes(a, chrom)
            if fetch_s is None:
                fetch_s, ngenes = time.perf_counter() - t0, len(t.values)
            got += [[str(x) for x in r] for r in t.values]
        if got != bed:
            raise AssertionError(f"query_genes of {a}: {len(got)} rows, "
                                 f"gene.bed.gz holds {len(bed)}")
        check_gene_rows(got, bitmap_popc(d, nb), N + 1, f"query_genes {a}")
        with open(os.path.join(work, "fa", gffs[a])) as f:
            types = {line.split("\t")[2] for line in f
                     if not line.startswith("#")} - {"gene"}
        anno = idx.query_anno(a, "chr1", 0, GENOME_BP)
        if set(anno.values[:, 3]) != types:
            raise AssertionError(f"query_anno of {a}: types "
                                 f"{set(anno.values[:, 3])}, the GFF {types}")
    idx.close()
    print(f"read: query_genes of g0-g2 returns every gene, its counts equal "
          f"the bitmap's popcounts; query_anno every annotation type",
          flush=True)
    print(f"read phase host times [{card}]: open the slice's index "
          f"{open_s:.4f} s (the annotated tree {open_full_s:.4f} s); a "
          f"{READ_MBP / 1e6:g}-Mbp step-1 query {mbp_s:.4f} s; a whole "
          f"{GENOME_BP / 1e6:g}-Mbp chromosome at step 100 {chrom_s:.4f} s; a "
          f"whole chromosome's gene fetch ({ngenes} genes) {fetch_s:.4f} s",
          flush=True)
    return bits[:ORACLE_POSITIONS], obits


def http_get(port: int, path: str):
    """(status, content type, body, seconds) of one GET to 127.0.0.1."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=600) as r:
            out = r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        out = e.code, e.headers.get("Content-Type"), e.read()
    return out + (time.perf_counter() - t0,)


def start_viewer(index, params=None):
    """The port's viewer handler on ThreadingHTTPServer(("127.0.0.1", 0))
    in a thread, with an index and a cache of its own."""
    import threading
    from collections import OrderedDict
    from http.server import ThreadingHTTPServer

    from panagram_tpu_torch.view import server

    handler = type("Handler", (server._Handler,), {
        "index": index, "_cache": OrderedDict(),
        "params": params or {"max_chr_bins": 350, "init": {},
                             "bookmarks": []}})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, handler


def view_phase(work: str, card: str, g0_bits, g0_oracle):
    """The port's viewer (``view``'s server) over the slice's index and the
    annotated full-index tree, each on an ephemeral port: the page and
    /api/meta (anchors and sizes against chrs.tsv), /api/bitdump over 1 kbp
    at steps 1 and 100 against g0's bitmap rows and the numpy oracle,
    /api/genes with and without q= against query_genes.  Where matplotlib
    imports, every figure route (PNGs and their /api/view and /api/map
    twins): PNG signature, map rows inside the image, collapse=<root> one
    merged row, and a second identical request served from the cache.
    Where it does not, every figure route must answer 500 naming
    matplotlib.  Prints each route's wall, first and repeated request."""
    from panagram_tpu_torch.index import Index

    try:
        import matplotlib
        mpl = matplotlib.__version__
    except ImportError:
        mpl = None
    print(f"view: matplotlib: {mpl or 'absent'}", flush=True)
    walls = []
    full = Index(os.path.join(work, "idx_full_c3"))
    idx = Index(os.path.join(work, "idx"))
    servers = {"slice": start_viewer(idx), "full": start_viewer(full)}
    try:
        def get(which, path, want=200):
            httpd, handler = servers[which]
            port = httpd.server_address[1]
            first = http_get(port, path)
            cached = len(handler._cache)
            again = http_get(port, path)
            if first[0] != want or again[:3] != first[:3]:
                raise AssertionError(f"view {which} {path}: status "
                                     f"{first[0]} (want {want}), repeat "
                                     f"{again[0]}: {first[2][-300:]!r}")
            if len(handler._cache) != cached:
                raise AssertionError(f"view {path}: the repeat was rendered "
                                     "again, not served from the cache")
            walls.append((which, path, first[3], again[3]))
            return first[2]

        if b"Pangenome" not in get("slice", "/"):
            raise AssertionError("view: the page lacks its tabs")
        meta = json.loads(get("slice", "/api/meta"))
        sizes = {}
        for a in ANCHORS:
            with open(os.path.join(work, "idx", "anchor", a, "chrs.tsv")) as f:
                f.readline()
                sizes[a] = {line.split("\t")[0]: int(line.split("\t")[2])
                            for line in f}
        if meta["anchors"] != list(ANCHORS) or meta["sizes"] != sizes \
                or meta["ngenomes"] != GENOMES:
            raise AssertionError(f"view /api/meta: {meta['anchors']} "
                                 f"{meta['sizes']}")
        s, e = 5_000, 6_000
        for step in (1, 100):
            body = get("slice", f"/api/bitdump?genome=g0&chrom=chr1&start={s}"
                       f"&end={e}&step={step}").decode().splitlines()
            rows = np.array([[int(x) for x in line.split("\t")]
                             for line in body[1:]])
            if body[0] != "\t" + "\t".join(f"g{g}" for g in range(GENOMES)) \
                    or not np.array_equal(rows[:, 0], np.arange(s, e, step)) \
                    or not np.array_equal(rows[:, 1:], g0_bits[s:e:step]) \
                    or not np.array_equal(rows[:, 1:], g0_oracle[s:e:step]):
                raise AssertionError(f"view /api/bitdump at step {step} "
                                     "differs from bitmap.1.gz or the oracle")
        genes = full.query_genes("g0")
        col = {c: i for i, c in enumerate(genes.columns)}
        want = [{"chrom": r[col["chr"]], "start": r[col["start"]],
                 "end": r[col["end"]], "name": r[col["name"]],
                 "unique": r[col[1]], "universal": r[col[GENOMES + 1]]}
                for r in genes.values]
        for q in ("", "g12"):
            got = json.loads(get("full", "/api/genes?genome=g0"
                                 + (f"&q={q}" if q else "")))
            sub = [w for w in want if q.upper() in w["name"].upper()]
            if got != sub or not sub:
                raise AssertionError(f"view /api/genes q={q!r}: {len(got)} "
                                     f"genes, query_genes {len(sub)}")
        print(f"view: /, /api/meta, /api/bitdump (steps 1, 100) equal "
              f"chrs.tsv, bitmap.1.gz and the oracle; /api/genes equals "
              f"query_genes ({len(want)} genes; q=g12 {len(sub)})",
              flush=True)

        w0 = "start=1000000&end=1030000"
        figures = [("slice", p) for p in (
            "/plot/pangenome/composition.png", "/plot/pangenome/dendrogram.png",
            "/plot/pangenome/sizes.png", "/plot/pangenome/chr_hist.png",
            "/plot/anchor/g0/whole.png", "/api/map/anchor/g0",
            "/plot/anchor/g0/umap.png", "/plot/anchor/g0/genes.png",
            f"/plot/chrom/g0/chr1/whole.png?{w0}",
            f"/api/map/chrom/g0/chr1?{w0}", "/plot/chrom/g0/chr1/umap.png",
            f"/plot/chrom/g0/chr1/view.png?{w0}", f"/api/view/g0/chr1?{w0}",
            "/api/view/g0/chr1")] + [("full", p) for p in (
                "/plot/chrom/g1/chr1/view.png?start=0&end=30000",
                "/api/view/g1/chr1?start=0&end=30000&types=exon",
                "/plot/anchor/g1/genes.png")]
        if mpl is None:
            for which, path in figures:
                body = get(which, path, want=500)
                if b"matplotlib" not in body:
                    raise AssertionError(f"view {path} without matplotlib: "
                                         f"{body[-300:]!r}")
            print(f"view: {len(figures)} figure routes answer 500 naming "
                  "matplotlib", flush=True)
        else:
            for which, path in figures:
                body = get(which, path)
                if "/api/" not in path:
                    if body[:8] != b"\x89PNG\r\n\x1a\n":
                        raise AssertionError(f"view {path}: not a PNG")
                    continue
                m = json.loads(body)
                for r in m["rows"]:
                    if not (0 <= r["px0"] < r["px1"] <= m["w"]
                            and 0 <= r["py0"] < r["py1"] <= m["h"]):
                        raise AssertionError(f"view {path}: map row {r} "
                                             "outside the image")
            tree = json.loads(get("slice", f"/api/view/g0/chr1?{w0}"))["tree"]
            m = json.loads(get("slice", f"/api/view/g0/chr1?{w0}&collapse="
                               f"{tree['id']}"))
            if m["labels"] != [f"[{GENOMES} genomes]"]:
                raise AssertionError(f"view collapse: labels {m['labels']}")
            print(f"view: {len(figures)} figure routes render (PNG "
                  "signatures, maps inside the images); collapsing the root "
                  "leaves one row", flush=True)
    finally:
        for httpd, _ in servers.values():
            httpd.shutdown()
            httpd.server_close()
        idx.close()
        full.close()
    print(f"view walls [{card}] (s, first request / the same again):",
          flush=True)
    for which, path, first, again in walls:
        print(f"  {which:5s} {path:58s} {first:.4f} / {again:.4f}",
              flush=True)


INTROS_BP, INTROS_K, INTROS_BIN, INTROS_STEP = 2_000_000, 21, 20_000, 100
INTROS_GENOMES = ["Reference", "WildRelative", "OffspringGen1",
                  "OffspringGen2", "OffspringGen3"]


def intros_config(work: str, name: str, calling: str, sweep=False) -> str:
    """An introgression config as a user writes it (flow and block lists,
    comments, ~), run on the intros phase's index."""
    d = os.path.join(work, "intros")
    path = os.path.join(d, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(f"""# introgression calls, {name}
general:
  output_dir: {d}/{name}
  index_dir: {d}/idx
  tsv: {d}/group.tsv
  bin: {INTROS_BIN}
  ref: Reference
  threads: {4 if sweep else 1}
calling:
  run: true
  grp: [OFFSPRING]
  stp: {INTROS_STEP}
  gnm: ~
  trm: 3
  ssz: 2
  rmf: true      # drop the k-mers every genome holds
  rmu: null
  ogrp: ~
  edg: false
  vis: false
{calling}postprocessing:
  run: true
  act:
    - fgap
    - rmbn
  min: 2
  gap: 1
scoring:
  run: true
  gdt: {d}/sim
  act: ~
  min: 1
  gap: 1
  thr: 0.25
  cmp: [WT]
  vis: false
""")
    return path


def intros_phase(work: str, card: str):
    """The port's introgression pipeline end to end through its CLI: a
    random INTROS_BP reference (seed 0) and ``intros simulate`` (4
    introgressions of 100-200 kbp, 2 rounds, seed 7) give the reference,
    its wild relative and three offspring generations; ``index`` builds
    them on the card at k=INTROS_K (pack_mix, probe_sorted, masks_to_bytes
    and fused_popcount_colsums must launch), ``intros bed2txt`` bins the
    truth at INTROS_BIN; a 2-way config (cmp [REF], urf, rmf, mean
    smoothing), a 3-way one (cmp [WT]) and the 2-way one with --sweep (18
    thresholds, 4 threads) run through ``intros``.  The 2-way calls must
    reach recall >= 0.9 and precision >= 0.85 against the simulated truth,
    the 3-way ones recall >= 0.9 (tests/test_intros.py's bars); the
    heatmap sub-tool must write its SVG, or, without matplotlib, raise
    naming it.  Prints the walls of simulate, the build, bed2txt and, per
    config, calling, postprocess and score.  Cuts: one chromosome of
    INTROS_BP (the simulator's defaults hold 3-7 Mbp introgressions on whole
    plant chromosomes), 3 offspring generations, vis false (the card's
    machine has no matplotlib)."""
    from panagram_tpu_torch.__main__ import main
    from panagram_tpu_torch.index import _read_table
    from panagram_tpu_torch.intros import runner
    from panagram_tpu_torch.ops import kernels

    d = os.path.join(work, "intros")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    write_fasta(os.path.join(d, "ref.fasta"), "chr1",
                rng.integers(0, 4, INTROS_BP, dtype=np.uint8))
    walls = {}
    t0 = time.perf_counter()
    main(["intros", "simulate", "--ref", os.path.join(d, "ref.fasta"),
          "--out-folder", os.path.join(d, "sim"), "--num-introgressions", "4",
          "--introgression-size-min", "100000",
          "--introgression-size-max", "200000",
          "--rel-sub-rate", "0.02", "--rel-ins-rate", "1e-5",
          "--rel-del-rate", "1e-5", "--rel-ins-size-min", "1",
          "--rel-ins-size-max", "50", "--rel-del-size-min", "1",
          "--rel-del-size-max", "50", "--mut-sub-rate", "5e-4",
          "--mut-ins-rate", "1e-6", "--mut-del-rate", "1e-6",
          "--mut-ins-size-min", "1", "--mut-ins-size-max", "20",
          "--mut-del-size-min", "1", "--mut-del-size-max", "20",
          "--rounds", "2", "--seed", "7"])
    walls["simulate"] = time.perf_counter() - t0
    sim = os.path.join(d, "sim")
    fastas = [os.path.join(d, "ref.fasta")] + [os.path.join(sim, f) for f in (
        "ref_wildrelative.fasta", "ref_0_offspring.fasta",
        "ref_1_offspring.fasta", "ref_2_offspring.fasta")]
    with open(os.path.join(d, "samples.tsv"), "w") as f:
        f.write("name\tfasta\n" + "".join(
            f"{n}\t{p}\n" for n, p in zip(INTROS_GENOMES, fastas)))
    with open(os.path.join(d, "group.tsv"), "w") as f:
        f.write("name\tgroup\nReference\tREF\nWildRelative\tWT\n"
                + "".join(f"OffspringGen{i}\tOFFSPRING\n" for i in (1, 2, 3)))
    kernels.reset_launches()
    t0 = time.perf_counter()
    main(["index", os.path.join(d, "samples.tsv"), "-o",
          os.path.join(d, "idx"), "-k", str(INTROS_K)])
    torch.cuda.synchronize()
    walls["index build"] = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ANCHOR_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"intros: {name} was not launched by the "
                                 "build")
    t0 = time.perf_counter()
    main(["intros", "bed2txt", "--gt_bed_file",
          os.path.join(sim, "ref_0_introgressions.bed"), "--index_dir",
          os.path.join(d, "idx"), "--ref", "Reference", "--wild_type",
          "WildRelative", "--wild_type_group", "WT", "--bin_size",
          str(INTROS_BIN)])
    walls["bed2txt"] = time.perf_counter() - t0
    with open(os.path.join(sim, "ref_0_introgressions.bed")) as f:
        truth = [line.split("\t") for line in f]
    print(f"intros: simulated {len(truth)} introgressions of "
          f"{[int(r[2]) - int(r[1]) for r in truth]} bp; index build "
          f"launches {launches}", flush=True)

    # per-stage walls of the runner, summed over its threads
    stage_s: dict = {}
    real = {n: getattr(runner, n) for n in
            ("call_introgressions", "postprocess", "score")}

    def timed(name):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                stage_s[name] = stage_s.get(name, 0.0) + \
                    time.perf_counter() - t
        return run

    configs = [
        ("2way", "  cmp: [REF]\n  thr: [0.8]\n  sft: mean\n  urf: true\n",
         False, "REF", 0.85),
        ("3way", "  cmp:\n  - WT\n  thr: [0.2]\n  sft: ~\n  urf: false\n",
         False, "WT", None),
        ("sweep", "  cmp: [REF]\n  thr: [0.8]\n  sft: mean\n  urf: true\n",
         True, "REF", None),
    ]
    for name in real:
        setattr(runner, name, timed(name))
    try:
        for name, calling, sweep, itype, min_prec in configs:
            path = intros_config(work, name, calling, sweep)
            stage_s.clear()
            t0 = time.perf_counter()
            main(["intros", path] + (["--sweep"] if sweep else []))
            walls[f"{name}: command"] = time.perf_counter() - t0
            for stage, v in stage_s.items():
                walls[f"{name}: {stage}"] = v
            thr = "0.8" if name != "3way" else "0.2"
            t = _read_table(os.path.join(
                d, name, f"{name}_{thr}", "scored", f"metrics_{itype}.tsv"),
                "\t", "")
            m = dict(zip(t.columns, t.values[0]))
            print(f"intros {name} at {thr}: recall {m['Recall']:.4f}, "
                  f"precision {m['Precision']:.4f}, TP {int(m['True Positive'])}"
                  f", FP {int(m['False Positive'])}, FN "
                  f"{int(m['False Negative'])}", flush=True)
            if not m["Recall"] >= 0.9 or (min_prec and
                                          not m["Precision"] >= min_prec):
                raise AssertionError(f"intros {name}: recall {m['Recall']}, "
                                     f"precision {m['Precision']}")
            if sweep:
                n = sum(os.path.isfile(os.path.join(
                    d, name, f"{name}_{t_}", "scored", "metrics_REF.tsv"))
                    for t_ in runner.SWEEP_2WAY)
                if n != len(runner.SWEEP_2WAY):
                    raise AssertionError(f"intros sweep: {n} thresholds "
                                         "scored")
    finally:
        for name, fn in real.items():
            setattr(runner, name, fn)
    t0 = time.perf_counter()
    try:
        main(["intros", "heatmap", "--index-dir", os.path.join(d, "idx"),
              "--anchor", "OffspringGen1", "--bin", str(INTROS_BIN),
              "--groups", os.path.join(d, "group.tsv"), "--out",
              os.path.join(d, "heatmaps")])
        if not os.path.isfile(os.path.join(d, "heatmaps",
                                           "OffspringGen1_chr1_heatmap.svg")):
            raise AssertionError("intros heatmap: no SVG")
        heat = "wrote its SVG"
    except ImportError as e:
        if "matplotlib" not in str(e):
            raise
        heat = f"raised without matplotlib: {e}"
    walls["heatmap"] = time.perf_counter() - t0
    print(f"intros: the heatmap sub-tool {heat}", flush=True)
    print(f"intros walls [{card}] (s):", flush=True)
    for k, v in walls.items():
        print(f"  {k:28s} {v:.3f}", flush=True)


# the kernels of each mesh strategy's path: every rank packs its codes on
# its device (pack_bases); the range strategy's local probe is a row gather
# at the low-bit bucket (panagram_tpu's _local_probe is an XLA gather), so
# probe_sorted runs only in the genome strategy
MESH_KERNELS = {"range": ["pack_bases", "pack_mix",
                          "fused_popcount_colsums", "masks_to_bytes"],
                "genomes": STREAM_KERNELS}
# the phases a mesh rank's anchor log line names, in order
MESH_PHASES = ["encode", "pack", "wait", "write", "bins", "finish"]


def mesh_phase(work: str, card: str, dev, slice_peak: int) -> dict:
    """The slice's genomes through --mesh 1 (one rank on NCCL) under both
    strategies and through the two-process --num-processes 2 build on the
    one card; each tree must equal the default build's (the range build's
    pandict.npz is its dictionary mixed), each rank of a mesh build must
    launch each kernel of its path once per chunk and the others never
    (its own counts, sent back by parallel.mesh.launch), and --mesh 2 must
    raise naming the card count.  Prints each rank's peak device memory
    beside the one-device build's (slice_peak).  Returns the launches of
    each mesh build."""
    from panagram_tpu_torch.ops.dictionary import PanKmerDict
    from panagram_tpu_torch.ops.lookup import mix64_np
    from panagram_tpu_torch.pipeline import build_index

    ref = os.path.join(work, "idx")
    samples = os.path.join(work, "samples.tsv")
    args = ["index", samples, "-k", str(K), "--anchor-genomes", *ANCHORS,
            "--device", dev.type]
    chunks = len(ANCHORS) * -(-(GENOME_BP - K + 1) // CHUNK)
    out = {}
    for strategy in ("range", "genomes"):
        prefix = os.path.join(work, f"idx_mesh_{strategy}")
        t0 = time.perf_counter()
        idx = build_index(samples, prefix=prefix, k=K,
                          anchor_genomes=list(ANCHORS),
                          device=dev.type, mesh_devices=1,
                          mesh_strategy=strategy)
        wall = time.perf_counter() - t0
        (rank,) = idx.mesh_ranks
        launches = out[strategy] = rank.launches
        print(f"index --mesh 1 --mesh-strategy {strategy}: {wall:.2f} s "
              f"wall (one spawned rank), rank 0 launches {launches}",
              flush=True)
        for name in STREAM_KERNELS:
            want = chunks if name in MESH_KERNELS[strategy] else 0
            if launches[name] != want:
                raise AssertionError(
                    f"--mesh 1 {strategy}: kernel {name} launched "
                    f"{launches[name]} times, not {want} ({chunks} chunks)")
        print(f"  each kernel of the path launched once per chunk ({chunks})"
              f"; peak device memory [{card}]: rank 0 "
              f"{rank.peak_bytes / 2**30:.3f} GiB (to the end of its dict "
              f"stage {rank.value['dict_peak_bytes'] / 2**30:.3f} GiB), the "
              f"one-device build {slice_peak / 2**30:.3f} GiB", flush=True)
        skip = ("config.yaml", "pandict.npz") if strategy == "range" \
            else ("config.yaml",)
        n = same_trees(prefix, ref, f"--mesh 1 {strategy} and the default "
                       "build", skip)
        print(f"  tree equals the default build's ({n} files)", flush=True)
        walls = stage_walls(prefix)
        print(f"  stage walls [{card}]: "
              + " ".join(f"{st}={walls[st]:.3f}s" for st in
                         ["dict"] + [f"anchor.{a}" for a in ANCHORS]),
              flush=True)
        for a, ph in anchor_phases(prefix, ANCHORS).items():
            # the mesh route times the host's staging and keeps no
            # copy-back apart: its line names no phase nobody timed
            if list(ph) != MESH_PHASES or not ph["pack"] > 0:
                raise AssertionError(f"--mesh 1 {strategy} {a}: anchor "
                                     f"phases {ph}, not {MESH_PHASES} with "
                                     "pack above 0")
    want = PanKmerDict.load(os.path.join(ref, "kmc", "pandict.npz"))
    got = PanKmerDict.load(os.path.join(work, "idx_mesh_range", "kmc",
                                        "pandict.npz"))
    mixed = mix64_np(want.keys)
    order = np.argsort(mixed)
    if got.key_space != "mixed" or not np.array_equal(got.keys, mixed[order]) \
            or not np.array_equal(got.masks, want.masks[order]):
        raise AssertionError("--mesh 1 range pandict.npz is not the default "
                             "dictionary in mixed space")
    print(f"  range pandict.npz: the default {len(want)} keys, mixed and in "
          "unsigned order", flush=True)

    prefix = os.path.join(work, "idx_2proc")
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "panagram_tpu_torch", *args, "--prefix", prefix,
         "--num-processes", "2", "--process-id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("--num-processes 2: "
                             + " | ".join(e[-2000:] for e in errs))
    n = same_trees(prefix, ref, "--num-processes 2 and the default build")
    print(f"index --num-processes 2 (two processes, one card): {wall:.2f} s "
          f"wall; tree equals the default build's ({n} files)", flush=True)

    visible = torch.cuda.device_count()
    try:
        build_index(samples, prefix=os.path.join(work, "idx_mesh_over"), k=K,
                    device="cuda", mesh_devices=visible + 1)
    except RuntimeError as e:
        if f"{visible} are visible" not in str(e):
            raise
        print(f"--mesh {visible + 1} on {visible} card(s) raises: {e}",
              flush=True)
    else:
        raise AssertionError(f"--mesh {visible + 1} on {visible} card(s) "
                             "did not raise")
    return out


# tools/bigdict_mesh.py through the port's tool, run(genomes, mbp, devices,
# anchor_mbp, k): (a) the JAX tool's full size on one NCCL rank, which holds
# the whole range-sharded dictionary; (b) the mid-size leg on 8 Gloo ranks
BIGDICT_MESH_FULL = (4, 26.0, 1, 2.0, 21)
BIGDICT_MESH_MID = (4, 0.26, 8, 2.0, 21)
# the union of the JAX tool's genomes (default_rng(11); ROUND5_NOTES.md)
BIGDICT_MESH_KEYS = 103_997_462


def bigdict_mesh_phase(card: str):
    """tools/bigdict_mesh.py through the port's tool
    (panagram_tpu_torch/tools/bigdict_mesh.run), which raises unless its
    host dictionary equals the host merge oracle and its anchored bytes,
    popcounts and column sums the numpy oracle's.  (a) BIGDICT_MESH_FULL on
    one NCCL rank: D must be the host's exact count and BIGDICT_MESH_KEYS,
    the anchored rows agree among themselves, the rank launch each kernel
    of the range path (MESH_KERNELS) once per anchor chunk and probe_sorted
    never, and its peak device memory stay within what the build's budget
    checks counted (the routing, the merge and the layout).
    (b) BIGDICT_MESH_MID on 8 Gloo ranks: the same parity, no launch.  (c)
    more ranks than cards on cuda must raise naming the card count before
    any work.  Prints the walls, the geometry and the peak."""
    from panagram_tpu_torch.tools import bigdict_mesh as BM

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    for label, args, device in (("(a)", BIGDICT_MESH_FULL, "cuda"),
                                ("(b)", BIGDICT_MESH_MID, "cpu")):
        genomes, mbp, devices, anchor_mbp, k = args
        where = card if device == "cuda" else "Gloo ranks on the host's CPU"
        print(f"bigdict_mesh {label} [{where}]: bigdict_mesh.run{args} "
              f"device={device!r}", flush=True)
        r, parent, wall = _launched(lambda: BM.run(*args, device=device))
        if parent:
            raise AssertionError(f"bigdict_mesh {label}: the parent launched "
                                 f"{parent}; only the ranks may")
        if r.D != r.host_D or (label == "(a)" and r.D != BIGDICT_MESH_KEYS):
            raise AssertionError(f"bigdict_mesh {label}: D {r.D}, the host's "
                                 f"exact count {r.host_D}, the JAX tool's "
                                 f"{BIGDICT_MESH_KEYS}")
        bits = np.unpackbits(r.bytes, axis=1, bitorder="little")[:, :genomes]
        if r.bytes.shape != (r.nk, r.nbytes) or r.nk != min(
                int(anchor_mbp * 1e6), int(mbp * 1e6) - k + 1) \
                or not np.array_equal(r.popc, bits.sum(axis=1)) \
                or not np.array_equal(r.colsums, bits.sum(axis=0)):
            raise AssertionError(f"bigdict_mesh {label}: the anchored bytes, "
                                 "popcounts and column sums disagree")
        chunks = -(-r.nk // (devices * BM.CHUNK_PER_DEV))
        for rank, launches in enumerate(r.launches):
            want = {n: chunks if device == "cuda" and n in
                    MESH_KERNELS["range"] else 0 for n in STREAM_KERNELS}
            got = {n: launches[n] for n in STREAM_KERNELS}
            if got != want:
                raise AssertionError(f"bigdict_mesh {label}: rank {rank} "
                                     f"launched {got}, not {want}")
        print(f"  D = {r.D:,} (the host's exact count" + (
              f", the JAX tool's {BIGDICT_MESH_KEYS:,}" if label == "(a)"
              else "") + "); dictionary and "
              f"anchor equal the oracles; shard [2^{r.nbits} x {r.stride} "
              f"u32] = {r.shard_bytes / 2**30:.3f} GiB x {r.n_shards}, cap "
              f"{r.cap}", flush=True)
        print(f"  walls: sets {r.walls['sets']:.3f} s, build "
              f"{r.walls['build']:.3f} s, anchor {r.walls['anchor']:.3f} s "
              f"({r.nk} positions, {chunks} chunk(s)), oracle "
              f"{r.walls['oracle']:.3f} s, ranks {r.walls['launch']:.3f} s, "
              f"run {wall:.3f} s; rank 0 launches {r.launches[0]}",
              flush=True)
        if device == "cuda":
            (peak, _), checked = r.peaks[0], r.checked_bytes[0]
            print(f"  rank 0 peak device memory [{card}]: {peak / 2**30:.3f} "
                  f"GiB; the build's budget checks counted "
                  f"{checked / 2**30:.3f} GiB (share {peak / checked:.3f})",
                  flush=True)
            if not r.budget_checked or not 0 < peak <= checked:
                raise AssertionError(f"bigdict_mesh {label}: peak {peak} B "
                                     f"beyond the checks' {checked} B")
        else:
            print("  rank peaks (host peak RSS, GiB): " + ", ".join(
                "not measured" if b is None else f"{b / 2**30:.3f}"
                for b, _ in r.peaks), flush=True)
        del r

    visible = torch.cuda.device_count()
    over = (BIGDICT_MESH_FULL[0], BIGDICT_MESH_FULL[1], max(8, visible + 1))
    t0 = time.perf_counter()
    try:
        BM.run(*over, device="cuda")
    except RuntimeError as e:
        if f"{visible} are visible" not in str(e):
            raise
        print(f"bigdict_mesh (c): run{over} on {visible} card(s) raises "
              f"in {time.perf_counter() - t0:.3f} s: {e}", flush=True)
    else:
        raise AssertionError(f"bigdict_mesh: {over[2]} ranks on "
                             f"{visible} card(s) did not raise")
    print(f"bigdict_mesh phase wall: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


API_THREADS = 4           # api phase: the host anchorer's first thread count


def _run_script(main, argv) -> tuple[str, float]:
    """(stdout, wall seconds) of a script's main(argv) in process."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue(), time.perf_counter() - t0


def _launched(fn):
    """(fn()'s result, the kernel launches it made, its wall seconds): the
    counts set to 0 just before and read after the card finished."""
    from panagram_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {n: c for n, c in kernels.launches.items() if c}, \
        time.perf_counter() - t0


def panagram_tpu_calls(card: str, seqs: dict, pan, bd, codes, canon, keys,
                       masks, rows, chunk, bitmap, chunk_ms: float,
                       timer: str) -> np.ndarray:
    """Calls written for panagram_tpu, on the card: its merge probe
    bucket_query_sorted (one probe_sorted launch) against its gather probe,
    anchor_lookup's rows and the oracle; anchor_chunk_fast against the
    stream's bitmap; its sorted-dictionary anchor_chunk(codes, keys,
    masks, k); and positional calls of the signatures that follow
    panagram_tpu's order, each on the card by default.  Returns
    pairwise_shared(block)'s matrix, for the CPU's to check."""
    from panagram_tpu_torch.ops import anchor, count, lookup
    from panagram_tpu_torch.ops.devdict import DeviceDictBuilder
    from panagram_tpu_torch.ops.ref_impl import anchor_np

    N, P = pan.ngenomes, canon.shape[0]
    oracle = anchor_np(codes[:ORACLE_POSITIONS + K - 1], K, pan.keys,
                       pan.masks)
    walls = {}
    q, launched, walls["bucket_query_sorted"] = _launched(
        lambda: lookup.bucket_query_sorted(canon, bd.table, bd.nbits, bd.cap,
                                           bd.nwords))
    if launched != {"probe_sorted": 1}:
        raise AssertionError(f"bucket_query_sorted launched {launched}, "
                             "want probe_sorted once")
    gather, _, walls["bucket_query"] = _launched(
        lambda: lookup.bucket_query(canon, bd.table, bd.nbits, bd.cap,
                                    bd.nwords))
    fast, launched, walls["anchor_chunk_fast"] = _launched(chunk)
    if launched != {n: 1 for n in ANCHOR_KERNELS}:
        raise AssertionError(f"anchor_chunk_fast launched {launched}, want "
                             "each anchor kernel once")
    if not (torch.equal(q, gather) and torch.equal(q, rows)
            and np.array_equal(q[:ORACLE_POSITIONS].cpu().numpy().view(
                np.uint32), oracle)):
        raise AssertionError("bucket_query_sorted's rows differ from "
                             "bucket_query's, anchor_lookup's or the oracle's")
    if not (np.array_equal(fast[0].cpu().numpy(), bitmap[:P])
            and torch.equal(fast[0], lookup.kernels.masks_to_bytes(
                q, bitmap.shape[1]))
            and torch.equal(fast[1], lookup.kernels.fused_popcount_colsums(
                q, 0)[0])):
        raise AssertionError("anchor_chunk_fast differs from the stream's "
                             "bitmap.1.gz or from the merge probe's rows")
    if host_syncs(chunk):
        raise AssertionError("anchor_chunk_fast made the host wait for the "
                             "card (torch's sync debug mode raised)")
    codes_t = torch.from_numpy(codes).to(canon.device)
    (crows, cpopc), launched, walls["anchor_chunk"] = _launched(
        lambda: anchor.anchor_chunk(codes_t, keys, masks, K))
    if launched != {"fused_popcount_colsums": 1} or not (
            torch.equal(crows, rows) and torch.equal(cpopc, fast[1])
            and np.array_equal(crows[:ORACLE_POSITIONS].cpu().numpy().view(
                np.uint32), oracle)):
        raise AssertionError(f"anchor_chunk(codes, keys, masks, k): launches "
                             f"{launched}, or its rows differ from the "
                             "oracle's")
    sorted_ms = warm_ms(lambda: lookup.bucket_query_sorted(
        canon, bd.table, bd.nbits, bd.cap, bd.nwords), launches=20)
    print(f"  panagram_tpu's calls [{card}]: bucket_query_sorted (probe_sorted "
          f"x1) = bucket_query = anchor_lookup = the oracle; "
          f"anchor_chunk_fast (each anchor kernel x1) = bitmap.1.gz, no host "
          f"synchronisation; "
          f"anchor_chunk(codes, keys, masks, k) = the oracle "
          f"(fused_popcount_colsums x1).  Warm per {P} queries: "
          f"bucket_query_sorted {sorted_ms:.4f} ms, anchor_chunk_fast "
          f"{chunk_ms:.4f} ms ({timer}); one call's wall s: " + ", ".join(
              f"{n} {w:.4f}" for n, w in walls.items()), flush=True)
    del q, gather, fast, crows, cpopc, codes_t
    walls = {}

    # positional calls in panagram_tpu's form; each runs on the card
    parts = [codes[:300_000], codes[100_000:400_000], codes[200_000:500_000]]

    def on_card(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, _, wall = _launched(fn)
        if torch.cuda.max_memory_allocated() <= base:
            raise AssertionError("the call allocated nothing on the card")
        return out, wall

    got, walls["counted_kmers_chunked(codes, k, 3)"] = on_card(
        lambda: count.counted_kmers_chunked(iter(parts), K, 3))
    want = count.counted_kmers_chunked(iter(parts), K, 3, device="cpu")
    twice = count.counted_kmers_chunked(iter(parts), K, 2, device="cpu")
    if not (np.array_equal(got, want) and 0 < len(want) < len(twice)):
        raise AssertionError("counted_kmers_chunked(codes, k, 3) is not the "
                             "min-count 3 set")
    got, walls["distinct_kmers_chunked(codes, k, chunk)"] = on_card(
        lambda: count.distinct_kmers_chunked(iter(parts), K, 1 << 18))
    if not np.array_equal(got, count.distinct_kmers_chunked(
            iter(parts), K, 1 << 18, device="cpu")):
        raise AssertionError("distinct_kmers_chunked(codes, k, chunk) "
                             "differs from the CPU's")
    shared, walls["pairwise_shared(block)"] = on_card(
        lambda: pan.pairwise_shared(1 << 20))

    def devdict(**device):
        b = DeviceDictBuilder(K, 2, 1 << 20, None, **device)
        for gid, g in enumerate(("g0", "g1")):
            b.add_sequence(gid, seqs[g][:1_000_000])
        return b.to_host()

    got, walls["DeviceDictBuilder(k, ngenomes, chunk, capacity_hint)"] = \
        on_card(devdict)
    want = devdict(device="cpu")
    if not (np.array_equal(got.keys, want.keys)
            and np.array_equal(got.masks, want.masks)):
        raise AssertionError("DeviceDictBuilder on the card differs from the "
                             "CPU's")
    print(f"  positional calls in panagram_tpu's form, on the card by default "
          f"(BucketedDict.build_device(keys, masks, ngenomes, k, mixed, "
          f"count, min_nbits, sorted_input) laid out the table above), wall "
          f"s [{card}]: " + ", ".join(f"{n} {w:.4f}" for n, w in walls.items()),
          flush=True)
    return shared


def api_phase(work: str, seqs: dict, card: str, dev):
    """The public Python API and the user scripts on the slice's index: the
    package exports, ops.anchor_lookup on the slice's dictionary against the
    chunk's route and the oracle, the popcount ops and masks_to_bytes of
    whole rows against their plain versions (kernel launches counted from 0
    around them), occupancy_histogram against the CPU, the host anchorer
    on g0 against its bitmap, and the six scripts in process (one also
    through python -m)."""
    import panagram_tpu_torch
    from panagram_tpu_torch import io as port_io
    from panagram_tpu_torch import ops, parallel
    from panagram_tpu_torch.io.bgzf import decompress_file
    from panagram_tpu_torch.native.anchor_cpu import CpuAnchorer
    from panagram_tpu_torch.ops import anchor, kernels
    from panagram_tpu_torch.ops.codec import from_u64_np, pack_bases_np
    from panagram_tpu_torch.ops.dictionary import PanKmerDict
    from panagram_tpu_torch.ops.lookup import BucketedDict
    from panagram_tpu_torch.ops.ref_impl import anchor_np
    from panagram_tpu_torch.scripts import (
        make_bins_bits,
        pairwise_comp,
        pairwise_matrix,
        plot_umaps,
        query_index,
        write_umaps,
    )

    prefix = os.path.join(work, "idx")
    for pkg in (panagram_tpu_torch, ops, port_io, parallel):
        for name in pkg.__all__:
            getattr(pkg, name)
    t0 = time.perf_counter()
    idx = panagram_tpu_torch.Index(prefix)
    opened = time.perf_counter() - t0
    if list(idx.anchor_genomes) != list(ANCHORS) or idx.ngenomes != GENOMES:
        raise AssertionError(f"Index({prefix!r}): {idx.anchor_genomes}")
    idx.close()
    print(f"api phase [{card}]: every exported name resolves; "
          f"panagram_tpu_torch.Index(prefix) opened in {opened:.4f} s",
          flush=True)

    N, nbytes = GENOMES, (GENOMES + 7) // 8
    pan = PanKmerDict.load(os.path.join(prefix, "kmc", "pandict.npz"))
    if pan.key_space != "canon":
        raise AssertionError(f"pandict.npz key space {pan.key_space}")
    keys = from_u64_np(pan.keys, dev)
    masks = torch.from_numpy(pan.masks.view(np.int32)).to(dev)
    codes = seqs["g0"][:CHUNK + K - 1]
    canon, _ = ops.pack_kmers(torch.from_numpy(codes).to(dev), K)
    P = canon.shape[0]
    binlen, nbins = 100_000, -(-P // 100_000)
    torch.cuda.synchronize()
    kernels.reset_launches()
    rows = ops.anchor_lookup(canon, keys, masks)
    popc = ops.mask_popcount(rows)
    sums = ops.genome_column_sums(rows, N)
    by = ops.masks_to_bytes(rows)
    hist = ops.occupancy_histogram(popc, binlen, nbins, N)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    want = {"fused_popcount_colsums": 2, "masks_to_bytes": 1}
    if launches != {n: want.get(n, 0) for n in launches}:
        raise AssertionError(f"api ops launched {launches}, want {want}")
    print(f"  ops on g0's first {P} positions ({len(pan)} keys, W="
          f"{pan.nwords}): launches {launches}", flush=True)

    # panagram_tpu's positional form: (keys, masks, ngenomes, k, mixed,
    # count, min_nbits, sorted_input); the table goes to the card by default
    bd = BucketedDict.build_device(pan.keys, pan.masks, N, K, False, None, 2,
                                   False)
    if bd.table.device.type != "cuda":
        raise AssertionError(f"build_device laid out on {bd.table.device}")
    packed, nmask, L = pack_bases_np(codes)
    packed, nmask = torch.from_numpy(packed).to(dev), torch.from_numpy(nmask).to(dev)

    def chunk():
        return anchor.anchor_chunk_fast(packed, nmask, bd.table, L, K,
                                        bd.nbits, bd.cap, bd.nwords, nbytes)

    cby, cpopc, ccols = chunk()
    if not (torch.equal(by[:, :nbytes], cby)
            and torch.equal(popc, cpopc)
            and torch.equal(sums, ccols[:N])
            and ccols.dtype == torch.int64
            and not bool((by[:, nbytes:] != 0).any())):
        raise AssertionError("anchor_lookup's rows differ from "
                             "anchor_chunk_fast's")
    oracle = anchor_np(codes[:ORACLE_POSITIONS + K - 1], K, pan.keys,
                       pan.masks)
    if not np.array_equal(rows[:ORACLE_POSITIONS].cpu().numpy().view(
            np.uint32), oracle):
        raise AssertionError("anchor_lookup differs from the numpy oracle")
    plain_popc, plain_sums = kernels.fused_popcount_colsums_plain(rows, N)
    checks = {
        "mask_popcount": torch.equal(popc, plain_popc),
        "genome_column_sums": torch.equal(sums, plain_sums.to(torch.int64)),
        "masks_to_bytes": torch.equal(
            by, kernels.masks_to_bytes_plain(rows, 4 * pan.nwords)),
        "occupancy_histogram": torch.equal(hist.cpu(), ops.occupancy_histogram(
            popc.cpu(), binlen, nbins, N)),
    }
    if not all(checks.values()):
        raise AssertionError(f"api ops against their plain versions: {checks}")
    lookup_ms = warm_ms(lambda: ops.anchor_lookup(canon, keys, masks))
    if host_syncs(chunk):
        # where the chunk waits for the card: the op that raises under
        # torch's sync debug mode
        torch.cuda.set_sync_debug_mode("error")
        try:
            chunk()
        except RuntimeError:
            print("  anchor_chunk_fast syncs here:\n" + "\n".join(
                traceback.format_exc().strip().splitlines()[-8:]), flush=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        free, total = torch.cuda.mem_get_info()
        print(f"  device memory: {free / 2**30:.3f} of {total / 2**30:.3f} "
              f"GiB free, {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
              "reserved by torch", flush=True)
        chunk_ms, timer = one_call_ms(chunk), "one call between events"
    else:
        # 20 calls, as chunk_times queues: 50 chunks' ~1,250 launches
        # overflow the stream's queue behind the blocker
        chunk_ms, timer = warm_ms(chunk, launches=20), "warm"
    print(f"  anchor_lookup rows = anchor_chunk_fast's and the oracle's "
          f"(first {ORACLE_POSITIONS}); {', '.join(checks)} = their plain "
          f"versions [{card}]: anchor_lookup {lookup_ms:.4f} ms warm per {P} "
          f"positions (searchsorted over {len(pan)} keys), anchor_chunk_fast "
          f"{chunk_ms:.4f} ms ({timer}) on the same chunk", flush=True)

    real_probe(f"the slice's g0 first chunk (W={bd.nwords})", packed, nmask,
               L, K, CHUNK, bd, card)
    d0 = os.path.join(prefix, "anchor", "g0")
    bitmap = np.frombuffer(decompress_file(os.path.join(d0, "bitmap.1.gz")),
                           np.uint8).reshape(-1, nbytes)
    positional_shared = panagram_tpu_calls(
        card, seqs, pan, bd, codes, canon, keys, masks, rows, chunk, bitmap,
        chunk_ms, timer)
    del rows, popc, sums, by, hist, cby, cpopc, ccols, bd, keys, masks, canon
    bitmap_popc = np.unpackbits(bitmap, axis=1, bitorder="little").sum(
        axis=1, dtype=np.int32)
    t0 = time.perf_counter()
    ca = CpuAnchorer(pan.keys, pan.masks)
    build_s = time.perf_counter() - t0
    cores = os.cpu_count()
    print(f"  CpuAnchorer [{card}; host of {cores} cores]: built over "
          f"{len(pan)} keys in {build_s:.3f} s", flush=True)
    for threads in (API_THREADS, cores):
        t0 = time.perf_counter()
        got_by, got_popc = ca.anchor(seqs["g0"], K, nbytes, threads=threads)
        secs = time.perf_counter() - t0
        if not (np.array_equal(got_by, bitmap)
                and np.array_equal(got_popc, bitmap_popc)):
            raise AssertionError(f"CpuAnchorer at {threads} threads differs "
                                 "from g0's bitmap.1.gz")
        print(f"    {threads} threads: g0 ({len(bitmap)} positions) in "
              f"{secs:.3f} s, {len(bitmap) / secs:.4g} k-mers/s, equal to "
              "bitmap.1.gz", flush=True)
    del ca, got_by, got_popc, bitmap

    walls = {}
    out, walls["query_index bit"] = _run_script(
        query_index.main, [prefix, "g0", "bit"])
    mean = float(out.split("occupancy mean:")[1])
    if not (out.startswith("chr1 occupancy mean: ")
            and abs(mean - bitmap_popc[::100].mean()) < 1e-9):
        raise AssertionError(f"query_index bit printed {out!r}")
    out, walls["make_bins_bits"] = _run_script(make_bins_bits.main,
                                               [prefix, "g0"])
    lines = out.splitlines()
    if len(lines) != 1 + -(-len(bitmap_popc) // 200_000) or int(
            lines[1].split("\t")[5]) != 2000:
        raise AssertionError(f"make_bins_bits printed {lines[:3]}")
    out, walls["pairwise_comp"] = _run_script(pairwise_comp.main,
                                              ["g0", prefix])
    if len(out.splitlines()) != N or not out.startswith(
            f"g0,{int((bitmap_popc[::100] > 0).sum())},100.0\n"):
        raise AssertionError(f"pairwise_comp printed {out[:200]!r}")
    out, walls["pairwise_matrix"] = _run_script(pairwise_matrix.main, [prefix])
    shared = np.array([[int(x) for x in line.split("\t")[1:]]
                       for line in out.splitlines()[1:]])
    cpu_shared = pan.pairwise_shared(device="cpu")
    if not np.array_equal(shared, cpu_shared):
        raise AssertionError("pairwise_matrix on the card differs from "
                             "pairwise_shared on the CPU")
    if not np.array_equal(positional_shared, cpu_shared):
        raise AssertionError("pairwise_shared(block) on the card differs "
                             "from pairwise_shared on the CPU")
    csvs = {f: open(os.path.join(d0, f), "rb").read()
            for f in ("chrom_umaps.csv", "genome_umap.csv")}
    out, walls["write_umaps"] = _run_script(write_umaps.main, [prefix, "g0"])
    if out != "embedding g0 ...\n" or any(
            open(os.path.join(d0, f), "rb").read() != b
            for f, b in csvs.items()):
        raise AssertionError("write_umaps did not rewrite g0's CSVs as the "
                             "build wrote them")
    plots = os.path.join(work, "umap_plots")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        t0 = time.perf_counter()
        try:
            _run_script(plot_umaps.main, [prefix, "g0", "ALL", "--out", plots])
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise
            walls["plot_umaps (to its raise)"] = time.perf_counter() - t0
            print(f"  plot_umaps: matplotlib absent, raises naming it: {e}",
                  flush=True)
        else:
            raise AssertionError("plot_umaps ran without matplotlib")
    else:
        out, walls["plot_umaps"] = _run_script(
            plot_umaps.main, [prefix, "g0", "ALL", "--out", plots])
        if len(os.listdir(plots)) != 3:
            raise AssertionError(f"plot_umaps wrote {os.listdir(plots)}")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "panagram_tpu_torch.scripts.make_bins_bits", prefix,
                          "g0"], stdout=subprocess.PIPE, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(
                             os.path.abspath(__file__))))
    walls["python -m make_bins_bits"] = time.perf_counter() - t0
    if res.returncode != 0 or res.stdout.splitlines() != lines:
        raise AssertionError("python -m panagram_tpu_torch.scripts."
                             "make_bins_bits differs from its run in process")
    print(f"  scripts on the slice's index, wall s [{card}]: " + ", ".join(
        f"{n} {w:.3f}" for n, w in walls.items()), flush=True)
    shell_wrappers(work, card, csvs)
    return launches


def shell_wrappers(work: str, card: str, csvs: dict):
    """preprocess.sh on the full-index phase's samples on the card (its
    default): every file of the CLI's --cores 1 tree must equal the
    wrapper's, but config.yaml (paths, cores, the anchor list) and
    samples.tsv's anchor column: the CLI anchored g0-g2
    (--anchor-genomes), the wrapper, as panagram_tpu's, every assembly.
    run_umaps.sh on the slice's index: g0's CSVs as the build wrote them,
    then plot_umaps, which without matplotlib must stop the script naming
    it."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    scripts = os.path.join(here, "panagram_tpu_torch", "scripts")
    cli, out = os.path.join(work, "idx_full_c1"), os.path.join(work, "idx_pre")
    # a `python` first on PATH that notes when each command starts
    shim = os.path.join(work, "shim")
    os.makedirs(shim)
    starts = os.path.join(work, "preprocess_starts.txt")
    with open(os.path.join(shim, "python"), "w") as f:
        f.write(f'#!/bin/sh\necho "$(date +%s.%N) $*" >> {starts}\n'
                f'exec {sys.executable} "$@"\n')
    os.chmod(os.path.join(shim, "python"), 0o755)
    t0, start = time.perf_counter(), time.time()
    res = subprocess.run(
        ["bash", os.path.join(scripts, "preprocess.sh"),
         os.path.join(work, "samples_full.tsv"), str(K), out, "3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=900, env=dict(env, PATH=shim + os.pathsep + env["PATH"]))
    pre_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError("preprocess.sh failed:\n" + res.stderr[-3000:])
    marks = []
    with open(starts) as f:
        for line in f:
            t, _, _, cmd, *args = line.split()   # time -m package command
            marks.append((float(t), cmd + (" --prepare" if "--prepare" in args
                                           else f" {args[1]}" if
                                           cmd == "annotate" else "")))
    ends = [t for t, _ in marks[1:]] + [start + pre_s]
    commands = ", ".join(f"{c} {e - t:.3f}"
                         for (t, c), e in zip(marks, ends))
    n = same_trees(cli, out, "the CLI's tree and preprocess.sh's",
                   skip=("config.yaml", "samples.tsv"))
    with open(os.path.join(cli, "samples.tsv")) as f, \
            open(os.path.join(out, "samples.tsv")) as g:
        a = [r.split("\t")[:-1] for r in f.read().splitlines()]
        b = [r.split("\t")[:-1] for r in g.read().splitlines()]
    anchored = sorted(os.listdir(os.path.join(out, "anchor")))
    if a != b or len(anchored) != GENOMES:
        raise AssertionError(f"preprocess.sh: samples.tsv differs, or "
                             f"{len(anchored)} anchors for {GENOMES}")
    walls = stage_walls(out)
    count_s = sum(v for k, v in walls.items() if k.startswith("kmc."))
    anchor_s = sum(v for k, v in walls.items() if k.startswith("anchor."))
    print(f"preprocess.sh [{card}]: {pre_s:.3f} s wall (prepare, index "
          f"--cores 3, annotate x3, on the card); the CLI tree's {n} files "
          f"equal, {len(anchored)} anchors; its commands (s, start to the "
          f"next start): {commands}; its build's stages: count "
          f"{count_s:.3f} s (summed over {sum(k.startswith('kmc.') for k in walls)} "
          f"samples), dict {walls['dict']:.3f}, layout {walls['layout']:.3f}, "
          f"anchor {anchor_s:.3f} (summed over the threads' anchors), dist "
          f"{walls['mash.triangle']:.3f}", flush=True)

    prefix = os.path.join(work, "idx")
    d0 = os.path.join(prefix, "anchor", "g0")
    for f in csvs:
        os.remove(os.path.join(d0, f))
    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    t0 = time.perf_counter()
    res = subprocess.run(
        ["bash", os.path.join(scripts, "run_umaps.sh"), prefix, "g0",
         os.path.join(work, "umaps_sh")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=900, env=env)
    umaps_s = time.perf_counter() - t0
    if any(open(os.path.join(d0, f), "rb").read() != b
           for f, b in csvs.items()):
        raise AssertionError("run_umaps.sh did not write g0's CSVs as the "
                             "build did")
    shared = [f for f in os.listdir(d0) if f.startswith("perc_shared")]
    if plots and (res.returncode != 0 or not shared):
        raise AssertionError("run_umaps.sh failed:\n" + res.stderr[-3000:])
    if not plots and (res.returncode == 0 or "matplotlib" not in res.stderr
                      or shared):
        raise AssertionError("run_umaps.sh without matplotlib: exit "
                             f"{res.returncode}, perc_shared files {shared}:"
                             "\n" + res.stderr[-3000:])
    print(f"run_umaps.sh [{card}]: {umaps_s:.3f} s wall; g0's CSVs equal the "
          "build's; " + ("plots and perc_shared files written" if plots else
                         f"exit {res.returncode} at plot_umaps: "
                         + res.stderr.strip().splitlines()[-1]), flush=True)


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
    bd = lookup.BucketedDict.build_device(m, masks, 30, K, mixed=True,
                                          count=D, sorted_input=True,
                                          device=dev)
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

    # each route's transients beside its table and its inputs must stay
    # within lookup.layout_bytes, the figure layout_route decides by, and
    # above MODEL_FLOOR of it (a model far above the need refuses builds
    # that fit)
    perm = torch.randperm(D, generator=g, device=dev)
    shuffled = (m[perm], masks[perm])
    del perm
    B = 1 << nbits
    low_bits = m & (B - 1)
    inputs = (8 + 4) * D
    for name, run, mode in (
            ("single", lambda: lookup._layout_device(m, masks, nbits, cap,
                                                     stride, pre_sorted=True),
             "sorted"),
            ("chunked", lambda: lookup._layout_device_chunked(
                m, masks, nbits, cap, stride), "chunked"),
            ("single, unsorted input", lambda: lookup._layout_device(
                *shuffled, nbits, cap, stride), "sort"),
            ("range shard, low bits", lambda: lookup.layout_rows(
                m, masks, low_bits, B, cap, stride), "bucket")):
        # the bucket mode's bucket ids are an input too
        model = lookup.layout_bytes(D, 1, mode, n_buckets=B) - inputs \
            - (8 * D if mode == "bucket" else 0)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got, overflow = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trans = torch.cuda.max_memory_allocated() - before - table.numel() * 4
        if mode == "bucket":
            # another bucketing: its own table, checked for overflow only
            same = f"its own table, overflow {int(overflow)}"
        elif int(overflow) != 0 or not torch.equal(got, table):
            raise AssertionError(f"{name} layout at 2^{nbits}: overflow "
                                 f"{int(overflow)}, tables differ")
        else:
            same = "equal table, overflow 0"
        del got
        print(f"  {name:22s} route at 2^{nbits}: {wall:.3f} s, {same}; "
              f"transients beside its table and the inputs "
              f"{trans / 2**30:.3f} GiB (layout_bytes model "
              f"{model / 2**30:.3f} GiB, ratio {trans / model:.3f})",
              flush=True)
        if not MODEL_FLOOR * model <= trans <= model:
            raise AssertionError(
                f"{name} layout: transients {trans} B outside "
                f"[{MODEL_FLOOR} x, 1 x] the layout_bytes model {model} B")
    del shuffled, low_bits

    # a sample of keys finds its masks, absent keys find nothing
    idx = torch.randint(0, D, (1 << 20,), generator=g, device=dev)
    hi, lo = split64(m[idx])
    rows = lookup.bucket_query_pairs(hi, lo, bd.table, nbits, bd.cap, 1)
    miss = lookup.bucket_query_pairs(hi ^ 1, lo, bd.table, nbits, bd.cap, 1)
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

    t_start = time.perf_counter()
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
    flush = Flush(dev)
    measured = {n: kernel_phase(dev, n, rng, flush) for n in KERNEL_GENOMES}
    mosaic, mosaic_launches = mosaic_phase(dev, flush)
    del flush

    def at(phase: str):
        print(f"[{time.perf_counter() - t_start:.1f} s into the script] "
              f"{phase}", flush=True)

    at("kernel and mosaic phases done")
    bench = bench_phase(card)
    at("bench phase done")
    bigdict_phase(card, dev, bench["value"], measured)
    at("bigdict phase done")
    with tempfile.TemporaryDirectory() as work:
        launches, seqs, slice_peak = slice_phase(work, card)
        at("slice phase done")
        device_dict_phase(work, card)
        at("device-dict phase done")
        scale100_phase(work, card, dev)
        at("scale100 phase done")
        w4_steady_phase(work, card, dev)
        at("w4_steady phase done")
        full_index_phase(work, seqs, card, dev)
        at("full-index phase done")
        g0_bits, g0_oracle = read_phase(work, seqs, card)
        view_phase(work, card, g0_bits, g0_oracle)
        at("read and view phases done")
        intros_phase(work, card)
        at("intros phase done")
        mesh_phase(work, card, dev, slice_peak)
        at("mesh phase done")
        bigdict_mesh_phase(card)
        at("bigdict_mesh phase done")
        api_phase(work, seqs, card, dev)
        at("api phase done")
    launches["mosaic_probe"] = mosaic_launches
    layout_phase(dev, card)
    at("layout phase done")

    rows = []
    print(f"kernels at the main path's shapes [{card}; bound at "
          f"{MEM_RATE / 1e12:g} TB/s].  In the JSON line `ms` is the cold "
          "reading as it stands (one launch between its own events behind a "
          "blocker, L2 flushed, empty pair not subtracted); until this "
          "timer it was one call between events with the host's enqueue "
          "inside, which `old_timer_ms` still reads:", flush=True)
    for name, source, replaces in KERNELS:
        if name == "mosaic_probe":
            err = max(r["err"] for r in mosaic.values())
            m = mosaic[MOSAIC_SIZES[-1]]
        else:
            err = max(measured[n][name]["err"] for n in measured)
            m = measured[30][name]
        print(f"  {name:24s} {m['bytes']} B, bound "
              f"{m['bound_ms']:.5f} ms by bytes; cold "
              f"{m['cold_ms']:.5f} ms (empty pair {m['empty_pair_ms']:.5f}), "
              f"share of bound {m['share']:.3f}" + (
                  "" if "whole_row_share" not in m else
                  f" (whole rows: {m['whole_row_bytes']} B, share "
                  f"{m['whole_row_share']:.3f})") + "; warm "
              f"{m['warm_ms']:.5f} ms; launches {launches[name]}; library "
              "call " + ("none" if m["library_ms"] is None else
                         f"{m['library_ms']:.5f} ms cold, "
                         f"{m['library_warm_ms']:.5f} ms warm"), flush=True)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": m["cold_ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": "bytes",
                     "library_ms": m["library_ms"],
                     "warm_ms": m["warm_ms"],
                     "empty_pair_ms": m["empty_pair_ms"],
                     "old_timer_ms": m["old_timer_ms"]})
    print(f"the anchor kernels at more mask words [{card}] (kernel phase, "
          "2^22-position chunk, 1.3e7-key table; cold ms, share of bound, "
          "warm ms):", flush=True)
    for n in KERNEL_GENOMES[1:]:
        for name in ANCHOR_KERNELS:
            m = measured[n][name]
            print(f"  N={n} W={(n + 31) // 32} {name:24s} cold "
                  f"{m['cold_ms']:.5f} share {m['share']:.3f}" + (
                      "" if "whole_row_share" not in m else
                      f" (whole rows {m['whole_row_share']:.3f})")
                  + f" warm {m['warm_ms']:.5f} plain {m['plain_ms']:.4f}" + (
                      "" if m["library_ms"] is None else
                      f" library {m['library_ms']:.5f} cold, "
                      f"{m['library_warm_ms']:.5f} warm"), flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
