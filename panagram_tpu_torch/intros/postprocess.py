"""Introgression BED postprocessing: fgap / fcen / rmbn / lift.

panagram_tpu.intros.postprocess on the port's read API.  The `lift` action
(whole-genome alignment and liftover to reference coordinates) runs
minimap2 and paftools.js, and raises the same RuntimeError where either is
not on PATH.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

from ..io.fasta import iter_fasta
from .core import (
    bed_file_is_empty,
    bed_to_bins,
    bins_to_bed,
    fill_gaps,
    get_bed_pieces,
    merge_centromere_regions,
    read_bed_file,
    remove_small_regions,
    write_bed,
)

ACTIONS = ["lift", "fgap", "fcen", "rmbn"]


def _have_tool(name):
    return shutil.which(name) is not None


def run_liftover(bed_files, index, ref_accession, minimap_flags,
                 paf_dir, output_dir, threads=1):
    """minimap2 alignment + paftools liftover; the alignments fan out over
    `threads` (minimap2 is the slow step)."""
    if not (_have_tool("minimap2") and _have_tool("paftools.js")):
        raise RuntimeError(
            "lift action requires minimap2 and paftools.js on PATH")
    output_dir = Path(output_dir)
    ref_genome = index.genomes[ref_accession]
    ref_fasta = ref_genome._fasta_path
    paf_dir = Path(paf_dir) if paf_dir else output_dir / "paf"
    paf_dir.mkdir(parents=True, exist_ok=True)

    accessions = set()
    for f in bed_files:
        _, acc, _ = get_bed_pieces(f, index.genomes.keys())
        accessions.add(acc)

    def _align(acc):
        paf = paf_dir / f"{acc}.paf"
        if not paf.exists():
            q_fasta = index.genomes[acc]._fasta_path
            with open(paf, "w") as out:
                subprocess.check_call(
                    ["minimap2", *minimap_flags.split(), ref_fasta, q_fasta],
                    stdout=out)

    if threads > 1 and len(accessions) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(_align, sorted(accessions)))
    else:
        for acc in sorted(accessions):
            _align(acc)

    lifted = []
    for f in bed_files:
        _, acc, _ = get_bed_pieces(f, index.genomes.keys())
        out_bed = output_dir / Path(f).name
        with open(out_bed, "w") as out:
            subprocess.check_call(
                ["paftools.js", "liftover", str(paf_dir / f"{acc}.paf"),
                 str(f)], stdout=out)
        lifted.append(out_bed)
    return lifted


def postprocess(index, bed_files, actions, output_dir, ref=None,
                bin_size=1_000_000, min_bins=4, gap_bins=1,
                minimap_flags="-x asm20 -c -t 1", paf_dir=None, threads=1):
    """Apply `actions`, in order, to each BED; each result goes to
    output_dir under the BED's name."""
    for a in actions or []:
        if a not in ACTIONS:
            raise ValueError(f"Unrecognized action {a}")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    bed_files = [Path(f) for f in bed_files]
    if "lift" in (actions or []):
        bed_files = run_liftover(bed_files, index, ref, minimap_flags,
                                 paf_dir, output_dir, threads)

    for bed_file in bed_files:
        bed_chr, bed_accession, bed_intro_type = get_bed_pieces(
            bed_file, index.genomes.keys())
        bed_genome = index.genomes[bed_accession]
        if "lift" in (actions or []) or bed_intro_type == "REF":
            if ref is None:
                raise ValueError("--ref required for lift/REF files")
            bed_genome = index.genomes[ref]
        bed_output = output_dir / bed_file.name

        if not actions:
            shutil.copy(bed_file, bed_output)
            continue

        cur = bed_file
        for action in actions:
            if action == "lift":
                continue
            if bed_file_is_empty(cur):
                bed_output.touch()
                break
            if action in ("fgap", "rmbn"):
                bins = bed_to_bins(read_bed_file(cur), bin_size,
                                   bed_genome.sizes[bed_chr])
                bins.values = (fill_gaps(bins.values, gap_bins)
                               if action == "fgap" else
                               remove_small_regions(bins.values, min_bins))
                write_bed(bins_to_bed(bins, bin_size, bed_chr,
                                      bed_intro_type), bed_output)
                cur = bed_output
            elif action == "fcen":
                seqs = dict(iter_fasta(bed_genome._fasta_path))
                write_bed(merge_centromere_regions(read_bed_file(cur), seqs,
                                                   bin_size), bed_output)
                cur = bed_output
        else:
            if cur != bed_output and not bed_file_is_empty(cur):
                shutil.copy(cur, bed_output)
    return output_dir
