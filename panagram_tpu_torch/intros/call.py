"""Introgression caller.

panagram_tpu.intros.call on the port's read API, without pandas: per anchor
x chromosome, query the pan-kmer bitmap at a coarse step, bin it to k-mer
similarity fractions (optionally removing fixed k-mers `rmf` and masking
unique ones `rmu`), preprocess (per-genome trimmed-mean normalization
`gnm`, optional edge taper `edg`, mean or median smoothing `sft` / `ssz`),
threshold (2-way against REF, 3-way against a donor group, or simple REF
space) and write merged BED calls and similarity heatmaps.

The per-(anchor, chromosome) work is done once for all thresholds, which
are applied as one broadcast comparison over a [thresholds, bins] matrix.

A binned bitmap is an ``index.Table``: float64 [genomes, bins], rows the
genome names, columns the bin starts.  Groups are a dict genome -> group
in group.tsv's order.  The reductions keep pandas' semantics: means and
maxima skip NaN (all NaN, or no rows, give NaN), means add in the order of
pandas' column-major blocks, the standard deviation is pandas' two-pass
nanvar with ddof=1, and rounding is half to even.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.ndimage import median_filter, uniform_filter1d

from ..index import Table, _column
from .core import bins_to_bed, write_bed

SWEEP_2WAY = [round(0.1 + 0.05 * i, 2) for i in range(18)]
SWEEP_3WAY = [round(0.04 * i, 2) for i in range(18)]


def read_groups(path) -> dict:
    """group.tsv -> {genome: group} in file order (the first column names
    the genome, as ``pd.read_csv(path, sep="\\t", index_col=0)`` reads it;
    a column of numbers gives numbers, an empty cell None)."""
    with open(path) as f:
        header, *rows = [line.rstrip("\n").split("\t") for line in f
                         if line.strip()]
    if "group" not in header[1:]:
        raise KeyError("group")
    j = header.index("group")
    col = _column([r[j] if j < len(r) else "" for r in rows])
    col = [None if v == "" or (isinstance(v, float) and np.isnan(v)) else v
           for v in col]
    return dict(zip((r[0] for r in rows), col))


def _nanmean(v: np.ndarray) -> float:
    """pandas' Series.mean(): the sum of the non-NaN values over their
    count; NaN without any."""
    mask = np.isnan(v)
    count = float(v.size - mask.sum())
    total = np.where(mask, 0.0, v).sum(dtype=np.float64)
    return total / count if count > 0 else np.nan


def _nanstd(v: np.ndarray) -> float:
    """pandas' Series.std(): two-pass variance over the non-NaN values,
    ddof=1; NaN with fewer than two."""
    mask = np.isnan(v)
    count = float(v.size - mask.sum())
    if count <= 1:
        return np.nan
    vals = np.where(mask, 0.0, v)
    avg = vals.sum(dtype=np.float64) / count
    sqr = (avg - vals) ** 2
    sqr[mask] = 0
    return float(np.sqrt(sqr.sum(dtype=np.float64) / (count - 1)))


def _col_nanmean(v: np.ndarray) -> np.ndarray:
    """pandas' DataFrame.mean(axis=0) of [rows, columns]: per column the
    non-NaN values' sum over their count, summed down each column as
    pandas sums its column-major blocks."""
    mask = np.isnan(v)
    count = (~mask).sum(axis=0).astype(np.float64)
    total = np.asfortranarray(np.where(mask, 0.0, v)).sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = total / count
    out[count == 0] = np.nan
    return out


def _col_nanmax(v: np.ndarray) -> np.ndarray:
    """pandas' DataFrame.max(axis=0): NaN skipped; NaN for a column with no
    value."""
    out = np.full(v.shape[1], np.nan)
    ok = ~np.isnan(v).all(axis=0) if len(v) else np.zeros(v.shape[1], bool)
    if ok.any():
        out[ok] = np.nanmax(v[:, ok], axis=0)
    return out


def bitmap_to_bins(bitmap: Table, binlen, omit_fixed_kmers=False,
                   omit_unique_kmers=False, ref_genome_name=None,
                   outgroup_accessions=None) -> Table:
    """Binned k-mer similarity in [0, 1]: per bin each genome's presence
    count over the bin's largest (0 / 0 -> NaN).  rmf drops the rows every
    genome holds (a bin left without rows counts 1 for every genome); rmu
    sets the outgroups' and the reference's bits of rows none of them
    holds."""
    names = list(bitmap.columns)
    pres = np.array(bitmap.values, np.int64)
    all_bins, slots = np.unique(np.asarray(bitmap.index, np.int64) // binlen,
                                return_inverse=True)
    if omit_unique_kmers:
        keep = [names.index(c) for c in
                list(outgroup_accessions) + [ref_genome_name]]
        mask = pres[:, keep].sum(axis=1) == 0
        pres[np.ix_(mask, keep)] = 1
    if omit_fixed_kmers:
        kept = ~(pres == 1).all(axis=1)
        pres, slots = pres[kept], slots[kept]
    sums = np.zeros((len(all_bins), len(names)), np.int64)
    np.add.at(sums, slots, pres)
    sums[np.bincount(slots, minlength=len(all_bins)) == 0] = 1
    sums = sums.T
    with np.errstate(invalid="ignore", divide="ignore"):
        binned = sums / sums.max(axis=0)
    return Table(binned, names, all_bins * binlen)


def row_trimmed_mean(row, trim_std):
    mean = _nanmean(row)
    if trim_std == -1:
        return mean
    std = _nanstd(row)
    trimmed = row[(row >= mean - trim_std * std)
                  & (row <= mean + trim_std * std)]
    return _nanmean(trimmed)


def get_genome_similarities(genome, bitmap_step, bin_size, omit_fixed_kmers,
                            omit_unique_for, ref_genome_name,
                            outgroup_accessions, trim_std) -> Table:
    """Genome-wide per-accession trimmed-mean similarity, a Table over the
    genome names."""
    parts = []
    for chr_name, chr_size in genome.sizes.items():
        chr_bitmap = genome.query(chr_name, 0, chr_size, step=bitmap_step)
        parts.append(bitmap_to_bins(
            chr_bitmap, bin_size, omit_fixed_kmers, omit_unique_for,
            ref_genome_name, outgroup_accessions,
        ))
    allv = np.concatenate([p.values for p in parts], axis=1)
    return Table(np.array([row_trimmed_mean(r, trim_std) for r in allv]),
                 parts[0].index)


def smooth_row(row, filter_type, filter_size):
    if filter_type == "mean":
        return uniform_filter1d(row, size=filter_size)
    if filter_type == "median":
        return median_filter(row, size=filter_size)
    return row


def edge_tapered_row_normalization(values, intensity=0.1):
    """Gaussian center-boost normalization of [rows, bins]."""
    n_cols = values.shape[1]
    x = np.linspace(-1, 1, n_cols)
    window = np.exp(-4 * x**2)
    center_boost = intensity * (window / window.max())
    norm = np.clip(values * (1 + center_boost), 0, 1)
    norm = np.where(norm == 1, norm, norm - 0.2)
    return np.clip(norm, 0, 1)


def preprocess_binned_bitmap(binned: Table, genome_similarities,
                             similarity_normalization_mean, smoothing_filter,
                             smoothing_filter_size,
                             edge_normalization) -> Table:
    """Rounding to 2 decimals, then the optional similarity normalization
    (each row's values <= 0.98 shifted by target - the genome's
    similarity), edge taper and smoothing."""
    v = np.round(binned.values, 2)
    if genome_similarities is not None:
        sims = dict(zip(genome_similarities.index,
                        genome_similarities.values))
        target = similarity_normalization_mean
        if target == -1:
            vals = genome_similarities.values
            target = _col_nanmax(vals[vals != 1][:, None])[0]
        for i, name in enumerate(binned.index):
            row = v[i]
            mask = row <= 0.98
            row[mask] += target - sims[name]
            v[i] = np.clip(row, 0, 1)
    if edge_normalization:
        v = edge_tapered_row_normalization(v)
    if smoothing_filter:
        v = np.stack([smooth_row(r, smoothing_filter, smoothing_filter_size)
                      for r in v]) if len(v) else v
    return Table(v, binned.index, binned.columns)


def _rows_of(binned: Table, groups: dict, group) -> np.ndarray:
    """Row numbers of the genomes in `group` (a genome without a group is
    in none)."""
    return np.array([i for i, n in enumerate(binned.index)
                     if groups.get(n) is not None and groups.get(n) == group],
                    np.int64)


def similarity_frame(binned: Table, groups: dict, anchor, comp_group) -> dict:
    """Threshold-independent similarity columns for one comparison group:
    the mean similarity of the anchor's own group (the anchor left out),
    the maximum of the comparison group and (3-way) the mean of REF."""
    own = [i for i in _rows_of(binned, groups, groups[anchor])
           if binned.index[i] != anchor]
    v = binned.values
    sims = {"anchor_sim": _col_nanmean(v[own]),
            "comp_sim": _col_nanmax(v[_rows_of(binned, groups, comp_group)])}
    if comp_group != "REF":
        sims["ref_sim"] = _col_nanmean(v[_rows_of(binned, groups, "REF")])
    return sims


def similarity_frame_simple(binned: Table, anchor) -> dict:
    """REF-space variant of similarity_frame: the anchor's row."""
    return {"anchor_sim": binned.values[list(binned.index).index(anchor)]}


def threshold_matrix(sims, comp_group, thresholds, simple=False):
    """All thresholds applied in one broadcast comparison: int [T, bins]."""
    thr = np.asarray(thresholds, dtype=float)[:, None]
    if simple:
        return (np.asarray(sims["anchor_sim"], float)[None, :] < thr
                ).astype(int)
    if comp_group == "REF":
        return (np.asarray(sims["comp_sim"], float)[None, :] < thr
                ).astype(int)
    ref_sim = np.asarray(sims["ref_sim"], float)[None, :]
    comp_sim = np.asarray(sims["comp_sim"], float)[None, :]
    return ((ref_sim < 0.95) & (comp_sim >= ref_sim + thr)).astype(int)


def visualize(binned: Table, output_file, inverse=False, title=None,
              groups=None):
    """Similarity heatmap, SVG or PNG by the file's extension.  Rows follow
    group.tsv's order when `groups` is given (genomes without a group are
    left out), with an "Introgressions" row kept last.

    Built through matplotlib's Figure API, not pyplot: the caller's anchor
    x chromosome pool and the scorer's threshold pool render concurrently,
    and pyplot's global figure registry is not thread-safe."""
    try:
        from matplotlib.figure import Figure
    except ImportError as e:
        raise ImportError("introgression heatmaps need matplotlib, which "
                          "this Python cannot import") from e

    names, data = list(binned.index), np.asarray(binned.values, float)
    if groups is not None:
        ordered = [n for n in groups if n in names]
        if "Introgressions" in names:
            ordered.append("Introgressions")
        data = data[[names.index(n) for n in ordered]] if ordered else \
            np.zeros((0, data.shape[1]))
        names = ordered
    cols = binned.columns
    fig = Figure(figsize=(max(7, min(30, data.shape[1] / 20)),
                          max(3, 0.25 * data.shape[0] + 1.5)))
    ax = fig.subplots()
    cmap = "plasma_r" if inverse else "viridis"
    im = ax.imshow(data, aspect="auto", cmap=cmap, vmin=0, vmax=1,
                   interpolation="nearest",
                   extent=[cols[0], cols[-1] if len(cols) > 1 else 1,
                           data.shape[0] - 0.5, -0.5])
    ax.set_yticks(range(data.shape[0]), names, fontsize=7)
    ax.set_xlabel("Position (Bp)")
    if title:
        ax.set_title(title, fontsize=10)
    fig.colorbar(im, ax=ax, label="Kmer Similarity")
    fig.savefig(output_file, bbox_inches="tight")


def _with_row(binned: Table, values) -> Table:
    """The binned rows and an "Introgressions" row of `values` last."""
    return Table(np.vstack([binned.values, np.asarray(values, float)]),
                 list(binned.index) + ["Introgressions"], binned.columns)


def run_introgression_finder(anchor, genome, ref_genome, chr_name, groups,
                             comp_groups, thresholds, bitmap_step, bin_size,
                             using_ref_space, preprocessing_args,
                             genome_similarities, ref_genome_similarities,
                             render_vis, output_dir):
    """Per anchor x chromosome finder: the raw BEDs (and heatmaps) of every
    threshold."""
    output_dir = Path(output_dir)
    chr_size = genome.sizes[chr_name]
    pp = dict(preprocessing_args)
    omit_fixed_kmers = pp.pop("omit_fixed_kmers")
    omit_unique_kmers = pp.pop("omit_unique_kmers")
    ref_genome_name = pp.pop("ref_genome_name")
    outgroup_accessions = pp.pop("outgroup_accessions")

    if using_ref_space:
        ref_chr_bitmap = ref_genome.query(
            chr_name, 0, ref_genome.sizes[chr_name], step=bitmap_step)
        binned = bitmap_to_bins(ref_chr_bitmap, bin_size, omit_fixed_kmers)
        binned = preprocess_binned_bitmap(binned, ref_genome_similarities,
                                          **pp)
    else:
        chr_bitmap = genome.query(chr_name, 0, chr_size, step=bitmap_step)
        binned = bitmap_to_bins(chr_bitmap, bin_size, omit_fixed_kmers,
                                omit_unique_kmers, ref_genome_name,
                                outgroup_accessions)
        binned = preprocess_binned_bitmap(binned, genome_similarities, **pp)

    sims_by_comp = {}
    mat_by_comp = {}
    for comp_group in comp_groups:
        if using_ref_space:
            sims = similarity_frame_simple(binned, anchor)
        else:
            sims = similarity_frame(binned, groups, anchor, comp_group)
        sims_by_comp[comp_group] = sims
        mat_by_comp[comp_group] = threshold_matrix(
            sims, comp_group, thresholds, simple=using_ref_space)

    def bins(flags):
        return Table(flags, binned.columns)

    for ti, threshold in enumerate(thresholds):
        merged = None
        threshold_dir = output_dir / f"{output_dir.name}_{threshold}"
        raw_dir = threshold_dir / "raw"
        raw_dir.mkdir(parents=True, exist_ok=True)
        if render_vis:
            (threshold_dir / "heatmaps").mkdir(parents=True, exist_ok=True)

        for comp_group in comp_groups:
            intro = mat_by_comp[comp_group][ti]
            if not using_ref_space and comp_group == "REF":
                comp_group = "REFA"
            if len(comp_groups) > 1:
                merged = intro.copy() if merged is None else merged + intro

            if render_vis:
                out_vis = (threshold_dir / "heatmaps" /
                           f"{anchor}_{chr_name}_{comp_group}_heatmap.svg")
                visualize(_with_row(binned, (~intro.astype(bool)).astype(int)),
                          out_vis, inverse=True,
                          title=f"{anchor} {chr_name} Introgressions "
                                f"Called with {comp_group}",
                          groups=groups)

            write_bed(bins_to_bed(bins(intro), bin_size, chr_name, comp_group),
                      raw_dir / f"{anchor}_{chr_name}_{comp_group}.bed")

        if merged is not None:
            if render_vis:
                mx = max(int(merged.max()), 1)
                out_vis = (threshold_dir / "heatmaps" /
                           f"{anchor}_{chr_name}_merged_heatmap.svg")
                visualize(_with_row(binned, 1 - merged / mx), out_vis,
                          inverse=True,
                          title=f"{anchor} {chr_name} Merged Introgressions",
                          groups=groups)
            write_bed(bins_to_bed(bins(merged), bin_size, chr_name, "merged"),
                      raw_dir / f"{anchor}_{chr_name}_merged.bed")


def call_introgressions(index, groups, anchors, comp_groups, thresholds,
                        output_dir, bitmap_step=100, bin_size=1_000_000,
                        gnm=None, trm=3.0, sft=None, ssz=5, edg=False,
                        rmf=False, rmu=None, ogrp=None, urf=False, ref=None,
                        chromosomes=None, render_vis=False, threads=1):
    """Top-level caller, in process.  `groups` is read_groups' dict."""
    from concurrent.futures import ThreadPoolExecutor

    comp_groups = list(dict.fromkeys(comp_groups))
    if "REF" in comp_groups and comp_groups != ["REF"]:
        raise ValueError("REF must be the only comparison group (2-way mode)")

    outgroup_accessions = []
    omit_unique_for = rmu
    if omit_unique_for is not None:
        if ref is None:
            raise ValueError("--ref required with rmu")
        if (len(omit_unique_for) == 1
                and str(omit_unique_for[0]).lower() == "true"):
            omit_unique_for = list(anchors)
        if ogrp is None:
            raise ValueError("--ogrp required with rmu")
        outgroup_accessions = [n for n, g in groups.items() if g in ogrp]

    base_pp = dict(
        similarity_normalization_mean=gnm,
        smoothing_filter=sft,
        smoothing_filter_size=ssz,
        edge_normalization=edg,
        omit_fixed_kmers=rmf,
    )

    ref_genome = None
    ref_genome_similarities = None
    if urf:
        if comp_groups != ["REF"]:
            raise ValueError("urf requires cmp == [REF]")
        ref_genome = index.genomes[ref]
        if gnm:
            ref_genome_similarities = get_genome_similarities(
                ref_genome, bitmap_step, bin_size, rmf, None, None, None, trm)

    jobs = []
    for anchor in anchors:
        anchor_group = groups[anchor]
        loop_comp = [g for g in comp_groups if g != anchor_group]
        if not loop_comp:
            continue

        pp = dict(base_pp)
        if omit_unique_for and anchor in omit_unique_for:
            loop_urf = False
            pp["omit_unique_kmers"] = True
            pp["ref_genome_name"] = ref
            pp["outgroup_accessions"] = outgroup_accessions
        else:
            loop_urf = urf
            pp["omit_unique_kmers"] = False
            pp["ref_genome_name"] = None
            pp["outgroup_accessions"] = None

        genome = index.genomes[anchor]
        genome_similarities = None
        if gnm and not loop_urf:
            genome_similarities = get_genome_similarities(
                genome, bitmap_step, bin_size, rmf,
                pp["omit_unique_kmers"], pp["ref_genome_name"],
                pp["outgroup_accessions"], trm)

        chrs = chromosomes or list(genome.sizes.keys())
        for chr_name in chrs:
            jobs.append((anchor, genome, ref_genome, chr_name, loop_comp,
                         pp, genome_similarities, loop_urf))

    def run_job(job):
        anchor, genome, ref_g, chr_name, loop_comp, pp, gsim, loop_urf = job
        run_introgression_finder(
            anchor, genome, ref_g, chr_name, groups, loop_comp, thresholds,
            bitmap_step, bin_size, loop_urf, pp, gsim,
            ref_genome_similarities, render_vis, Path(output_dir))

    if threads > 1:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(run_job, jobs))
    else:
        for job in jobs:
            run_job(job)
