"""Matplotlib figures for the browser, on the port's read API.

The figures of ``panagram_tpu.view.plots`` (conservation stacked bins,
per-genome presence heatmap, annotation tracks, genome dendrogram,
composition bars, embedding scatters) from ``index.Table``s instead of
pandas frames: the same matplotlib calls on the same float64 values, so the
PNG bytes and click-through maps are panagram_tpu's.

matplotlib is imported at the first render (``_pyplot``), not with the
module: the server's data routes run on a host without it, and a render
there raises an ImportError that names it.
"""

from __future__ import annotations

import io

import numpy as np
from scipy.cluster import hierarchy
from scipy.spatial.distance import squareform

from ..distances import load_genome_dist
from ..index import Table


def _pyplot():
    """matplotlib.pyplot on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the viewer's figures need matplotlib, which this "
                          "Python cannot import") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _row(t: Table, label) -> np.ndarray:
    """The values of the row labelled `label` (``DataFrame.loc[label]``)."""
    return t.values[list(t.index).index(label)]


def _chrom_bins(t: Table, chrom):
    """(bin starts, rows) of `chrom` in a table whose rows are labelled
    (chr, start): ``bitfreq_bins.loc[chrom]``."""
    sel = [i for i, (c, _) in enumerate(t.index) if c == chrom]
    if not sel:
        raise KeyError(chrom)
    return (np.array([t.index[i][1] for i in sel], np.int64), t.values[sel])


def genome_colors(n, cmap="viridis_r"):
    """Occupancy color scale (reference figs.py:11-25)."""
    from matplotlib import colors as mcolors

    colormap = _pyplot().get_cmap(cmap)
    if n <= 1:
        return [mcolors.rgb2hex(colormap(0.5))]
    return [mcolors.rgb2hex(colormap(i / (n - 1))) for i in range(n)]


def _render(fig) -> bytes:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    _pyplot().close(fig)
    return buf.getvalue()


def _render_mapped(fig, axes_info, extra=None):
    """Render without bbox trimming (so axes transforms stay valid) and
    return (png, map): per-axes pixel bboxes in image coordinates plus the
    data x-range, which the client uses to turn clicks and drags on the
    <img> into genomic coordinates."""
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    rows = []
    for ax, payload in axes_info:
        bb = ax.get_window_extent()
        x0, x1 = ax.get_xlim()
        rows.append({**payload,
                     "px0": round(bb.x0, 1), "px1": round(bb.x1, 1),
                     "py0": round(h - bb.y1, 1), "py1": round(h - bb.y0, 1),
                     "bp0": float(x0), "bp1": float(x1)})
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=fig.dpi)
    _pyplot().close(fig)
    m = {"w": w, "h": h, "rows": rows}
    if extra:
        m.update(extra)
    return buf.getvalue(), m


def _linkage_tree(link, names):
    """scipy linkage -> nested node dicts (ids follow scipy: leaves
    0..n-1, internal n..2n-2), the payload of the client's collapsible
    tree."""
    n = len(names)

    def node(i):
        if i < n:
            return {"id": int(i), "name": names[i], "size": 1}
        row = link[i - n]
        kids = [node(int(row[0])), node(int(row[1]))]
        return {"id": int(i), "dist": float(row[2]),
                "size": int(row[3]), "children": kids}

    return node(2 * n - 2) if n > 1 else {"id": 0, "name": names[0], "size": 1}


def _collapse_order(link, names, collapse):
    """Effective heatmap rows for a set of collapsed internal node ids:
    the tree in dendrogram leaf order, a merged pseudo-row (member leaf ids
    + label) at each collapsed node."""
    n = len(names)

    def members(i):
        if i < n:
            return [i]
        row = link[i - n]
        return members(int(row[0])) + members(int(row[1]))

    def walk(i):
        if i < n:
            return [([i], names[i])]
        if i in collapse:
            mem = members(i)
            return [(mem, f"[{len(mem)} genomes]")]
        row = link[i - n]
        return walk(int(row[0])) + walk(int(row[1]))

    return walk(2 * n - 2)


def _loaded_chrs(index, genome) -> list:
    """Chromosome names of a loaded anchor, in chrs.tsv order."""
    return [c[0] for c in index.genomes[genome].chrs]


# ---------------- Pangenome tab ----------------

def pangenome_composition(index) -> bytes:
    """Stacked occupancy composition per anchor genome."""
    plt = _pyplot()
    totals = index.bitfreq_totals
    n = index.ngenomes
    colors = genome_colors(n)
    names = list(totals.index)
    fig, ax = plt.subplots(figsize=(8, 0.6 + 0.45 * len(names)))
    left = np.zeros(len(names))
    for occ in range(1, n + 1):
        vals = totals.values[:, list(totals.columns).index(occ)] * 100
        ax.barh(names, vals, left=left, color=colors[occ - 1],
                label=str(occ))
        left += vals
    ax.set_xlabel("% of anchored k-mer positions")
    ax.set_title("Pan-genome k-mer occupancy composition")
    ax.legend(title="occupancy", fontsize=7, bbox_to_anchor=(1.02, 1),
              loc="upper left")
    return _render(fig)


def genome_dendrogram(index) -> bytes:
    """Dendrogram + distance heatmap from genome_dist.tsv."""
    plt = _pyplot()
    names = list(index.genome_names)
    name_to_id = {n: index.genomes[n].id for n in names}
    mat = load_genome_dist(index.genome_dist_fname, name_to_id)
    fig, (ax1, ax2) = plt.subplots(
        2, 1, figsize=(8, 8), height_ratios=[1, 3], constrained_layout=True
    )
    if len(names) > 2:
        cond = squareform(mat, checks=False)
        link = hierarchy.linkage(cond, method="average")
        dn = hierarchy.dendrogram(link, labels=names, ax=ax1,
                                  leaf_rotation=90, color_threshold=0)
        order = dn["leaves"]
    else:
        order = list(range(len(names)))
        ax1.axis("off")
    m = mat[np.ix_(order, order)]
    im = ax2.imshow(m, cmap="viridis_r")
    ax2.set_xticks(range(len(names)), [names[i] for i in order], rotation=90)
    ax2.set_yticks(range(len(names)), [names[i] for i in order])
    fig.colorbar(im, ax=ax2, label="mash-style distance")
    return _render(fig)


def chromosome_histograms(index) -> bytes:
    """Per-chromosome occupancy frequency bars for every anchor."""
    plt = _pyplot()
    n = index.ngenomes
    colors = genome_colors(n + 1)
    # anchors whose build never completed (chrs None) are skipped, as
    # /api/meta skips them
    rows = [(g, c) for g in index.anchor_genomes
            if index.genomes[g].chrs is not None
            for c in _loaded_chrs(index, g)]
    rows = rows[: index.conf.max_view_chrs]
    fig, axes = plt.subplots(
        max(len(rows), 1), 1, figsize=(8, 1.1 * max(len(rows), 1) + 1),
        squeeze=False, constrained_layout=True,
    )
    for ax, (g, c) in zip(axes[:, 0], rows):
        perc = _row(index.genomes[g].bitfreq_chrs, c) * 100
        ax.bar(np.arange(len(perc)), perc,
               color=[colors[min(i, n)] for i in range(len(perc))])
        ax.set_yscale("log")
        ax.set_ylabel(f"{g}\n{c}", fontsize=7, rotation=0, ha="right")
        ax.tick_params(labelsize=6)
    axes[-1, 0].set_xlabel("k-mer occupancy (0..N genomes)")
    return _render(fig)


def genome_sizes_plot(index) -> bytes:
    plt = _pyplot()
    gs = index.genome_sizes
    fig, ax = plt.subplots(figsize=(7, 0.5 + 0.4 * len(gs.index)))
    ax.barh(list(gs.index), gs.values[:, 0] / 1e6, color="#4878a8")
    ax.set_xlabel("anchored length (Mbp)")
    ax.set_title("Genome sizes")
    return _render(fig)


# ---------------- Anchor tab ----------------

def whole_genome_plot(index, genome, max_bins=350):
    """Per-chromosome occupancy bands across the genome.  Returns (png,
    map): each chromosome band is a click target into the chromosome
    tab."""
    plt = _pyplot()
    g = index.genomes[genome]
    n = index.ngenomes
    colors = genome_colors(n + 1)
    chrs = _loaded_chrs(index, genome)[: index.conf.max_view_chrs]
    fig, axes = plt.subplots(
        max(len(chrs), 1), 1,
        figsize=(9, 0.9 * max(len(chrs), 1) + 1),
        squeeze=False, constrained_layout=True,
    )
    maxsize = np.int64(max(g.sizes.values()))
    info = []
    for ax, chrom in zip(axes[:, 0], chrs):
        x, vals = _chrom_bins(g.bitfreq_bins, chrom)
        ax.stackplot(x, vals.T, colors=colors, step="post", linewidth=0)
        ax.set_xlim(0, maxsize)
        ax.set_ylim(0, 1)
        ax.set_ylabel(chrom, fontsize=7, rotation=0, ha="right")
        ax.tick_params(labelsize=6)
        info.append((ax, {"chrom": chrom, "size": int(g.seq_len(chrom))}))
    axes[-1, 0].set_xlabel("position (bp)")
    fig.suptitle(f"{genome}: occupancy composition per bin")
    return _render_mapped(fig, info)


def _gene_fractions(genes: Table, n: int):
    """panagram_tpu's gene line: the column sums of bitsum_genes over their
    total (at least 1), reindexed to occupancies 0..n with 0 for a missing
    one; None where pandas' reindex raises (duplicate column labels)."""
    cols = list(genes.columns)
    if len(set(cols)) != len(cols):
        return None
    sums = genes.values.sum(axis=0)
    frac = sums / max(sums.sum(), 1)
    at = {c: f for c, f in zip(cols, frac)}
    return np.array([at.get(i, 0.0) for i in range(n + 1)], np.float64)


def gene_content_plot(index, genome) -> bytes:
    """Gene vs overall conservation."""
    plt = _pyplot()
    g = index.genomes[genome]
    n = index.ngenomes
    fig, ax = plt.subplots(figsize=(7, 4))
    x = np.arange(n + 1)
    total = g.bitsum_bins.values.sum(axis=0)
    ax.plot(x, total / total.sum(), "o-", label="all k-mers")
    if g.bitsum_genes is not None and len(g.bitsum_genes.index):
        genes = _gene_fractions(g.bitsum_genes, n)
        if genes is not None:
            ax.plot(x, genes, "s-", label="gene k-mers")
    ax.set_yscale("log")
    ax.set_xlabel("occupancy")
    ax.set_ylabel("fraction")
    ax.legend()
    ax.set_title(f"{genome}: gene vs genome-wide conservation")
    return _render(fig)


def umap_scatter(index, genome, chrom=None) -> bytes:
    """Embedding scatter colored by cluster."""
    plt = _pyplot()
    g = index.genomes[genome]
    t = g.genome_umap
    if chrom and g.chrom_umaps is not None and chrom in g.chrom_umaps.index:
        sel = [i for i, c in enumerate(g.chrom_umaps.index) if c == chrom]
        t = Table(g.chrom_umaps.values[sel], [chrom] * len(sel),
                  g.chrom_umaps.columns)
    fig, ax = plt.subplots(figsize=(6, 5))
    if t is None or not len(t.index):
        ax.text(0.5, 0.5, "no embedding", ha="center")
    else:
        col = {c: t.values[:, i] for i, c in enumerate(t.columns)}
        sc = ax.scatter(col["umap1"].astype(np.float64),
                        col["umap2"].astype(np.float64),
                        c=col["cluster"].astype(np.int64), s=8, cmap="tab10")
        fig.colorbar(sc, ax=ax, label="cluster")
    ax.set_xlabel("dim 1")
    ax.set_ylabel("dim 2")
    ax.set_title(f"{genome}{': ' + chrom if chrom else ''} bin embedding")
    return _render(fig)


# ---------------- Chromosome tab ----------------

ANNO_COLORS = ["#70ad47", "#c05850", "#8064a2", "#4bacc6", "#f79646",
               "#9bbb59", "#7f7f7f", "#c0504d"]


_CHROM_LINK_CACHE: dict = {}


def _chrom_linkage(index, genome, chrom, size):
    """Ward linkage over the whole chromosome at a bounded lowres step,
    memoized per (index, genome, chrom): region renders reuse it instead of
    a fresh 50k-row linkage per pan or zoom.  The rows are sampled as
    pandas' ``DataFrame.sample(n, random_state=42)`` draws them
    (RandomState(42).choice without replacement), in the drawn order."""
    key = (getattr(index, "prefix", id(index)), genome, chrom)
    if key in _CHROM_LINK_CACHE:
        return _CHROM_LINK_CACHE[key]
    n = index.ngenomes
    link = None
    if n > 2:
        # the stride is a multiple of a stored step, or the query falls
        # back to the step-1 bitmap (a whole-chromosome full-res read)
        ls = max(int(index.lowres_step), 1)
        step = ls * max(int(size) // 200_000 // ls, 1)
        bitmap = index.query_bitmap(genome, chrom, 0, size, step)
        rows = len(bitmap.index)
        locs = np.random.RandomState(42).choice(
            rows, size=min(rows, 50_000), replace=False).astype(np.intp)
        arr = bitmap.values[locs]
        if arr.std() > 0:
            link = hierarchy.linkage(arr.T, method="ward")
    if len(_CHROM_LINK_CACHE) >= 256:
        _CHROM_LINK_CACHE.pop(next(iter(_CHROM_LINK_CACHE)))
    _CHROM_LINK_CACHE[key] = link
    return link


def chromosome_view(index, genome, chrom, start=None, end=None,
                    max_bins=350, order_names=None, types=None,
                    collapse=None):
    """The main interactive figure: stacked occupancy bins + per-genome
    presence heatmap + gene/annotation tracks for a region.  Returns (png,
    map).

    types: annotation type names to draw (None = all).  collapse: internal
    tree-node ids whose subtrees render as one averaged heatmap row.  The
    map carries the linkage tree so the client can draw and toggle it."""
    plt = _pyplot()
    g = index.genomes[genome]
    size = int(g.seq_len(chrom))
    start = 0 if start is None else max(0, int(start))
    end = size if end is None else min(size, int(end))
    if end <= start:
        start, end = 0, size

    span = end - start
    # full resolution for small windows, lowres beyond
    step = 1 if span <= max_bins * 100 else index.lowres_step
    bitmap = index.query_bitmap(genome, chrom, start, end, step)
    binlen = max(span // max_bins, step)
    pancount, paircount = index.bitmap_to_bins(bitmap, binlen)

    n = index.ngenomes
    colors = genome_colors(n + 1)
    names = list(index.genome_names)

    # genome order: an explicit --order list, else the ward linkage of the
    # whole chromosome, computed once and reused across region renders.  A
    # linkage failure leaves the samples' order (panagram_tpu's rule)
    link = None
    tree = None
    if order_names:
        wanted = [names.index(g_) for g_ in order_names if g_ in names]
        rest = [i for i in range(n) if i not in wanted]
        groups = [([i], names[i]) for i in np.array(wanted + rest)]
    else:
        groups = [([i], names[i]) for i in range(n)]
        try:
            link = _chrom_linkage(index, genome, chrom, size)
            if link is not None:
                tree = _linkage_tree(link, names)
                groups = _collapse_order(link, names,
                                         set(collapse or ()))
        except Exception:
            pass

    fig = plt.figure(figsize=(11, 8), constrained_layout=True)
    gs = fig.add_gridspec(3, 2, height_ratios=[2, 2, 1],
                          width_ratios=[9, 2])
    ax1 = fig.add_subplot(gs[0, 0])
    ax2 = fig.add_subplot(gs[1, 0], sharex=ax1)
    ax3 = fig.add_subplot(gs[2, 0], sharex=ax1)
    axd = fig.add_subplot(gs[1, 1])
    if link is not None and not collapse:
        hierarchy.dendrogram(link, ax=axd, orientation="right",
                             labels=names, leaf_font_size=6,
                             color_threshold=0,
                             link_color_func=lambda _: "#888888")
        axd.invert_yaxis()
        axd.spines[:].set_visible(False)
        axd.set_xticks([])
    else:
        axd.axis("off")

    # stacked occupancy fractions per bin (one artist per occupancy level)
    xs = np.asarray(pancount.columns, np.int64) * binlen
    denom = pancount.values.sum(axis=0).astype(float)
    denom[denom == 0] = 1
    fracs = pancount.values / denom
    ax1.stackplot(xs, fracs, colors=colors, step="post", linewidth=0)
    ax1.set_ylim(0, 1)
    ax1.set_ylabel("occupancy fraction")
    ax1.set_title(f"{genome} {chrom}:{start:,}-{end:,} (step {step})")

    # per-genome presence heatmap, one row per (possibly merged) group
    pcfull = paircount.values
    pc = np.stack([pcfull[mem].mean(axis=0) for mem, _ in groups])
    labels = [lab for _, lab in groups]
    ax2.imshow(
        pc, aspect="auto", interpolation="nearest", cmap="viridis",
        extent=[xs[0] if len(xs) else start,
                (xs[-1] + binlen) if len(xs) else end,
                len(groups) - 0.5, -0.5],
    )
    ax2.set_yticks(range(len(groups)), labels, fontsize=7)
    ax2.set_ylabel("genome")

    # gene + per-type annotation tracks with legend
    genes = g.query_genes(chrom, start, end)
    annos = g.query_anno(chrom, start, end)
    gcol = {c: i for i, c in enumerate(genes.columns)}
    acol = {c: i for i, c in enumerate(annos.columns)}
    atypes = annos.values[:, acol["type"]] if len(annos.values) else []
    type_names = sorted({t for t in atypes if t is not None})
    shown = [t for t in type_names if types is None or t in types]
    y = 0
    for r in genes.values:
        gs_, ge = r[gcol["start"]], r[gcol["end"]]
        ax3.barh(y % 4, ge - gs_, left=gs_, height=0.8, color="#2a6099")
        ax3.text(gs_, y % 4 + 0.45, str(r[gcol["name"]]), fontsize=6)
        y += 1
    handles = []
    from matplotlib.patches import Patch

    handles.append(Patch(color="#2a6099", label="gene"))
    for ti, t in enumerate(shown):
        color = ANNO_COLORS[ti % len(ANNO_COLORS)]
        for r in annos.values[atypes == t]:
            ax3.barh(4 + ti % 3, r[acol["end"]] - r[acol["start"]],
                     left=r[acol["start"]], height=0.6, color=color,
                     alpha=0.7)
        handles.append(Patch(color=color, label=t))
    ax3.set_ylim(-0.5, 7.5)
    ax3.set_yticks([1.5, 5], ["genes", "annotations"], fontsize=7)
    ax3.set_xlabel("position (bp)")
    ax3.set_xlim(start, end)
    if len(handles) > 1:
        ax3.legend(handles=handles, fontsize=6, ncol=min(len(handles), 6),
                   loc="upper right", framealpha=0.9)

    # hover payload: per-bin mean occupancy
    occ = np.arange(n + 1, dtype=float)
    mean_occ = (occ[:, None] * fracs).sum(axis=0)
    extra = {
        "tree": tree,
        "labels": labels,
        "start": start, "end": end, "step": step, "size": size,
        "binlen": int(binlen),
        "bins_x": [int(v) for v in xs],
        "mean_occ": [round(float(v), 3) for v in mean_occ],
        "anno_types": type_names,
    }
    info = [(ax1, {"panel": "occupancy"}), (ax2, {"panel": "heatmap"}),
            (ax3, {"panel": "tracks"})]
    return _render_mapped(fig, info, extra)


def chr_whole_plot(index, genome, chrom, start=None, end=None):
    """Whole-chromosome occupancy overview with the current view window
    shaded.  Returns (png, map), so that a drag on the overview zooms the
    detail view."""
    plt = _pyplot()
    g = index.genomes[genome]
    n = index.ngenomes
    colors = genome_colors(n + 1)
    x, vals = _chrom_bins(g.bitfreq_bins, chrom)
    fig, ax = plt.subplots(figsize=(10, 2.4), constrained_layout=True)
    ax.stackplot(x, vals.T, colors=colors, step="post", linewidth=0)
    size = int(g.seq_len(chrom))
    ax.set_xlim(0, size)
    ax.set_ylim(0, 1)
    if start is not None and end is not None and (start, end) != (0, size):
        ax.axvspan(start, end, color="#d03a3a", alpha=0.18)
        for bx in (start, end):
            ax.axvline(bx, color="#d03a3a", linewidth=1)
    ax.set_xlabel("position (bp)")
    ax.set_ylabel("fraction")
    ax.set_title(f"{genome} {chrom}: occupancy composition")
    return _render_mapped(fig, [(ax, {"chrom": chrom, "size": size})])
