"""GFF3 ingest: gene and annotation tables with Parent-chain names.

The tables of ``panagram_tpu.io.gff.split_gff``, built without pandas:
genes (types in gene_types) and annotations (every other type, or the
listed anno_types), each annotation named after the gene at the end of its
Parent chain.  What pandas decides there is kept: the rows are stably
sorted by (chr, start); an attribute is the first case-insensitive
``<name>=<value>`` anywhere in the attribute string (so ``gene_id=``
answers ``ID``); a Parent chain is followed at most 100 hops; `transcript`
rows are dropped after naming; duplicate annotations keep their first row.
A missing name is None (written as ``nan``, as pandas writes it).
"""

from __future__ import annotations

import gzip
import re

GFF_NAMES = ["chr", "source", "type", "start", "end", "score", "strand",
             "phase", "attr"]
TABIX_COLS = ["chr", "start", "end", "type", "name"]
MAX_PARENT_HOPS = 100


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def read_gff(path) -> list[tuple[str, int, int, str, str]]:
    """(chr, start, end, type, attr) of every feature line; comments,
    blank lines and lines of fewer than 9 columns are skipped."""
    rows = []
    with _open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            rows.append((parts[0], int(parts[3]), int(parts[4]), parts[2],
                         parts[8]))
    return rows


def _attr(attr: str, name: str) -> str | None:
    """The value of `name` in a GFF attribute string, or None."""
    m = re.search(f"{name}=([^;]+)", attr, flags=re.IGNORECASE)
    return m.group(1) if m else None


def split_gff(path, gene_types=("gene",), anno_types=None, name_attr="Name"):
    """Returns (genes, annos):

    genes: [chr, start, end, name] rows, sorted by (chr, start)
    annos: (chr, start, end, type, name) rows in the same order, named
           through their Parent chains, 'transcript' rows removed,
           duplicates dropped
    """
    rows = sorted(read_gff(path), key=lambda r: (r[0], r[1]))
    ids = [_attr(r[4], "ID") for r in rows]
    gene_types = set(gene_types)
    is_gene = [r[3] in gene_types for r in rows]
    gene_rows = [i for i, g in enumerate(is_gene) if g]
    if anno_types is not None:
        anno_types = set(anno_types)
        anno_rows = [i for i, r in enumerate(rows) if r[3] in anno_types]
    else:
        anno_rows = [i for i, g in enumerate(is_gene) if not g]

    def own_name(i):
        name = _attr(rows[i][4], name_attr)
        return ids[i] if name is None else name

    genes = [[rows[i][0], rows[i][1], rows[i][2], own_name(i)]
             for i in gene_rows]
    gene_names: dict[str, str] = {}
    for i, g in zip(gene_rows, genes):
        if ids[i] is not None:
            gene_names.setdefault(ids[i], g[3])
    anno_at: dict[str, int] = {}
    for j, i in enumerate(anno_rows):
        if ids[i] is not None:
            anno_at.setdefault(ids[i], j)

    # every annotation steps to its parent's Parent, all at once, while any
    # points at an annotation (at most MAX_PARENT_HOPS steps)
    parents = [_attr(rows[i][4], "Parent") for i in anno_rows]
    ptr = list(parents)
    for _ in range(MAX_PARENT_HOPS):
        step = [p is not None and p in anno_at for p in ptr]
        if not any(step):
            break
        ptr = [parents[anno_at[p]] if s else p for p, s in zip(ptr, step)]

    annos = []
    seen = set()
    for i, p in zip(anno_rows, ptr):
        r = rows[i]
        if r[3] == "transcript":
            continue
        name = gene_names[p] if p in gene_names else own_name(i)
        row = (r[0], r[1], r[2], r[3], name)
        if row not in seen:
            seen.add(row)
            annos.append(row)
    return genes, annos
