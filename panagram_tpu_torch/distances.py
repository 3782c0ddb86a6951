"""Genome-distance matrix: exact Jaccard -> mash-style genome_dist.tsv.

Replaces the reference's external `mash sketch -s 10000` + `mash triangle -E`
(reference workflow/Snakefile:124-149).  Instead of MinHash estimation we
compute *exact* pairwise shared-distinct-kmer counts from the pan-kmer
dictionary's presence masks (a blocked product of bit matrices on the
device, PanKmerDict.pairwise_shared), then apply the Mash distance transform
D = -ln(2j/(1+j))/k.  The output format matches `mash triangle -E`
(5 tab-separated columns: name1, name2, distance, p-value, shared/union)
as parsed by the reference dendrogram code (reference figs.py:53-59).
"""

from __future__ import annotations

import numpy as np


def mash_distance(jaccard: float, k: int) -> float:
    if jaccard <= 0:
        return 1.0
    if jaccard >= 1:
        return 0.0
    return max(0.0, -np.log(2 * jaccard / (1 + jaccard)) / k)


def write_genome_dist(pan_dict, names, out_path: str, *, device="cuda"):
    """pan_dict: PanKmerDict; names: genome names in id order; the shared
    counts are computed on `device`."""
    shared = pan_dict.pairwise_shared(device=device)
    k = pan_dict.k
    with open(out_path, "w") as f:
        for i in range(1, len(names)):
            for j in range(i):
                s = int(shared[i, j])
                union = int(shared[i, i] + shared[j, j] - s)
                jac = s / union if union else 0.0
                d = mash_distance(jac, k)
                f.write(f"{names[i]}\t{names[j]}\t{d:.6g}\t0\t{s}/{union}\n")
    return out_path


def load_genome_dist(path: str, name_to_id) -> np.ndarray:
    n = len(name_to_id)
    mat = np.zeros((n, n), np.float64)
    with open(path) as fh:
        for line in fh:
            a, b, d, p, x = line.rstrip("\n").split("\t")
            i, j = name_to_id[a], name_to_id[b]
            mat[i][j] = mat[j][i] = float(d)
    return mat
