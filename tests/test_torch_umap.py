"""The port's embedding (PCA + DBSCAN on numpy/scipy) against
panagram_tpu.umap_embed.run_embedding (scikit-learn), on the CPU.

Seeded paircount-like frames of shapes that take each of scikit-learn's
PCA solvers ('full', 'covariance_eigh', 'randomized', the last with and
without transposing and with 4 and 7 power iterations), one and two
genomes, and a one-row frame (the zero fallback).  chrom, start, end and
cluster must be exact; umap1/umap2 within 1e-9 absolute.
"""

import numpy as np
import pandas as pd
import pytest

from panagram_tpu.config import UMAPParams as JaxUMAPParams
from panagram_tpu.umap_embed import run_embedding as jax_run_embedding
from panagram_tpu_torch.config import UMAPParams
from panagram_tpu_torch.umap_embed import pca_solver, run_embedding

ATOL = 1e-9


def profiles(rng, rows, cols):
    """Per-bin genome profiles in [0, 1]: a few haplotype groups, noise,
    and each row scaled by its largest entry, as paircount bins are."""
    groups = rng.random((4, cols))
    x = groups[rng.integers(0, 4, rows)] + 0.05 * rng.random((rows, cols))
    return x / x.max(axis=1, keepdims=True)


@pytest.mark.parametrize("rows,cols,solver", [
    (40, 8, "full"),
    (600, 12, "covariance_eigh"),
    (600, 100, "randomized"),
    (450, 520, "randomized"),
    (12, 600, "randomized"),
    (30, 2, "covariance_eigh"),
    (8, 2, "full"),
    (30, 1, "covariance_eigh"),
    (1, 5, None),
])
@pytest.mark.parametrize("eps,samples", [(1, 1), (0.05, 3)])
def test_run_embedding_matches_panagram_tpu(rows, cols, solver, eps, samples):
    rng = np.random.default_rng(rows * 1000 + cols)
    data = profiles(rng, rows, cols)
    if solver is not None:
        assert pca_solver(data.shape, min(2, cols, rows)) == solver
    chroms = [f"chr{1 + i * 3 // rows}" for i in range(rows)]
    starts = np.arange(rows) * 1000
    frame = pd.DataFrame(data, index=pd.MultiIndex.from_arrays(
        [chroms, starts], names=["chrom", "start"]),
        columns=[f"g{i}" for i in range(cols)])
    want = jax_run_embedding(frame, JaxUMAPParams(eps=eps, samples=samples,
                                                  bin_size=1000), "g")
    got = run_embedding(chroms, starts, data,
                        UMAPParams(eps=eps, samples=samples, bin_size=1000),
                        "g")
    assert len(got) == len(want) == rows
    for g, w in zip(got, want.itertuples(index=False)):
        assert (g[0], g[1], g[2], g[5]) == (w.chrom, w.start, w.end,
                                            w.cluster)
        assert abs(g[3] - w.umap1) <= ATOL and abs(g[4] - w.umap2) <= ATOL
    if solver is not None and cols > 1:
        assert any(abs(g[3]) > 1e-6 for g in got)
