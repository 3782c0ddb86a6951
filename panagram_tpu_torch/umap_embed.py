"""2-D embeddings + clustering of per-bin paircount profiles.

``panagram_tpu.umap_embed`` embeds each genomic bin's normalized
shared-k-mer profile into 2-D with UMAP when umap-learn is installed, and
otherwise with scikit-learn's ``PCA(n_components=2, random_state=42)``,
then clusters the points with ``DBSCAN(eps, min_samples)``.  Neither
package is installed where this port runs, so this module restates that
PCA branch with numpy and scipy, solver for solver as scikit-learn 1.9
picks them (``PCA._fit``):

* ``covariance_eigh`` when n_features <= 1000 and n_samples >= 10 x
  n_features (eigh of the covariance matrix);
* ``full`` when the larger side is <= 500, or when n_components >= 0.8 x
  the smaller side (scipy's gesdd SVD of the centred data);
* ``randomized`` otherwise (Halko et al.: RandomState(42) Gaussian start,
  4 or 7 LU-normalized power iterations, QR, SVD of the projection);

each with scikit-learn's sign rule (``svd_flip`` on the rows of Vt).  DBSCAN
is a radius query (distance <= eps, scipy's cKDTree) and scikit-learn's
label order: points in index order, a depth-first expansion from each
unlabelled core point, noise -1.  The matrices are bins x genomes, a few
thousand rows at most, so this runs on the host.  UMAP proper is not
ported.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

RANDOM_STATE = 42
N_OVERSAMPLES = 10


def preload():
    """Import the scipy modules the embeddings call (the first import takes
    most of a second).  A build calls this once per process before its
    first stage timer, so that no anchor stage's wall holds the import;
    importing this module does not."""
    import scipy.linalg  # noqa: F401
    import scipy.spatial  # noqa: F401


def svd_flip_rows(u, vt):
    """scikit-learn's svd_flip(u, vt, u_based_decision=False): each row of
    vt (and column of u) signed so that its largest |entry| is positive."""
    signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    if u is not None:
        u *= signs[np.newaxis, :]
    vt *= signs[:, np.newaxis]
    return u, vt


def pca_solver(shape, n_components: int) -> str:
    """The solver of scikit-learn's svd_solver='auto' for a dense matrix."""
    n_samples, n_features = shape
    if n_features <= 1000 and n_samples >= 10 * n_features:
        return "covariance_eigh"
    if max(shape) <= 500:
        return "full"
    if 1 <= n_components < 0.8 * min(shape):
        return "randomized"
    return "full"


def _randomized_svd(M, n_components: int, rng):
    """scikit-learn's _randomized_svd(M, n_components, flip_sign=False)
    with its defaults: 10 oversamples, n_iter 'auto', LU normalizer."""
    from scipy import linalg

    n_random = n_components + N_OVERSAMPLES
    n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
    transpose = M.shape[0] < M.shape[1]
    if transpose:
        M = M.T
    Q = rng.normal(size=(M.shape[1], n_random))
    for _ in range(n_iter):
        Q, _ = linalg.lu(M @ Q, permute_l=True, check_finite=False)
        Q, _ = linalg.lu(M.T @ Q, permute_l=True, check_finite=False)
    Q, _ = linalg.qr(M @ Q, mode="economic", check_finite=False)
    B = Q.T @ M
    Uhat, s, Vt = linalg.svd(B, full_matrices=False, lapack_driver="gesdd")
    U = Q @ Uhat
    if transpose:
        return Vt[:n_components, :].T, s[:n_components], U[:, :n_components].T
    return U[:, :n_components], s[:n_components], Vt[:n_components, :]


def pca_fit(X: np.ndarray, n_components: int):
    """(fit_transform(X), explained_variance_ratio_) of scikit-learn 1.9's
    PCA(n_components, random_state=42), for a dense float64 X."""
    from scipy import linalg

    X = np.asarray(X, dtype=np.float64)
    n_samples = X.shape[0]
    mean = np.mean(X, axis=0)
    solver = pca_solver(X.shape, n_components)
    if solver == "covariance_eigh":
        C = X.T @ X
        C -= n_samples * np.reshape(mean, (-1, 1)) * np.reshape(mean, (1, -1))
        C /= n_samples - 1
        eigenvals, eigenvecs = np.linalg.eigh(C)
        variance = np.flip(eigenvals)
        variance[variance < 0.0] = 0.0
        _, Vt = svd_flip_rows(None, np.flip(eigenvecs, axis=1).T)
        components = np.array(Vt[:n_components, :], copy=True)
        out = X @ components.T
        out -= np.reshape(mean, (1, -1)) @ components.T
        total = np.sum(variance)
    else:
        Xc = np.array(X, copy=True)
        Xc -= mean
        if solver == "full":
            U, S, Vt = linalg.svd(Xc, full_matrices=False)
        else:
            U, S, Vt = _randomized_svd(Xc, n_components,
                                       np.random.RandomState(RANDOM_STATE))
        variance = S**2 / (n_samples - 1)
        # the randomized solver has the leading components only: its ratio
        # is over the data's total variance
        total = np.sum(variance) if solver == "full" \
            else np.sum(Xc**2) / (n_samples - 1)
        U, Vt = svd_flip_rows(U, Vt)
        out = U[:, :n_components]
        out *= S[:n_components]
    # constant data: 0 / 0, NaN ratios (scikit-learn warns)
    with np.errstate(invalid="ignore", divide="ignore"):
        return out, (variance / total)[:n_components]


def dbscan_labels(X: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN(eps, min_samples).fit_predict(X) of scikit-learn (Euclidean
    distance, neighbours within eps inclusive, each point its own
    neighbour)."""
    from scipy.spatial import cKDTree

    neighbors = cKDTree(X).query_ball_point(X, r=eps)
    core = np.array([len(nb) >= min_samples for nb in neighbors], bool)
    labels = np.full(len(X), -1, np.int64)
    label = 0
    for i0 in range(len(X)):
        if labels[i0] != -1 or not core[i0]:
            continue
        stack = [i0]
        while stack:
            i = stack.pop()
            if labels[i] != -1:
                continue
            labels[i] = label
            if core[i]:
                stack.extend(v for v in neighbors[i] if labels[v] == -1)
        label += 1
    return labels


def _embed(data: np.ndarray) -> np.ndarray | None:
    """The 2-D embedding of panagram_tpu.umap_embed._embed's PCA branch:
    None below two rows or on a failure; fewer than 2 components are
    padded with zero columns."""
    if len(data) < 2:
        return None
    try:
        n_comp = min(2, data.shape[1], len(data))
        emb = pca_fit(data, n_comp)[0]
        if emb.shape[1] < 2:
            emb = np.pad(emb, ((0, 0), (0, 2 - emb.shape[1])))
        return emb
    except (ValueError, np.linalg.LinAlgError) as e:
        logger.warning(f"embedding failed: {e}")
        return None


def run_embedding(chroms: list, starts: np.ndarray, data: np.ndarray, params,
                  genome_name: str = "") -> list[tuple]:
    """data: float64 [bins, genomes], one row per (chroms[i], starts[i]).
    Returns (chrom, start, end, umap1, umap2, cluster) rows, end = start +
    params.bin_size; a frame that cannot be embedded gets zeros and cluster
    0, with a warning, as panagram_tpu's run_embedding."""
    emb = _embed(data)
    if emb is not None:
        clusters = dbscan_labels(emb, params.eps, params.samples)
    else:
        logger.warning(f"{genome_name} embedding failed for at least one "
                       "chromosome")
        emb = np.zeros((len(data), 2))
        clusters = np.zeros(len(data), np.int64)
    return [(c, int(s), int(s) + params.bin_size, float(u1), float(u2), int(cl))
            for c, s, (u1, u2), cl in zip(chroms, starts, emb, clusters)]
