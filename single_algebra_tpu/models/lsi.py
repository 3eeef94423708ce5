"""Latent semantic indexing — the scATAC dimensionality reduction.

TF-IDF (``preprocess.tfidf``) followed by a truncated UNcentered SVD over
the engine-operator seam — the same matmul-backed randomized SVD the PCA
surfaces use (``linalg/svd.py``), with centering simply not requested.
Mirrors Signac ``RunSVD`` / muon ``atac.tl.lsi``; the reference's nearest
analog is the Lanczos SparsePCA path, which is likewise a truncated SVD of
the raw matrix (``/root/reference/src/dimred/pca/sparse/mod.rs:134-144``
never centers — SURVEY §3.2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

__all__ = ["LSIResult", "lsi"]


@dataclasses.dataclass
class LSIResult:
    """Fitted LSI factorization.

    ``scores`` [n, k] cell embeddings (U * S), ``components`` [k, p]
    right singular vectors, ``singular_values`` [k],
    ``explained_variance_ratio`` [k] (variance of each score column over
    the total TF-IDF variance — the TruncatedSVD convention). When
    ``drop_first`` was set, component 0 (the depth-correlated one) has
    already been removed from every field.
    """

    scores: np.ndarray
    components: np.ndarray
    singular_values: np.ndarray
    explained_variance_ratio: np.ndarray

    @property
    def n_components(self) -> int:
        return int(self.singular_values.shape[0])

    def __repr__(self):
        return (
            f"LSIResult(n_components={self.n_components}, "
            f"n_cells={self.scores.shape[0]})"
        )


def lsi(
    m,
    n_components: int = 50,
    *,
    apply_tfidf: bool = True,
    scale_factor: float = 1e4,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
    drop_first: bool = True,
    engine: str = "auto",
    n_oversamples: int = 10,
    n_power_iterations: int = 7,
    seed: int = 42,
    scale_embeddings: bool = True,
) -> LSIResult:
    """LSI of a cells x peaks ``SparseMatrix``: TF-IDF -> truncated SVD.

    ``drop_first=True`` (the Signac/muon convention) computes one extra
    component and removes the first, which tracks sequencing depth in
    scATAC data. ``scale_embeddings`` z-scores each score column (muon
    default), leaving ``singular_values`` untouched.
    ``apply_tfidf=False`` skips the normalization for inputs already
    TF-IDF-transformed.
    """

    from ..linalg import randomized_svd, svd_flip
    from ..preprocess import tfidf as _tfidf
    from .pca import make_engine_operator

    n, p = m.shape
    k = int(n_components)
    k_fit = k + (1 if drop_first else 0)
    if not 1 <= k_fit <= min(n, p):
        raise ValueError(
            f"n_components={n_components} (+drop_first={drop_first}) out of "
            f"range for shape {m.shape}"
        )
    x = (
        _tfidf(
            m,
            scale_factor=scale_factor,
            log_tf=log_tf,
            log_idf=log_idf,
            log_tfidf=log_tfidf,
        )
        if apply_tfidf
        else m
    )
    op = make_engine_operator(x, engine)
    res = randomized_svd(
        op,
        k_fit,
        n_oversamples=n_oversamples,
        n_power_iterations=n_power_iterations,
        seed=seed,
    )
    u, vt = svd_flip(res.u, res.vt)
    s = res.s
    scores = u * s[None, :]
    # TruncatedSVD-convention explained variance of the score columns
    col_mean = jnp.mean(scores, axis=0)
    exp_var = jnp.mean(scores * scores, axis=0) - col_mean * col_mean
    total_var = float(np.sum(np.asarray(x.var_col(), np.float64))) * (
        (n - 1) / n if n > 1 else 1.0
    )
    ratio = np.asarray(exp_var, np.float64) / max(total_var, 1e-300)

    scores = np.asarray(scores)
    vt = np.asarray(vt)
    s = np.asarray(s)
    if drop_first:
        scores, vt, s, ratio = scores[:, 1:], vt[1:], s[1:], ratio[1:]
    if scale_embeddings:
        mu = scores.mean(axis=0, keepdims=True)
        sd = scores.std(axis=0, keepdims=True)
        scores = (scores - mu) / np.where(sd > 0, sd, 1.0)
    return LSIResult(
        scores=scores,
        components=vt,
        singular_values=s,
        explained_variance_ratio=ratio,
    )
