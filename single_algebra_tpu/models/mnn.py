"""Mutual-nearest-neighbors batch correction (Haghverdi et al. 2018).

The MNN alternative to :func:`harmony` (embedding-space) and
``preprocess.combat`` (expression-space): batches are corrected
sequentially onto a growing reference. For each new batch, MNN pairs
come from two blocked cross-set matmul kNN passes
(``neighbors.cross_knn``); each cell's correction is the
Gaussian-kernel weighted average of its batch's pair vectors — one
dense kernel matmul. Works on any dense per-cell representation
(PCA embedding or expression).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = ["mnn_correct", "MNNResult"]


@dataclasses.dataclass
class MNNResult:
    corrected: np.ndarray  # [n, d] in the ORIGINAL row order
    n_pairs: List[int]  # MNN pairs found per merge step
    batch_order: List


def _mnn_pairs(R: np.ndarray, B: np.ndarray, k: int):
    """Mutual kNN pairs between reference rows and batch rows."""

    from ..neighbors import cross_knn

    _, b_to_r = cross_knn(B, R, min(k, R.shape[0]))
    _, r_to_b = cross_knn(R, B, min(k, B.shape[0]))
    b_to_r = np.asarray(b_to_r)
    r_to_b = np.asarray(r_to_b)
    fwd = {(b, r) for b in range(B.shape[0]) for r in b_to_r[b]}
    pairs = [
        (r, b)
        for r in range(R.shape[0])
        for b in r_to_b[r]
        if (b, r) in fwd
    ]
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def mnn_correct(
    X,
    batch: Sequence,
    *,
    k: int = 20,
    sigma: float = 1.0,
    iterations: int = 2,
) -> MNNResult:
    """Correct batches onto the first batch's coordinate frame.

    X : dense [n, d] (embedding or expression). batch : length-n
    labels; batches merge in first-appearance order (scanpy's
    convention — put the highest-quality batch first). ``sigma`` scales
    the per-cell Gaussian smoothing kernel (bandwidth = distance to the
    kth nearest pair anchor).

    ``iterations``: MNN pair vectors are edge-biased (mutual nearest
    cells sit on the facing edges of their clusters, so one pass
    under-corrects by about a cluster radius); re-deriving pairs on the
    partially-corrected data converges the bias out. ``iterations=1``
    is the vanilla Haghverdi correction.
    """

    if iterations < 1:
        raise ValueError(f"iterations={iterations} must be >= 1")
    res = None
    for _ in range(iterations):
        res = _mnn_once(X, batch, k=k, sigma=sigma)
        X = res.corrected
    return res


def _mnn_once(X, batch, *, k: int, sigma: float) -> MNNResult:
    X = np.asarray(X, np.float32)
    if X.ndim != 2:
        raise ValueError(f"X must be [n, d], got {X.shape}")
    n = X.shape[0]
    batch = np.asarray(list(batch))
    if batch.shape[0] != n:
        raise ValueError(f"batch length ({batch.shape[0]}) != rows ({n})")
    order = list(dict.fromkeys(batch.tolist()))
    if len(order) < 2:
        return MNNResult(X.copy(), [], order)

    out = X.copy()
    ref_rows = np.where(batch == order[0])[0]
    n_pairs = []
    for b in order[1:]:
        rows = np.where(batch == b)[0]
        R, B = out[ref_rows], out[rows]
        pairs = _mnn_pairs(R, B, k)
        n_pairs.append(len(pairs))
        if len(pairs) == 0:
            ref_rows = np.concatenate([ref_rows, rows])
            continue
        vec = R[pairs[:, 0]] - B[pairs[:, 1]]  # [P, d]
        anchors = B[pairs[:, 1]]  # [P, d]
        d2 = (
            np.sum(B * B, 1)[:, None]
            - 2.0 * np.asarray(jnp.asarray(B) @ jnp.asarray(anchors).T)
            + np.sum(anchors * anchors, 1)[None, :]
        )  # [nb, P]
        d2 = np.maximum(d2, 0.0)
        # per-cell adaptive bandwidth: distance to the kth nearest
        # anchor, so smoothing stays LOCAL (a global bandwidth mixes
        # correction vectors across clusters and dilutes the shift)
        kth = min(k, d2.shape[1] - 1)
        h2 = sigma * sigma * np.maximum(
            np.partition(d2, kth, axis=1)[:, kth], 1e-12
        )
        Wk = np.exp(-d2 / (2.0 * h2[:, None] + 1e-30))
        Wk /= np.maximum(Wk.sum(1, keepdims=True), 1e-30)
        out[rows] = B + np.asarray(
            jnp.asarray(Wk.astype(np.float32)) @ jnp.asarray(vec)
        )
        ref_rows = np.concatenate([ref_rows, rows])
    return MNNResult(out, n_pairs, order)
