"""Reference-to-query transfer: ``ingest`` (scanpy ``tl.ingest`` role).

Map a query dataset onto an annotated reference: both live in the same
embedding space (project the query with the reference's fitted PCA —
``SparsePCA.transform`` — before calling), then labels transfer by
inverse-distance-weighted kNN vote and continuous values (e.g. the
reference's UMAP coordinates) by the same weighted average. The kNN is
the blocked cross-set matmul kernel (``neighbors.cross_knn``); the vote is
one one-hot matmul.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["ingest", "transfer_values"]


def _weights(dists: np.ndarray) -> np.ndarray:
    """Inverse-distance weights, robust to zero distances."""

    d = np.asarray(dists, np.float64)
    zero = d <= 1e-12
    w = 1.0 / np.maximum(d, 1e-12)
    # exact matches dominate: give them all the mass
    has_zero = zero.any(axis=1)
    w[has_zero] = zero[has_zero].astype(np.float64)
    return w / w.sum(axis=1, keepdims=True)


def ingest(
    E_ref,
    E_query,
    labels: Sequence,
    *,
    k: int = 15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Transfer categorical labels from reference to query cells.

    Returns ``(predicted_labels, confidence)`` where confidence is the
    winning class's share of the inverse-distance kNN vote.
    """

    from .neighbors import cross_knn

    E_ref = np.asarray(E_ref, np.float32)
    labels = np.asarray(labels)
    if labels.shape[0] != E_ref.shape[0]:
        raise ValueError(
            f"labels length ({labels.shape[0]}) != reference rows "
            f"({E_ref.shape[0]})"
        )
    names, codes = np.unique(labels, return_inverse=True)
    d, idx = cross_knn(E_query, E_ref, k)
    d, idx = np.asarray(d), np.asarray(idx)
    w = _weights(d)  # [nq, k]
    onehot = np.eye(len(names))[codes[idx]]  # [nq, k, C]
    votes = np.einsum("qk,qkc->qc", w, onehot)
    best = votes.argmax(axis=1)
    return names[best], votes[np.arange(len(best)), best]


def transfer_values(
    E_ref,
    E_query,
    values,
    *,
    k: int = 15,
) -> np.ndarray:
    """Transfer continuous per-cell values (e.g. the reference's UMAP
    coordinates or scores) to query cells by the same weighted kNN
    average. ``values`` is [n_ref] or [n_ref, m]."""

    from .neighbors import cross_knn

    E_ref = np.asarray(E_ref, np.float32)
    V = np.asarray(values, np.float64)
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]
    if V.shape[0] != E_ref.shape[0]:
        raise ValueError(
            f"values rows ({V.shape[0]}) != reference rows "
            f"({E_ref.shape[0]})"
        )
    d, idx = cross_knn(E_query, E_ref, k)
    w = _weights(np.asarray(d))
    out = np.einsum("qk,qkm->qm", w, V[np.asarray(idx)])
    return out[:, 0] if squeeze else out
