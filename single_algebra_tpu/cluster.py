"""Graph community detection: Leiden clustering.

The clustering stage of the scRNA pipeline (scanpy ``tl.leiden``
semantics, RBConfiguration quality with a resolution parameter). The
hot path is the native C++ core (``native/leiden.cpp`` — queue-based
local moving + refinement + aggregation, Traag et al. 2019): community
detection is a pointer-chasing irregular-graph workload that belongs on
the host, sitting between two device stages (kNN graph construction
upstream, DE / embedding downstream). A pure-Python Louvain-style
fallback keeps the API available without a compiler
(``SINGLE_ALGEBRA_TPU_NO_NATIVE=1``).

The reference ships no clustering (its users call leidenalg); this
module closes that pipeline gap. Graph input is whatever
:func:`single_algebra_tpu.neighbors.connectivities` produces, any
symmetric scipy sparse matrix, or a :class:`SparseMatrix`.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import numpy as np

__all__ = ["leiden", "LeidenResult", "modularity", "paga", "dendrogram"]


@dataclasses.dataclass
class LeidenResult:
    labels: np.ndarray  # int32 [n], contiguous community ids
    n_communities: int
    quality: float  # RBConfiguration quality at the used resolution
    backend: str  # 'native' or 'python'

    def __repr__(self):
        return (
            f"LeidenResult(n_communities={self.n_communities}, "
            f"quality={self.quality:.4f}, backend={self.backend!r})"
        )


def _as_sym_csr(adjacency):
    """Any accepted graph input -> symmetric scipy CSR (f32, no dupes)."""

    import scipy.sparse as sp

    a = adjacency
    if hasattr(a, "to_scipy"):  # SparseMatrix
        a = a.to_scipy()
    if not sp.issparse(a):
        raise TypeError(
            "adjacency must be a scipy sparse matrix or SparseMatrix; "
            "for dense embeddings build a graph with "
            "neighbors.connectivities(X, k) first"
        )
    a = a.tocsr().astype(np.float32)
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"adjacency must be square, got {a.shape}")
    at = a.T.tocsr()
    if (a != at).nnz:
        a = (a + at) * 0.5  # symmetrize directed inputs
    a.sum_duplicates()
    a.eliminate_zeros()
    if (a.data < 0).any():
        raise ValueError("adjacency weights must be non-negative")
    return a


def modularity(adjacency, labels, *, resolution: float = 1.0) -> float:
    """RBConfiguration quality of a labeling:
    ``sum_c [e_c/m2 - resolution * (tot_c/m2)^2]`` (e_c double-counted)."""

    a = _as_sym_csr(adjacency)
    labels = np.asarray(labels)
    n = a.shape[0]
    if labels.shape != (n,):
        raise ValueError(f"labels must have shape ({n},)")
    strength = np.asarray(a.sum(axis=1)).ravel().astype(np.float64)
    m2 = strength.sum()
    if m2 <= 0:
        return 0.0
    coo = a.tocoo()
    intra = coo.data[labels[coo.row] == labels[coo.col]].sum()
    k = labels.max() + 1 if n else 0
    tot = np.bincount(labels, weights=strength, minlength=k)
    return float(intra / m2 - resolution * ((tot / m2) ** 2).sum())


def leiden(
    adjacency,
    *,
    resolution: float = 1.0,
    seed: int = 0,
    max_levels: int = 10,
) -> LeidenResult:
    """Cluster a (symmetric, weighted) graph with the Leiden algorithm.

    Parameters
    ----------
    adjacency : scipy sparse / SparseMatrix, [n, n]. Directed inputs are
        symmetrized as ``(A + A.T) / 2``. Use
        ``neighbors.connectivities(X, n_neighbors)`` to build one from an
        embedding (scanpy's pp.neighbors -> tl.leiden chain).
    resolution : RBConfiguration resolution (higher -> more, smaller
        communities). 1.0 is classic modularity.
    seed : RNG seed for the node-visit orders (deterministic output).
    max_levels : aggregation level cap (10 is far beyond convergence on
        real graphs).
    """

    a = _as_sym_csr(adjacency)
    n = a.shape[0]
    if n == 0:
        return LeidenResult(np.empty(0, np.int32), 0, 0.0, "native")
    from .native.build import leiden_native

    out = leiden_native(
        a.indptr.astype(np.int64), a.indices, a.data, n,
        resolution, seed, max_levels,
    )
    if out is not None:
        labels, k, q = out
        return LeidenResult(labels, k, q, "native")

    labels = _leiden_py(
        a.indptr.astype(np.int64), a.indices.astype(np.int64),
        a.data.astype(np.float64), n, resolution, seed, max_levels,
    )
    k = int(labels.max()) + 1 if n else 0
    return LeidenResult(
        labels, k, modularity(a, labels, resolution=resolution), "python"
    )


def paga(adjacency, labels) -> np.ndarray:
    """Partition-based graph abstraction (Wolf et al. 2019; scanpy
    ``tl.paga`` v1.2 null model).

    Aggregates the single-cell kNN graph over a partition (e.g. Leiden
    labels) and scores each cluster pair by observed inter-cluster edge
    count over the expectation under random edge placement:

        conn[i, j] = min(e_ij / ((es_i * n_j + es_j * n_i) / (n - 1)), 1)

    with ``e_ij`` the undirected inter-edge count, ``es_i`` cluster i's
    total incident edge count, ``n_i`` its size. Returns a dense
    symmetric [k, k] float64 array with zero diagonal — the abstracted
    graph trajectory tools and coarse layouts consume.
    """

    import scipy.sparse as sp

    a = _as_sym_csr(adjacency)
    n = a.shape[0]
    labels = np.asarray(labels)
    if labels.shape != (n,):
        raise ValueError(f"labels must have shape ({n},)")
    _, codes = np.unique(labels, return_inverse=True)
    k = int(codes.max()) + 1
    if n < 2 or k < 2:
        return np.zeros((k, k))

    ones = a.copy()
    ones.data = np.ones_like(ones.data)
    onehot = sp.csr_matrix(
        (np.ones(n), (np.arange(n), codes)), shape=(n, k)
    )
    M = np.asarray((onehot.T @ ones @ onehot).todense(), np.float64)
    # symmetric A stores each undirected edge twice: M_ij (i != j) counts
    # e_ij once per direction-slot; M_ii double-counts inner edges
    e = M.copy()
    np.fill_diagonal(e, 0.0)
    inner = np.diag(M) / 2.0
    es = inner + e.sum(axis=1)
    ns = np.bincount(codes, minlength=k).astype(np.float64)

    expected = (es[:, None] * ns[None, :] + es[None, :] * ns[:, None]) / (
        n - 1.0
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        conn = np.where(expected > 0, e / np.where(expected > 0, expected, 1.0), 0.0)
    conn = np.minimum(conn, 1.0)
    np.fill_diagonal(conn, 0.0)
    return conn


def dendrogram(
    embedding,
    labels,
    *,
    method: str = "complete",
    metric: str = "correlation",
):
    """Hierarchical clustering of GROUPS (scanpy ``tl.dendrogram``):
    group means in embedding (PCA) space, pairwise ``metric`` distance,
    scipy ``linkage``. Returns a dict with the linkage matrix,
    group names in input order, and the leaf order."""

    from scipy.cluster import hierarchy
    from scipy.spatial.distance import pdist

    E = np.asarray(embedding, np.float64)
    labels = np.asarray(labels)
    if labels.shape[0] != E.shape[0]:
        raise ValueError(
            f"labels length ({labels.shape[0]}) != rows ({E.shape[0]})"
        )
    names, codes = np.unique(labels, return_inverse=True)
    if len(names) < 2:
        raise ValueError("need at least 2 groups")
    onehot = np.eye(len(names))[codes]
    means = (onehot.T @ E) / onehot.sum(axis=0)[:, None]
    Z = hierarchy.linkage(pdist(means, metric=metric), method=method)
    order = hierarchy.leaves_list(Z)
    return {
        "linkage": Z,
        "groups": names,
        "order": names[order],
        "group_means": means,
    }


# ----------------------------------------------------------------------
# pure-Python fallback (Louvain-style: local move + aggregate)
# ----------------------------------------------------------------------


def _local_move_py(indptr, indices, weights, strength, m2, comm, gamma, rng):
    n = len(strength)
    tot = defaultdict(float)
    for v in range(n):
        tot[comm[v]] += strength[v]
    order = rng.permutation(n)
    queue = list(order)
    in_queue = np.ones(n, bool)
    head = 0
    moves = 0
    next_id = max(comm) + 1 if n else 0
    inv_m2 = 1.0 / m2 if m2 > 0 else 0.0
    while head < len(queue):
        v = queue[head]
        head += 1
        in_queue[v] = False
        cv = comm[v]
        tot[cv] -= strength[v]
        kvc = defaultdict(float)
        for e in range(indptr[v], indptr[v + 1]):
            u = indices[e]
            if u != v:
                kvc[comm[u]] += weights[e]
        best, best_gain = cv, kvc[cv] - gamma * strength[v] * tot[cv] * inv_m2
        if best_gain < 0:
            best, best_gain = -1, 0.0  # fresh singleton baseline
        for c, w in kvc.items():
            gain = w - gamma * strength[v] * tot[c] * inv_m2
            if gain > best_gain + 1e-15:
                best, best_gain = c, gain
        if best == -1:
            best = next_id
            next_id += 1
        tot[best] += strength[v]
        if best != cv:
            comm[v] = best
            moves += 1
            for e in range(indptr[v], indptr[v + 1]):
                u = indices[e]
                if u != v and comm[u] != best and not in_queue[u]:
                    in_queue[u] = True
                    queue.append(u)
    return moves


def _leiden_py(indptr, indices, weights, n, gamma, seed, max_levels):
    """Louvain-style fallback (no refinement phase): same local-move and
    aggregation machinery, pure numpy/python. Slow but dependency-free."""

    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    labels = np.arange(n, dtype=np.int64)
    cur = sp.csr_matrix(
        (weights, indices, indptr), shape=(n, n)
    )
    for _ in range(max_levels):
        m = cur.shape[0]
        strength = np.asarray(cur.sum(axis=1)).ravel()
        m2 = strength.sum()
        comm = list(range(m))
        moves = _local_move_py(
            cur.indptr, cur.indices, cur.data, strength, m2, comm, gamma, rng
        )
        comm = np.asarray(comm)
        _, comm = np.unique(comm, return_inverse=True)
        k = comm.max() + 1 if m else 0
        labels = comm[labels]
        if moves == 0 or k == m:
            break
        onehot = sp.csr_matrix(
            (np.ones(m), (np.arange(m), comm)), shape=(m, k)
        )
        cur = (onehot.T @ cur @ onehot).tocsr()
    return labels.astype(np.int32)
