"""Spectral clustering on the operator seam.

Normalized-cut spectral clustering (Ng-Jordan-Weiss 2001 / Shi-Malik
2000), composed entirely from this framework's primitives so every O(n)
or O(nnz) pass runs as matmuls:

1. exact kNN graph over the input rows (``neighbors.knn`` — blocked
   pairwise-distance matmul tiles),
2. symmetric connectivity affinity ``W = (A + A^T) / 2`` held as a
   :class:`SparseMatrix` (padded-ELL device layout),
3. the top-k eigenvectors of the normalized affinity
   ``M = D^{-1/2} W D^{-1/2}`` — equivalently the SMALLEST eigenvectors
   of the symmetric normalized Laplacian — via :func:`block_lanczos_svd`
   on the spectral shift ``I + M`` (PSD, so singular vectors ==
   eigenvectors and the top of the shift is the top of ``M``); each
   Krylov step is one sparse SpMM + diagonal scalings. Block Lanczos is
   load-bearing here: the affinity spectrum clusters tightly under the
   top (relative gaps of 1e-3-1e-4, and exactly-degenerate eigenvalue-1
   multiplets when the kNN graph has several components), where
   randomized subspace iteration needs thousands of power passes but a
   blocked Krylov space resolves the multiplet in tens of steps,
4. row-normalized embedding rows clustered by :class:`KMeans` (matmul
   Lloyd).

The reference ecosystem clusters externally (its similarity kernels are
"for clustering over PCA embeddings", BASELINE.json graded #5); KMeans
covers the convex case and this model the graph/nonconvex case — the
role Leiden/Louvain play in scanpy pipelines, formulated as dense linear
algebra instead of sequential vertex sweeps (which would be hostile to
an accelerator's execution model).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..sparse.matrix import SparseMatrix
from .kmeans import KMeans

__all__ = ["SpectralClustering", "SpectralClusteringBuilder"]


import jax


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class _ShiftedNormalizedAffinity:
    """``(I + D^{-1/2} W D^{-1/2}) v`` products; symmetric, PSD.

    mv == rmv (symmetry); one SpMM plus two diagonal scalings per pass.
    Registered as a pytree so the jitted SVD loops can close over it.
    """

    w: object  # SparseMatrix [n, n]
    s: jnp.ndarray  # D^{-1/2}  [n]

    @property
    def shape(self):
        return self.w.shape

    def mv(self, V):
        MV = self.s[:, None] * self.w.matmul_dense(self.s[:, None] * V)
        return V + MV

    rmv = mv
    mv_fast = mv
    rmv_fast = mv
    mv_precise = mv
    rmv_precise = mv

    def tree_flatten(self):
        return (self.w, self.s), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class SpectralClustering:
    """Normalized-cut clustering of dense rows (e.g. PCA embeddings).

    sklearn-flavor surface: ``fit(X)`` / ``fit_predict(X)`` set
    ``labels_``, ``affinity_matrix_`` (the SparseMatrix W) and
    ``maps_`` (the [n, k] spectral embedding). No out-of-sample
    ``predict`` — like sklearn's, the model is transductive.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        *,
        n_neighbors: int = 15,
        n_init: int = 3,
        random_seed: int = 42,
        lanczos_steps: Optional[int] = None,
        lanczos_block: Optional[int] = None,
    ):
        if n_clusters < 2:
            raise ValueError(f"n_clusters={n_clusters} must be >= 2")
        if n_neighbors < 1:
            raise ValueError(f"n_neighbors={n_neighbors} must be >= 1")
        self.n_clusters = n_clusters
        self.n_neighbors = n_neighbors
        self.n_init = n_init
        self.random_seed = random_seed
        # Krylov depth / block width for the eigensolve; defaults sized
        # for the clustered affinity spectrum (see module docstring)
        self.lanczos_steps = lanczos_steps
        self.lanczos_block = lanczos_block
        self.labels_: Optional[np.ndarray] = None
        self.maps_: Optional[np.ndarray] = None
        self.affinity_matrix_: Optional[SparseMatrix] = None

    def _affinity(self, X) -> SparseMatrix:
        import scipy.sparse as sp

        from ..neighbors import knn

        n = X.shape[0]
        idx = np.asarray(
            knn(X, self.n_neighbors, return_distances=False)
        )
        rows = np.repeat(np.arange(n, dtype=np.int64), self.n_neighbors)
        A = sp.csr_matrix(
            (
                np.ones(rows.size, np.float32),
                (rows, idx.ravel().astype(np.int64)),
            ),
            shape=(n, n),
        )
        W = (A + A.T) * 0.5  # sklearn 'nearest_neighbors' symmetrization
        return SparseMatrix.from_scipy(W.tocsr())

    def fit(self, X) -> "SpectralClustering":
        from ..linalg import block_lanczos_svd

        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"Expected a 2-d array, got shape {X.shape}")
        n = X.shape[0]
        if self.n_clusters > n:
            raise ValueError(
                f"n_clusters={self.n_clusters} exceeds n_samples={n}"
            )
        if self.n_neighbors > n - 1:
            raise ValueError(
                f"n_neighbors={self.n_neighbors} must be <= n-1 ({n - 1})"
            )
        w = self._affinity(X)
        deg = np.asarray(w.sum_row(), np.float64)
        s = jnp.asarray(
            np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)), 0.0),
            jnp.float32,
        )
        op = _ShiftedNormalizedAffinity(w, s)
        b = self.lanczos_block or min(self.n_clusters + 2, n)
        # Krylov dimension: enough blocks to surround the top-k multiplet
        # (the gap under the top cluster is often 1e-3-1e-4 relative)
        kdim = self.lanczos_steps or max(96, 16 * self.n_clusters)
        res = block_lanczos_svd(
            op,
            self.n_clusters,
            block_size=b,
            steps=max(2, -(-kdim // b)),  # block steps = ceil(kdim / b)
            seed=self.random_seed,
        )
        U = np.asarray(res.u)  # [n, k] top eigenvectors of I + M
        # Ng-Jordan-Weiss: row-normalize the embedding before KMeans
        norms = np.linalg.norm(U, axis=1, keepdims=True)
        maps = U / np.maximum(norms, 1e-12)
        km = KMeans(
            self.n_clusters, n_init=self.n_init, random_seed=self.random_seed
        ).fit(maps.astype(np.float32))
        self.labels_ = np.asarray(km.labels_)
        self.maps_ = maps
        self.affinity_matrix_ = w
        return self

    def fit_predict(self, X) -> np.ndarray:
        return self.fit(X).labels_


@dataclasses.dataclass
class SpectralClusteringBuilder:
    """Fluent builder, matching the library's builder style."""

    _n_clusters: int = 8
    _n_neighbors: int = 15
    _n_init: int = 3
    _random_seed: int = 42
    _lanczos_steps: Optional[int] = None
    _lanczos_block: Optional[int] = None

    def n_clusters(self, k: int) -> "SpectralClusteringBuilder":
        self._n_clusters = k
        return self

    def n_neighbors(self, k: int) -> "SpectralClusteringBuilder":
        self._n_neighbors = k
        return self

    def n_init(self, n: int) -> "SpectralClusteringBuilder":
        self._n_init = n
        return self

    def random_seed(self, s: int) -> "SpectralClusteringBuilder":
        self._random_seed = s
        return self

    def lanczos_steps(self, n: int) -> "SpectralClusteringBuilder":
        self._lanczos_steps = n
        return self

    def lanczos_block(self, b: int) -> "SpectralClusteringBuilder":
        self._lanczos_block = b
        return self

    def build(self) -> SpectralClustering:
        return SpectralClustering(
            self._n_clusters,
            n_neighbors=self._n_neighbors,
            n_init=self._n_init,
            random_seed=self._random_seed,
            lanczos_steps=self._lanczos_steps,
            lanczos_block=self._lanczos_block,
        )
