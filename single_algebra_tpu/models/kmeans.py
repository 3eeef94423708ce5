"""KMeans clustering as matmuls.

Completes the reference ecosystem's pipeline: the reference ships
similarity/distance kernels "over PCA embeddings for clustering"
(BASELINE.json graded config #5; orphan ``/root/reference/src/similarity/
mod.rs``) but no clusterer — downstream SingleRust code clusters
externally. This module is the device clusterer those distances feed.

Accelerator-first formulation — every O(n) pass is a matmul:

- assignment: ``d2 = |x|^2 + |c|^2 - 2 X C^T`` with the cross term as one
  [n, d] x [d, k] matmul; argmin over the k axis.
- update: ``C = H^T X / counts`` where ``H`` is the one-hot assignment
  matrix — a second matmul (for sparse X it rides the padded-ELL
  SpMM, so KMeans also runs directly on expression matrices without
  densifying).
- k-means++ init: the D^2-sampling recurrence as a ``fori_loop`` of
  matvecs; categorical sampling via ``jax.random`` (seeded, reproducible).
- Lloyd loop: ``lax.while_loop`` on (centroid shift^2 > tol) & (it <
  max_iter), fully on device; empty clusters are re-seeded to the points
  currently farthest from their centers (computed under ``lax.cond`` so
  the healthy path pays nothing).

sklearn-compatible semantics where they matter: ``tol`` is scaled by the
mean per-feature variance of the input (sklearn's ``_tolerance``), and
``inertia_`` is the summed squared distance at the final assignment.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.matrix import SparseMatrix

__all__ = ["KMeans", "KMeansBuilder"]


def _is_sparse(X) -> bool:
    # X is either a dense array or an (Xr, Xc) pair of SparseMatrix
    # layouts (row-major + col-major, materialized OUTSIDE jit — the
    # transpose needs host CSR structure a tracer cannot provide)
    return isinstance(X, tuple)


def _sparse_ops(m: SparseMatrix):
    """Pre-materialize both ELL layouts of ``m`` so every product inside
    the jitted fit is a pure device kernel."""

    return (m._layout_for("row"), m._layout_for("col"))


def _xdot(X, C_t: jnp.ndarray) -> jnp.ndarray:
    """``X @ C_t`` for dense or sparse X; C_t is [d, k]. f32 out
    (KMeans is an f32 model regardless of the matrix dtype/x64 mode)."""

    if _is_sparse(X):
        Xr = X[0]
        return Xr.matmul_dense(C_t.astype(Xr.dtype)).astype(jnp.float32)
    return X @ C_t


def _xtdot(X, H: jnp.ndarray) -> jnp.ndarray:
    """``X.T @ H`` ([d, k]) for dense or sparse X; H is [n, k]."""

    if _is_sparse(X):
        Xc = X[1]
        return Xc.rmatmul_dense(H.astype(Xc.dtype)).astype(jnp.float32)
    return X.T @ H


def _row_sq_norms(X) -> jnp.ndarray:
    if _is_sparse(X):
        return X[0].sum_row_squared().astype(jnp.float32)
    return jnp.sum(X * X, axis=1)


def _gather_rows(X, idx: jnp.ndarray, k: int) -> jnp.ndarray:
    """X[idx] as dense f32 [k, d]; for sparse X via an indicator SpMM."""

    if _is_sparse(X):
        n = _n_of(X)
        H = (idx[None, :] == jnp.arange(n)[:, None]).astype(jnp.float32)
        return _xtdot(X, H).T  # [k, d]
    return X[idx]


def _n_of(X) -> int:
    return X[0].nrows if _is_sparse(X) else X.shape[0]


def _d_of(X) -> int:
    return X[0].ncols if _is_sparse(X) else X.shape[1]


def _pairwise_d2(x2: jnp.ndarray, X, C: jnp.ndarray) -> jnp.ndarray:
    """Squared distances [n, k]; cross term as a matmul."""

    c2 = jnp.sum(C * C, axis=1)
    xc = _xdot(X, C.T)
    return x2[:, None] + c2[None, :] - 2.0 * xc


def _plusplus_init(key, X, x2: jnp.ndarray, w: jnp.ndarray, k: int) -> jnp.ndarray:
    """k-means++ D^2 sampling (Arthur & Vassilvitskii 2007), on device.

    ``w`` is a {0,1} row-validity mask: zero-weight rows (mesh padding)
    can never be sampled as seeds.
    """

    NEG = jnp.float32(-1e30)  # -inf-like logit for padded rows
    k0, key = jax.random.split(key)
    first = jax.random.categorical(k0, jnp.where(w > 0, 0.0, NEG))
    d = _d_of(X)
    C = jnp.zeros((k, d), jnp.float32)
    C = C.at[0].set(_gather_rows(X, first[None], 1)[0])
    c0 = C[0]
    min_d2 = jnp.maximum(
        x2 - 2.0 * _xdot(X, c0[:, None])[:, 0] + jnp.sum(c0 * c0), 0.0
    )

    def body(i, state):
        C, min_d2 = state
        ki = jax.random.fold_in(key, i)
        logits = jnp.where(w > 0, jnp.log(jnp.maximum(min_d2, 1e-30)), NEG)
        idx = jax.random.categorical(ki, logits)
        c = _gather_rows(X, idx[None], 1)[0]
        C = C.at[i].set(c)
        d2 = jnp.maximum(
            x2 - 2.0 * _xdot(X, c[:, None])[:, 0] + jnp.sum(c * c), 0.0
        )
        return C, jnp.minimum(min_d2, d2)

    C, _ = jax.lax.fori_loop(1, k, body, (C, min_d2))
    return C


@functools.partial(jax.jit, static_argnames=("k", "max_iter"))
def _fit_one(X, x2, tol2, key, w, *, k: int, max_iter: int):
    """One full KMeans run: ++init then Lloyd to convergence.

    ``w`` is a {0,1} f32 row-validity mask (all-ones when unpadded; mesh
    mode pads rows to a device-divisible count and zero-weights the pad).
    Returns (centers [k, d], labels [n], inertia scalar, n_iter); labels
    of padded rows are meaningless and sliced off by the caller.
    """

    C0 = _plusplus_init(key, X, x2, w, k)

    def lloyd(state):
        C, _, it = state
        d2 = _pairwise_d2(x2, X, C)
        labels = jnp.argmin(d2, axis=1)
        H = (labels[:, None] == jnp.arange(k)[None, :]) * w[:, None]
        counts = jnp.sum(H, axis=0)
        sums = _xtdot(X, H).T  # [k, d]
        new_C = sums / jnp.maximum(counts, 1.0)[:, None]

        def reseed(new_C):
            # farthest points from their centers take over empty clusters
            point_d2 = (
                jnp.take_along_axis(d2, labels[:, None], axis=1)[:, 0] * w
            )
            far = jax.lax.top_k(point_d2, k)[1]
            far_rows = _gather_rows(X, far, k)
            return jnp.where((counts == 0)[:, None], far_rows, new_C)

        new_C = jax.lax.cond(
            jnp.any(counts == 0), reseed, lambda c: c, new_C
        )
        shift2 = jnp.sum((new_C - C) ** 2)
        return new_C, shift2, it + 1

    def cond(state):
        _, shift2, it = state
        return (shift2 > tol2) & (it < max_iter)

    C, _, n_iter = jax.lax.while_loop(
        cond, lloyd, (C0, jnp.asarray(jnp.inf, jnp.float32), 0)
    )
    d2 = _pairwise_d2(x2, X, C)
    labels = jnp.argmin(d2, axis=1).astype(jnp.int32)
    inertia = jnp.sum(
        jnp.maximum(jnp.take_along_axis(d2, labels[:, None], axis=1), 0.0)
        * w[:, None]
    )
    return C, labels, inertia, n_iter


@functools.partial(jax.jit, static_argnames=("k",))
def _assign(X, x2, C, *, k: int):
    d2 = _pairwise_d2(x2, X, C)
    return jnp.argmin(d2, axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def _minibatch_step(X, x2, C, counts, *, k: int):
    """One MiniBatchKMeans update (Sculley 2010 / sklearn semantics):
    assign the batch, then move each center toward its batch mean with a
    per-center learning rate 1/total_count. All matmuls: assignment is the
    d2 cross-term matmul, the batch sums are one X^T H product."""

    d2 = _pairwise_d2(x2, X, C)
    labels = jnp.argmin(d2, axis=1)
    H = (labels[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    batch_counts = jnp.sum(H, axis=0)
    batch_sums = _xtdot(X, H).T  # [k, d]
    new_counts = counts + batch_counts
    # C += (sums - batch_count * C) / total_count  (no-op for empty centers)
    C = C + (batch_sums - batch_counts[:, None] * C) / jnp.maximum(
        new_counts, 1.0
    )[:, None]
    inertia = jnp.sum(
        jnp.maximum(jnp.take_along_axis(d2, labels[:, None], axis=1), 0.0)
    )
    return C, new_counts, labels.astype(jnp.int32), inertia


def _prep(X):
    """Canonicalize input: dense arrays to f32 jnp; a SparseMatrix to its
    (row-major, col-major) layout pair (host-side, cached per matrix)."""

    if isinstance(X, SparseMatrix):
        return _sparse_ops(X)
    if _is_sparse(X):  # already a layout pair (internal re-entry)
        return X
    X = jnp.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"Expected a 2-d array, got shape {X.shape}")
    return X.astype(jnp.float32)


class KMeans:
    """Lloyd's algorithm with k-means++ init, jitted end-to-end.

    Parameters mirror sklearn: ``n_clusters``, ``max_iter``, ``tol``
    (scaled by the mean feature variance), ``n_init`` restarts keeping the
    lowest inertia, seeded determinism via ``random_seed``.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        *,
        max_iter: int = 300,
        tol: float = 1e-4,
        n_init: int = 1,
        random_seed: int = 42,
        verbose: bool = False,
        mesh=None,
    ):
        if n_clusters < 1:
            raise ValueError(f"n_clusters={n_clusters} must be >= 1")
        if n_init < 1:
            raise ValueError(f"n_init={n_init} must be >= 1")
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.n_init = n_init
        self.random_seed = random_seed
        self.verbose = verbose
        # optional jax.sharding.Mesh (1-d): rows shard across devices and
        # the same jitted Lloyd program runs under SPMD — centroid update
        # costs one psum over the row axis, centers stay replicated.
        # Dense inputs only (sparse matrices shard via parallel.sharded).
        self.mesh = mesh
        self.cluster_centers_: Optional[jnp.ndarray] = None
        self.labels_: Optional[jnp.ndarray] = None
        self.inertia_: Optional[float] = None
        self.n_iter_: Optional[int] = None
        self._counts: Optional[jnp.ndarray] = None  # minibatch state

    # ------------------------------------------------------------------

    def _tol2(self, X) -> jnp.ndarray:
        """sklearn's ``_tolerance``: tol x mean per-feature variance."""

        if _is_sparse(X):
            mv = jnp.mean(X[0].var_col())
        else:
            mv = jnp.mean(jnp.var(X, axis=0))
        return (self.tol * mv).astype(jnp.float32)

    def _shard_rows(self, X, x2, w):
        """Pad rows to a mesh-divisible count (zero rows, zero weight) and
        place X/x2/w with row shardings; centers/scalars stay replicated."""

        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = self.mesh.axis_names[0]
        ndev = self.mesh.devices.size
        n = X.shape[0]
        pad = (-n) % ndev
        if pad:
            X = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
            x2 = jnp.concatenate([x2, jnp.zeros((pad,), x2.dtype)])
            w = jnp.concatenate([w, jnp.zeros((pad,), w.dtype)])
        X = jax.device_put(X, NamedSharding(self.mesh, P(ax, None)))
        x2 = jax.device_put(x2, NamedSharding(self.mesh, P(ax)))
        w = jax.device_put(w, NamedSharding(self.mesh, P(ax)))
        return X, x2, w

    def fit(self, X) -> "KMeans":
        X = _prep(X)
        n = _n_of(X)
        if self.n_clusters > n:
            raise ValueError(
                f"n_clusters={self.n_clusters} exceeds n_samples={n}"
            )
        if self.mesh is not None and _is_sparse(X):
            raise ValueError(
                "mesh mode supports dense inputs; shard sparse matrices "
                "via the parallel.sharded engines and cluster embeddings"
            )
        x2 = _row_sq_norms(X).astype(jnp.float32)
        tol2 = self._tol2(X)
        w = jnp.ones((n,), jnp.float32)
        if self.mesh is not None:
            X, x2, w = self._shard_rows(X, x2, w)
        best = None
        for trial in range(self.n_init):
            key = jax.random.PRNGKey(self.random_seed + trial)
            C, labels, inertia, n_iter = _fit_one(
                X, x2, tol2, key, w,
                k=self.n_clusters, max_iter=self.max_iter,
            )
            inertia = float(inertia)
            if self.verbose:
                print(
                    f"KMeans init {trial}: inertia={inertia:.6g} "
                    f"iters={int(n_iter)}"
                )
            if best is None or inertia < best[2]:
                best = (C, labels[:n], inertia, int(n_iter))
        self.cluster_centers_, self.labels_, self.inertia_, self.n_iter_ = best
        return self

    def partial_fit(self, X) -> "KMeans":
        """Minibatch update from one row batch (out-of-core KMeans).

        The first call k-means++-seeds the centers from the batch (which
        must hold >= n_clusters rows); each call then moves centers
        toward the batch means with per-center 1/count learning rates
        (sklearn ``MiniBatchKMeans.partial_fit`` semantics). Batches may
        be dense arrays or ``SparseMatrix`` row slabs. ``labels_`` /
        ``inertia_`` reflect the LAST batch seen; use :meth:`predict`
        for final assignments.

        Each distinct batch SHAPE compiles once — stream uniform batch
        sizes (pad the tail batch if needed) to avoid recompiles.
        """

        if self.mesh is not None:
            raise ValueError(
                "partial_fit is single-device; mesh mode applies to fit()"
            )
        X = _prep(X)
        x2 = _row_sq_norms(X).astype(jnp.float32)
        if self.cluster_centers_ is None:
            n = _n_of(X)
            if self.n_clusters > n:
                raise ValueError(
                    f"first batch has {n} rows < n_clusters="
                    f"{self.n_clusters}"
                )
            key = jax.random.PRNGKey(self.random_seed)
            w = jnp.ones((n,), jnp.float32)
            self.cluster_centers_ = _plusplus_init(
                key, X, x2, w, self.n_clusters
            )
            self._counts = jnp.zeros((self.n_clusters,), jnp.float32)
            self.n_iter_ = 0
        elif _d_of(X) != self.cluster_centers_.shape[1]:
            raise ValueError(
                f"X has {_d_of(X)} features; fitted centers have "
                f"{self.cluster_centers_.shape[1]}"
            )
        C, counts, labels, inertia = _minibatch_step(
            X, x2, self.cluster_centers_, self._counts, k=self.n_clusters
        )
        self.cluster_centers_, self._counts = C, counts
        self.labels_ = labels
        self.inertia_ = float(inertia)
        self.n_iter_ = int(self.n_iter_) + 1
        return self

    def predict(self, X) -> jnp.ndarray:
        self._check_fitted()
        X = _prep(X)
        if _d_of(X) != self.cluster_centers_.shape[1]:
            raise ValueError(
                f"X has {_d_of(X)} features; fitted centers have "
                f"{self.cluster_centers_.shape[1]}"
            )
        x2 = _row_sq_norms(X).astype(jnp.float32)
        return _assign(X, x2, self.cluster_centers_, k=self.n_clusters)

    def fit_predict(self, X) -> jnp.ndarray:
        return self.fit(X).labels_

    def transform(self, X) -> jnp.ndarray:
        """Distances [n, k] to the fitted centers."""

        self._check_fitted()
        X = _prep(X)
        x2 = _row_sq_norms(X).astype(jnp.float32)
        d2 = _pairwise_d2(x2, X, self.cluster_centers_)
        return jnp.sqrt(jnp.maximum(d2, 0.0))

    def fit_transform(self, X) -> jnp.ndarray:
        return self.fit(X).transform(X)

    def score(self, X) -> float:
        """Negative inertia of X under the fitted centers (sklearn)."""

        d = self.transform(X)
        return -float(jnp.sum(jnp.min(d, axis=1) ** 2))

    def _check_fitted(self):
        if self.cluster_centers_ is None:
            raise ValueError("KMeans has not been fitted yet")

    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        self._check_fitted()
        counts = (
            np.asarray(self._counts)
            if self._counts is not None
            else np.zeros((self.n_clusters,), np.float32)
        )
        np.savez(
            path,
            cluster_centers=np.asarray(self.cluster_centers_),
            inertia=np.float64(self.inertia_),
            n_iter=np.int64(self.n_iter_),
            n_clusters=np.int64(self.n_clusters),
            counts=counts,  # minibatch state: partial_fit resumes after load
        )

    @classmethod
    def load(cls, path: str) -> "KMeans":
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            m = cls(int(z["n_clusters"]))
            m.cluster_centers_ = jnp.asarray(z["cluster_centers"])
            m.inertia_ = float(z["inertia"])
            m.n_iter_ = int(z["n_iter"])
            if "counts" in z:
                m._counts = jnp.asarray(z["counts"])
        return m


@dataclasses.dataclass
class KMeansBuilder:
    """Fluent builder, matching the library's PCA builder style."""

    _n_clusters: int = 8
    _max_iter: int = 300
    _tol: float = 1e-4
    _n_init: int = 1
    _random_seed: int = 42
    _verbose: bool = False
    _mesh: object = None

    def n_clusters(self, k: int) -> "KMeansBuilder":
        self._n_clusters = k
        return self

    def max_iter(self, n: int) -> "KMeansBuilder":
        self._max_iter = n
        return self

    def tol(self, t: float) -> "KMeansBuilder":
        self._tol = t
        return self

    def n_init(self, n: int) -> "KMeansBuilder":
        self._n_init = n
        return self

    def random_seed(self, s: int) -> "KMeansBuilder":
        self._random_seed = s
        return self

    def verbose(self, v: bool) -> "KMeansBuilder":
        self._verbose = v
        return self

    def mesh(self, m) -> "KMeansBuilder":
        self._mesh = m
        return self

    def build(self) -> KMeans:
        return KMeans(
            self._n_clusters,
            max_iter=self._max_iter,
            tol=self._tol,
            n_init=self._n_init,
            random_seed=self._random_seed,
            verbose=self._verbose,
            mesh=self._mesh,
        )
