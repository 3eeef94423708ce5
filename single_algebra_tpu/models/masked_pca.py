"""MaskedSparsePCA — PCA restricted to a boolean feature subset.

Rebuild of the reference's masked variant
(``MaskedSparsePCA``/``MaskedSparsePCABuilder``,
``src/dimred/pca/sparse_masked/mod.rs:37-620``). The reference wraps the
matrix in a zero-copy ``MaskedCSRMatrix`` view and remaps columns through a
HashMap at transform time (``sparse_masked/mod.rs:455-466``); here the view
is a :class:`MaskedOperator` — an int32 index gather — and the transform is
one masked SpMM minus a rank-1 centering term.

Preserved reference semantics:

* mask length must equal n_features exactly (``sparse_masked/mod.rs:258-262``).
* ``mean_`` is FULL width (p), computed over all columns; total variance is
  summed over masked columns only (``sparse_masked/mod.rs:279-311``).
* Lanczos path does not center (raw masked operator).
* ``components_`` is k x p_masked; ``feature_importances`` covers masked
  features only.

Divergences (documented, not copied):

* the reference's transform subtracts the mean only at stored-entry
  positions (``sparse_masked/mod.rs:488-529``), which drops the
  ``-mu_j * v_kj`` contribution of implicit zeros; we compute the intended
  full projection ``T = (X[:, mask] - 1 mu[mask]^T) V^T``.
* the reference's unconditional debug ``println!`` of dimensions
  (``sparse_masked/mod.rs:373-378``) is gated behind ``verbose``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..linalg import CenteredOperator, MaskedOperator
from ..types import SVDMethod
from .pca import (
    _LazyPCAState,
    _as_matrix,
    _fit_graph,
    _host_col_stats,
    _project,
    make_engine_operator,
)

__all__ = ["MaskedSparsePCA", "MaskedSparsePCABuilder"]


class MaskedSparsePCA(_LazyPCAState):
    def __init__(
        self,
        mask: Sequence[bool],
        n_components: int = 50,
        alpha: float = 1.0,
        tolerance: float = 1e-6,
        random_seed: int = 42,
        center: bool = True,
        verbose: bool = False,
        svd_method: SVDMethod = SVDMethod.lanczos(),
        engine: str = "auto",
        lanczos_steps: int | None = None,
        lanczos_block: int | None = None,
    ):
        self.lanczos_steps = lanczos_steps
        self.lanczos_block = lanczos_block
        self.engine = engine
        self.mask = np.asarray(mask, dtype=bool)
        self.n_components = n_components
        self.alpha = alpha
        self.tolerance = tolerance
        self.random_seed = random_seed
        self.center = center
        self.verbose = verbose
        self.svd_method = svd_method
        self._init_lazy_state()

    def _mask_idx(self) -> jnp.ndarray:
        return jnp.asarray(np.where(self.mask)[0].astype(np.int32))

    def fit(self, x) -> "MaskedSparsePCA":
        m = _as_matrix(x)
        n_samples, n_cols = m.shape
        if n_cols != self.mask.shape[0]:
            raise ValueError(
                "The mask vector length and the number of features (columns)"
                " have to be the same!"
            )
        k = self.n_components
        t0 = time.perf_counter()
        idx = self._mask_idx()
        n_features = int(self.mask.sum())

        op = make_engine_operator(m, self.engine)
        mop = MaskedOperator(op, idx)

        # numpy bookkeeping: no stray eager device ops (each is its own
        # compile and dispatch)
        col_sums, col_sq = _host_col_stats(m)
        dt = np.float32 if m.dtype == jnp.float32 else np.dtype(m.dtype)
        idx_np = np.where(self.mask)[0]
        if self.center:
            if self.verbose:
                print("PCA | SparseMasked | Initializing centering...")
            mean_np = (col_sums / n_samples).astype(dt)
        else:
            mean_np = np.zeros(n_cols, dt)
        self.mean_ = mean_np  # FULL width, reference semantic
        self._mean_dev = jnp.asarray(mean_np)

        total_var = None
        if self.center and n_samples > 1:
            mean64 = col_sums / n_samples
            var_all = (col_sq - mean64 * col_sums) / (n_samples - 1)
            total_var = float(var_all[idx_np].sum())

        if self.verbose:
            name = "Randomized" if self.svd_method.is_random else "Lanczos"
            print(f"PCA | SparseMasked | Computing {name} SVD....")
        want_t = getattr(self, "_want_transform", False)
        from ..linalg import GramPCAEngine, gram_pca_graph

        if isinstance(op, GramPCAEngine):
            # masked Gram PCA = submatrix of the cached full Gram
            from .pca import _warn_gram_ignores_lanczos_knobs

            _warn_gram_ignores_lanczos_knobs(self)
            sm = self.svd_method
            s_dev, vt, T = gram_pca_graph(
                op,
                op.gram_cached(),
                jnp.asarray(mean_np),
                self.random_seed,
                k=k,
                center_svd=self.center and sm.is_random,
                center_T=self.center,
                want_transform=want_t,
                mask_idx=idx,
                solver_oversamples=(
                    sm.n_oversamples if sm.is_random else 10
                ),
                solver_iters=(
                    sm.n_power_iterations if sm.is_random else 6
                ),
            )
        else:
            s_dev, vt, T = _fit_graph(
                mop,
                jnp.asarray(mean_np[idx_np]),
                self.random_seed,
                k=k,
                method=self.svd_method,
                center=self.center,
                steps=self.lanczos_steps,
                want_transform=want_t,
                tol=self.tolerance,
                lanczos_block=self.lanczos_block,
            )
        self._fitted_transform = T
        self.components_ = vt  # k x p_masked
        self._set_fit_state(
            s_dev, total_var, n_samples, min(n_samples, n_features)
        )

        if self.verbose:
            # verbose forces the (otherwise lazy) singular-value pull
            ev_np = np.asarray(self.explained_variance_, np.float64)
            print(
                f"s-dim: {(len(ev_np),)}, components: {k}, "
                f"nfeatures: {n_features}"
            )
            print("PCA completed successfully:")
            print(
                f"  Input shape: {n_samples} samples x {n_cols} features "
                f"(using {n_features} features with mask)"
            )
            print(f"  Reduced to: {k} components")
            if self.total_variance_:
                pct = float(ev_np.sum()) / self.total_variance_ * 100
                print(f"  Total variance explained: {pct:.2f}%")
            print(f"  Fit took {time.perf_counter() - t0:.3f}s")
        return self

    def transform(self, x) -> jnp.ndarray:
        self._check_fitted()
        m = _as_matrix(x)
        if m.shape[1] != self.mask.shape[0]:
            raise ValueError(
                "The mask vector length and the number of features (columns)"
                " have to be the same!"
            )
        idx = self._mask_idx()
        op = MaskedOperator(make_engine_operator(m, self.engine), idx)
        if self.center:
            idx_np = np.where(self.mask)[0]
            op = CenteredOperator(
                op, jnp.asarray(self.mean_[idx_np])
            )
        return _project(op, self.components_.T)

    def fit_transform(self, x) -> jnp.ndarray:
        m = _as_matrix(x)  # convert once; fit and transform share layouts
        self._want_transform = True
        try:
            self.fit(m)
        finally:
            self._want_transform = False
        T = self._fitted_transform
        self._fitted_transform = None
        return T

    def inverse_transform(self, T) -> jnp.ndarray:
        """Back-project scores to FULL feature width [n, p].

        Masked columns get ``T @ components_`` (+ their mean when
        centered); unmasked columns — which the model never sees — get
        their column mean (the best constant reconstruction), or zero
        when uncentered.
        """

        self._check_fitted()
        T = jnp.asarray(T)
        idx = jnp.asarray(np.where(self.mask)[0], jnp.int32)
        Rm = T @ self.components_  # [n, p_masked]
        p = self.mask.shape[0]
        base = (
            jnp.broadcast_to(self._mean_device(), (T.shape[0], p))
            if self.center
            else jnp.zeros((T.shape[0], p), Rm.dtype)
        )
        return base.at[:, idx].add(Rm.astype(base.dtype))

    def feature_importances(self) -> jnp.ndarray:
        self._check_fitted()
        return self.components_**2

    def explained_variance_ratio(self) -> jnp.ndarray:
        self._check_fitted()
        ev = np.asarray(self.explained_variance_, dtype=np.float64)
        return jnp.asarray((ev / ev.sum()).astype(ev.dtype))

    def cumulative_explained_variance_ratio(self) -> jnp.ndarray:
        ratios = np.asarray(self.explained_variance_ratio())
        return jnp.asarray(np.cumsum(ratios))

    def _check_fitted(self):
        if self.components_ is None:
            raise RuntimeError("Must be fitted before transform!")

    def save(self, path: str) -> None:
        np.savez(
            path,
            components=np.asarray(self.components_),
            explained_variance=np.asarray(self.explained_variance_),
            mean=np.asarray(self.mean_),
            mask=self.mask,
            meta=np.array(
                [
                    self.n_components,
                    int(self.center),
                    self.random_seed,
                    self.total_variance_ or 0.0,
                    self.noise_variance_ or 0.0,
                ],
                dtype=np.float64,
            ),
        )

    @classmethod
    def load(cls, path: str) -> "MaskedSparsePCA":
        import os

        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"  # np.savez appends the suffix; np.load does not
        with np.load(path) as z:
            meta = z["meta"]
            obj = cls(
                mask=z["mask"],
                n_components=int(meta[0]),
                center=bool(meta[1]),
                random_seed=int(meta[2]),
            )
            obj.components_ = jnp.asarray(z["components"])
            obj.explained_variance_ = jnp.asarray(z["explained_variance"])
            obj.mean_ = jnp.asarray(z["mean"])
            obj.total_variance_ = float(meta[3])
            obj.noise_variance_ = float(meta[4])
        return obj


@dataclasses.dataclass
class MaskedSparsePCABuilder:
    """Builder with the reference's defaults + required ``mask``
    (``sparse_masked/mod.rs:37-160``)."""

    _mask: Optional[np.ndarray] = None
    _n_components: int = 50
    _alpha: float = 1.0
    _tolerance: float = 1e-6
    _random_seed: int = 42
    _center: bool = True
    _verbose: bool = False
    _svd_method: SVDMethod = dataclasses.field(
        default_factory=SVDMethod.lanczos
    )
    _engine: str = "auto"
    _lanczos_steps: int | None = None
    _lanczos_block: int | None = None

    def lanczos_block(self, b: int | None):
        """Block size for the Lanczos path (see SparsePCABuilder)."""

        self._lanczos_block = b
        return self

    def lanczos_steps(self, n: int):
        """Krylov depth for the Lanczos path (default: 8k, capped at the
        minimum dimension; lower for strongly gapped spectra)."""

        self._lanczos_steps = n
        return self

    def engine(self, e: str) -> "MaskedSparsePCABuilder":
        self._engine = e
        return self

    def mask(self, m) -> "MaskedSparsePCABuilder":
        self._mask = np.asarray(m, dtype=bool)
        return self

    def n_components(self, n: int) -> "MaskedSparsePCABuilder":
        self._n_components = n
        return self

    def alpha(self, a: float) -> "MaskedSparsePCABuilder":
        self._alpha = a
        return self

    def tolerance(self, t: float) -> "MaskedSparsePCABuilder":
        self._tolerance = t
        return self

    def random_seed(self, s: int) -> "MaskedSparsePCABuilder":
        self._random_seed = s
        return self

    def center(self, c: bool) -> "MaskedSparsePCABuilder":
        self._center = c
        return self

    def verbose(self, v: bool) -> "MaskedSparsePCABuilder":
        self._verbose = v
        return self

    def svd_method(self, m: SVDMethod) -> "MaskedSparsePCABuilder":
        self._svd_method = m
        return self

    def build(self) -> MaskedSparsePCA:
        if self._mask is None:
            raise ValueError("MaskedSparsePCABuilder requires a mask")
        return MaskedSparsePCA(
            mask=self._mask,
            n_components=self._n_components,
            alpha=self._alpha,
            tolerance=self._tolerance,
            random_seed=self._random_seed,
            center=self._center,
            verbose=self._verbose,
            svd_method=self._svd_method,
            engine=self._engine,
            lanczos_steps=self._lanczos_steps,
            lanczos_block=self._lanczos_block,
        )
