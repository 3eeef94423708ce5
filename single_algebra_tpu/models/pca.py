"""SparsePCA — PCA for sparse matrices over the jitted SVD engines.

Rebuild of the reference's L4 API (``SparsePCA``/``SparsePCABuilder``,
``src/dimred/pca/sparse/mod.rs:33-484``) with identical builder defaults
(n_components=50, alpha=1.0, tolerance=1e-6, seed=42, center=true,
verbose=false, method=Lanczos — reference ``sparse/mod.rs:392-402``).

Semantics preserved from the reference:

* **Lanczos never centers the matrix** even when ``center=true`` — only
  ``transform`` subtracts the mean (reference passes raw ``x`` to
  ``svd_las2``, ``sparse/mod.rs:134-144``; see SURVEY.md §3.2). The Lanczos
  path is therefore TruncatedSVD-with-post-hoc-centering, while the
  randomized path is true centered PCA (``center`` flag forwarded at
  ``sparse/mod.rs:176``).
* ``explained_variance_ratio`` normalizes by the sum of the COMPUTED
  components' variances (``sparse/mod.rs:312-322``), not the total variance
  — ratios sum to 1. (sklearn divides by total variance; we match the
  reference.)
* ``feature_importances`` = squared loadings, k x p (``sparse/mod.rs:295-302``).

Divergences (intended semantics, reference defects not copied):

* ``transform`` computes ``T = (X - 1 mu^T) V^T`` as one SpMM minus a rank-1
  term. The reference's transform iterates the *global* col_indices array
  per row (``sparse/mod.rs:268-282``) — O(n_rows * k * nnz_total) and wrong
  whenever a column has more than one nonzero.
* ``mean_`` has length n_features when ``center=false`` (the reference
  allocates ``zeros(n_samples)``, ``sparse/mod.rs:116``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..linalg import (
    CenteredOperator,
    DensifiedOperator,
    GramPCAEngine,
    SparseOperator,
    TiledSparseOperator,
    block_lanczos_svd,
    gram_pca_graph,
    lanczos_svd,
    randomized_svd,
    svd_flip,
)
from ..sparse.matrix import SparseMatrix
from ..types import SVDMethod

__all__ = ["SparsePCA", "SparsePCABuilder"]


def _as_matrix(x) -> SparseMatrix:
    if isinstance(x, SparseMatrix):
        return x
    return SparseMatrix.from_scipy(x)


def _host_col_stats(m: SparseMatrix):
    """(sum_col, sum_col_squared) per column, float64 numpy — computed
    once per matrix from the host CSR arrays and cached."""

    cached = getattr(m, "_host_col_stats_cache", None)
    if cached is not None:
        return cached
    m._require_host_structure()
    src = m if m.format == "csr" else m.transpose()
    src._require_host_structure()
    data = src._csr_data_host().astype(np.float64)
    idx = src._h_indices
    p = m.ncols
    s = np.bincount(idx, weights=data, minlength=p)[:p]
    sq = np.bincount(idx, weights=data * data, minlength=p)[:p]
    m._host_col_stats_cache = (s, sq)
    return s, sq


from functools import partial as _partial

import jax as _jax


@_jax.jit
def _project(op, comps_t):
    """One cacheable graph for the PCA projection (centered SpMM)."""

    mv = getattr(op, "mv_precise", op.mv)
    return mv(comps_t)


@_partial(
    _jax.jit,
    static_argnames=(
        "k", "method", "center", "steps", "want_transform", "tol",
        "lanczos_block",
    ),
)
def _fit_graph(
    op,
    mean,
    seed,
    *,
    k: int,
    method: SVDMethod,
    center: bool,
    steps,
    want_transform: bool,
    tol: float | None = None,
    lanczos_block: int | None = None,
):
    """The whole fit (and optionally the projection) as ONE device
    dispatch: SVD -> sign flip -> (X - 1 mu^T) V^T, so the host issues one
    launch per fit instead of one per product."""

    proj_op = CenteredOperator(op, mean) if center else op
    if method.is_random:
        res = randomized_svd(
            proj_op,
            k,
            method.n_oversamples,
            method.n_power_iterations,
            method.normalizer,
            seed=seed,
        )
    elif lanczos_block is not None:
        # block GKL: b Krylov directions per step — matmul-shaped products
        # and b-fold fewer sequential steps (same raw-operator semantics).
        # `steps` is the KRYLOV DIMENSION on every builder surface
        # (lanczos_steps docs); block_lanczos_svd counts block steps, so
        # convert here — a tuned depth carries over between modes.
        bsteps = None if steps is None else max(-(-steps // lanczos_block), 2)
        res = block_lanczos_svd(
            op, k, block_size=lanczos_block, steps=bsteps, seed=seed,
            tol=tol,
        )
    else:
        # Lanczos on the RAW operator — reference semantic (SURVEY §3.2);
        # tol drives the convergence-adaptive while_loop (las2's kappa
        # analog), steps is the static Krylov budget
        res = lanczos_svd(op, k, steps=steps, seed=seed, tol=tol)
    u, vt = svd_flip(res.u, res.vt, u_based_decision=False)
    if want_transform:
        mv = getattr(proj_op, "mv_precise", proj_op.mv)
        T = mv(vt.T)
    else:
        T = None
    return res.s, vt, T


def _needs_lo(m: SparseMatrix) -> bool:
    """True when the matrix values are NOT bf16-exact (the densified
    engine then needs the second (lo) half, doubling its memory cost)."""

    try:
        return not m.values_bf16_exact()
    except Exception:
        return True  # conservative


def make_engine_operator(m: SparseMatrix, engine: str = "auto"):
    """Select + build the compute engine for a matrix (cached per matrix).

    'auto' on the GPU (``platform.engine_ladder()``) picks, in order: the
    densified-bf16 engine when the dense form fits the device budget; the
    exact two-pass Gram engine when the p x p Gram fits (tall-skinny
    beyond dense-fits — e.g. the reference's 10M x 2500 stress shape); the
    'tiled' engine when its ~(2-3x nnz) single-orientation payload fits;
    else the padded-ELL gather path ('sparse'). On the CPU, always
    'sparse'. The dense and tiled engines split f32 values into bf16
    terms, so other dtypes go to 'sparse' as well.

    For gram-class matrices the exact Gram full pass is also the first
    fit: running a first randomized fit on the tiled sketch engine
    instead resolves the tail of a planted spectrum far worse (the
    A-space sketch at q=7 against the G-space solve) and holds both
    payloads at once.
    """

    from .. import platform

    # operators are cached on the matrix under the REQUESTED engine name:
    # densification / layout builds (and the auto-probe itself) are
    # per-matrix work, shared by every model fitted on it
    cache = getattr(m, "_operator_cache", None)
    requested = engine
    if cache is not None and requested in cache:
        return cache[requested]
    if engine == "auto":
        if platform.engine_ladder() and m.dtype == jnp.float32:
            # cheap shape-only check first: the O(nnz) bf16-exactness scan
            # is pointless when even the hi-only form cannot fit
            if DensifiedOperator.fits(
                m.shape, needs_lo=False
            ) and DensifiedOperator.fits(m.shape, needs_lo=_needs_lo(m)):
                engine = "dense"
            elif GramPCAEngine.fits(m):
                # tall-skinny beyond dense-fits (e.g. the reference's
                # 10M x 2500 stress shape): exact two-pass Gram PCA
                engine = "gram"
            elif TiledSparseOperator.fits(m):
                engine = "tiled"
            else:
                engine = "sparse"
        else:
            engine = "sparse"
    if cache is not None and engine in cache:
        cache[requested] = cache[engine]
        return cache[engine]
    if engine == "dense":
        op = DensifiedOperator.from_matrix(m)
    elif engine == "gram":
        op = GramPCAEngine.from_matrix(m)
    elif engine == "tiled":
        op = TiledSparseOperator.from_matrix(m)
    elif engine == "sparse":
        op = SparseOperator.from_matrix(m)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    if cache is not None:
        cache[engine] = op
        cache[requested] = op
    return op


def _warn_gram_ignores_lanczos_knobs(model) -> None:
    """engine='gram' maps the Lanczos method to the exact uncentered Gram
    solve (``linalg/gram.py`` module docs): ``lanczos_steps`` /
    ``lanczos_block`` / ``tolerance`` have no effect there. Emit a signal
    when the user explicitly tuned them, so silence doesn't read as
    "applied"."""

    if model.svd_method.is_random:
        return
    tuned = [
        name
        for name, v in (
            ("lanczos_steps", model.lanczos_steps),
            ("lanczos_block", model.lanczos_block),
        )
        if v is not None
    ]
    if tuned:
        import warnings

        warnings.warn(
            "engine='gram' computes the Lanczos method as an exact "
            f"(uncentered) Gram solve; {', '.join(tuned)} (and tolerance) "
            "are not used on this path. Set engine='dense'/'sparse'/"
            "'tiled' to run the iterative Lanczos solver.",
            UserWarning,
            stacklevel=3,
        )


class _LazyPCAState:
    """Host-state mixin shared by :class:`SparsePCA` and
    ``MaskedSparsePCA``: ``components_`` stays a device array (it feeds
    ``transform``'s SpMM); ``mean_`` and ``explained_variance_`` are host
    numpy — ``mean_`` is host-computed anyway, and the singular values are
    pulled LAZILY on first access (50 floats), so ``fit`` returns without
    a blocking device sync and a state pull to host costs one transfer
    instead of five round-trips."""

    def _init_lazy_state(self) -> None:
        self.components_: Optional[jnp.ndarray] = None
        self._mean_np: Optional[np.ndarray] = None
        self._mean_dev: Optional[jnp.ndarray] = None
        # lazy EV state: _s_dev holds the un-pulled device singular
        # values until explained_variance_/total/noise is first read
        self._s_dev = None
        self._ev_np: Optional[np.ndarray] = None
        self._total_var: Optional[float] = None
        self._noise_var: Optional[float] = None
        self._fit_n_samples: Optional[int] = None
        self._fit_min_dim: Optional[int] = None

    def _set_fit_state(self, s_dev, total_var, n_samples, min_dim) -> None:
        """EV bookkeeping is DEFERRED: fit returns with the solve still
        enqueued; the first explained_variance_/total/noise access pulls
        s and finishes on host (:meth:`_finalize_ev`)."""

        self._s_dev = s_dev
        self._ev_np = None
        self._total_var = total_var  # None when center=False -> lazy sum
        self._noise_var = None
        self._fit_n_samples = n_samples
        self._fit_min_dim = min_dim

    def _finalize_ev(self) -> None:
        """Pull the singular values (once) and finish the host-side EV
        bookkeeping deferred from ``fit``."""

        if self._ev_np is not None or self._s_dev is None:
            return
        s_np = np.asarray(self._s_dev, dtype=np.float64)
        self._s_dev = None
        n_minus_1 = max((self._fit_n_samples or 1) - 1, 1)
        ev64 = s_np**2 / n_minus_1
        dt = (
            self.components_.dtype
            if self.components_ is not None
            else np.float32
        )
        self._ev_np = ev64.astype(dt)
        if self._total_var is None:  # center=False: total = sum of EVs
            self._total_var = float(ev64.sum())
        k, min_dim = self.n_components, self._fit_min_dim or 0
        if k < min_dim:
            self._noise_var = (self._total_var - float(ev64.sum())) / (
                min_dim - k
            )
        else:
            self._noise_var = 0.0

    @property
    def explained_variance_(self) -> Optional[np.ndarray]:
        self._finalize_ev()
        return self._ev_np

    @explained_variance_.setter
    def explained_variance_(self, v) -> None:
        self._ev_np = None if v is None else np.asarray(v)
        self._s_dev = None

    @property
    def total_variance_(self) -> Optional[float]:
        self._finalize_ev()
        return self._total_var

    @total_variance_.setter
    def total_variance_(self, v) -> None:
        self._total_var = v

    @property
    def noise_variance_(self) -> Optional[float]:
        self._finalize_ev()
        return self._noise_var

    @noise_variance_.setter
    def noise_variance_(self, v) -> None:
        self._noise_var = v

    @property
    def mean_(self) -> Optional[np.ndarray]:
        return self._mean_np

    @mean_.setter
    def mean_(self, v) -> None:
        self._mean_np = None if v is None else np.asarray(v)
        self._mean_dev = None

    def _mean_device(self) -> jnp.ndarray:
        """``mean_`` as a (cached) device array for the jitted graphs."""

        if self._mean_dev is None:
            self._mean_dev = jnp.asarray(self._mean_np)
        return self._mean_dev


class SparsePCA(_LazyPCAState):
    """PCA on sparse matrices (samples x features).

    State after ``fit``: ``components_`` (k x p), ``explained_variance_``
    (k), ``mean_`` (p) — mirroring the reference struct fields
    (``sparse/mod.rs:37-47``). Model state lives host-side after fit —
    see :class:`_LazyPCAState`.
    """

    def __init__(
        self,
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
        self.n_components = n_components
        self.engine = engine
        self.alpha = alpha  # parity field; unused, as in the reference
        self.tolerance = tolerance
        self.random_seed = random_seed
        self.center = center
        self.verbose = verbose
        self.svd_method = svd_method
        self._init_lazy_state()

    # -- fitting -------------------------------------------------------

    def fit(self, x) -> "SparsePCA":
        m = _as_matrix(x)
        n_samples, n_features = m.shape
        k = self.n_components
        t0 = time.perf_counter()

        op = self._make_operator(m)
        t_op = time.perf_counter() - t0

        # Column statistics and all scalar bookkeeping happen in NUMPY:
        # every stray eager jnp op is its own compile and dispatch, so the
        # device is touched only through the big cached jitted graphs
        # (SVD, projection).
        col_sums, col_sq = _host_col_stats(m)
        dt = np.float32 if m.dtype == jnp.float32 else np.dtype(m.dtype)
        if self.center:
            mean_np = (col_sums / n_samples).astype(dt)
        else:
            mean_np = np.zeros(n_features, dt)
        self.mean_ = mean_np  # property: also drops any stale device copy
        self._mean_dev = jnp.asarray(mean_np)

        total_var = None
        if self.center and n_samples > 1:
            mean64 = col_sums / n_samples
            total_var = float(
                np.sum((col_sq - mean64 * col_sums) / (n_samples - 1))
            )

        t_stats = time.perf_counter() - t0 - t_op
        if self.verbose and self.svd_method.is_random:
            print("Computing randomized SVD...")
        want_t = getattr(self, "_want_transform", False)
        if isinstance(op, GramPCAEngine):
            # exact two-pass Gram path; the Lanczos method maps to the
            # uncentered solve (reference semantics, SURVEY §3.2), the
            # randomized method to the centered one
            _warn_gram_ignores_lanczos_knobs(self)
            sm = self.svd_method
            if self.verbose:
                from ..linalg.gram import EIGH_MAX_PP

                if op.p_padded > EIGH_MAX_PP and sm.is_random:
                    # _solve_topk treats the user's sketch params as
                    # MINIMUMS there (accuracy floor, linalg/gram.py) —
                    # surface that the effective solve may be larger
                    k_ = self.n_components
                    os_floor = min(k_ + 14, max(op.p_padded - k_, 0))
                    print(
                        "Large-Gram randomized solve: oversamples/"
                        "power-iterations are treated as minimums "
                        f"(oversamples >= {os_floor} i.e. sketch width "
                        f"l >= {k_ + os_floor}, q >= 8; requested "
                        f"{sm.n_oversamples}/{sm.n_power_iterations})"
                    )
            s_dev, vt, T = gram_pca_graph(
                op,
                op.gram_cached(),
                self._mean_dev,
                self.random_seed,
                k=k,
                center_svd=self.center and sm.is_random,
                center_T=self.center,
                want_transform=want_t,
                # large-Gram randomized solve honors the user's method
                # hyperparameters (ignored by the exact eigh small path)
                solver_oversamples=(
                    sm.n_oversamples if sm.is_random else 10
                ),
                solver_iters=(
                    sm.n_power_iterations if sm.is_random else 6
                ),
            )
        else:
            s_dev, vt, T = _fit_graph(
                op,
                self._mean_dev,
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
        t_svd = time.perf_counter() - t0 - t_op - t_stats
        self._fit_timings = dict(operator=t_op, stats=t_stats, svd=t_svd)
        self.components_ = vt
        self._set_fit_state(
            s_dev, total_var, n_samples, min(n_samples, n_features)
        )

        if self.verbose:
            name = "randomized" if self.svd_method.is_random else "Lanczos"
            print(f"SVD using {name} algorithm:")
            print(
                f"  Input shape: {n_samples} samples x {n_features} features"
            )
            print(f"  Reduced to: {k} components")
            print(
                f"  Compression ratio: {k / n_features * 100.0:.2f}%"
            )
            if self.svd_method.is_random:
                print(f"  Oversampling: {self.svd_method.n_oversamples}")
                print(
                    f"  Power iterations: "
                    f"{self.svd_method.n_power_iterations}"
                )
            print(f"  Estimated noise variance: {self.noise_variance_}")
            print(f"  Fit took {time.perf_counter() - t0:.3f}s")
        return self

    # -- inference -----------------------------------------------------

    def _make_operator(self, m):
        return make_engine_operator(m, self.engine)

    def _operator_for_transform(self, m):
        """Any cached operator projects (mv is universal); never build a
        fresh Gram engine just for a projection."""

        cache = getattr(m, "_operator_cache", None)
        if self.engine == "auto" and cache:
            return cache.get("auto") or next(iter(cache.values()))
        return self._make_operator(m)

    def transform(self, x) -> jnp.ndarray:
        self._check_fitted()
        m = _as_matrix(x)
        op = self._operator_for_transform(m)
        if self.center:
            op = CenteredOperator(op, self._mean_device())
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
        """Back-project scores to feature space: ``T @ components_``
        (+ ``mean_`` when centered) — sklearn ``PCA.inverse_transform``
        semantics (lossy for k < rank)."""

        self._check_fitted()
        T = jnp.asarray(T)
        R = T @ self.components_
        if self.center:
            R = R + self._mean_device()
        return R

    # -- analysis ------------------------------------------------------

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

    # -- persistence (reference relies on serde upstream; SURVEY §5) ----

    def save(self, path: str) -> None:
        np.savez(
            path,
            components=np.asarray(self.components_),
            explained_variance=np.asarray(self.explained_variance_),
            mean=np.asarray(self.mean_),
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
    def load(cls, path: str) -> "SparsePCA":
        import os

        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"  # np.savez appends the suffix; np.load does not
        with np.load(path) as z:
            meta = z["meta"]
            obj = cls(
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
class SparsePCABuilder:
    """Fluent builder with the reference's exact defaults
    (``sparse/mod.rs:392-402``)."""

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
        """Block size for the Lanczos path: b Krylov directions per step
        (matmul-shaped products, b-fold fewer sequential steps). None (default)
        = the scalar recurrence. ``lanczos_steps`` keeps its
        Krylov-dimension meaning in block mode (the engine runs
        ceil(steps/b) block steps), so a tuned depth carries over."""

        self._lanczos_block = b
        return self

    def lanczos_steps(self, n: int):
        """Krylov depth for the Lanczos path (default: 8k, capped at the
        minimum dimension; lower for strongly gapped spectra)."""

        self._lanczos_steps = n
        return self

    def engine(self, e: str) -> "SparsePCABuilder":
        """Compute engine: 'auto' (the ladder of ``make_engine_operator``),
        'dense', 'gram', 'tiled' or 'sparse'."""

        self._engine = e
        return self

    def n_components(self, n: int) -> "SparsePCABuilder":
        self._n_components = n
        return self

    def alpha(self, a: float) -> "SparsePCABuilder":
        self._alpha = a
        return self

    def tolerance(self, t: float) -> "SparsePCABuilder":
        """Convergence tolerance for the Lanczos path: the adaptive loop
        stops once the top-k Ritz values move < t relative between checks
        (las2's kappa analog). None = fixed-depth mode."""

        self._tolerance = t
        return self

    def random_seed(self, s: int) -> "SparsePCABuilder":
        self._random_seed = s
        return self

    def center(self, c: bool) -> "SparsePCABuilder":
        self._center = c
        return self

    def verbose(self, v: bool) -> "SparsePCABuilder":
        self._verbose = v
        return self

    def svd_method(self, m: SVDMethod) -> "SparsePCABuilder":
        self._svd_method = m
        return self

    def build(self) -> SparsePCA:
        return SparsePCA(
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
