"""Post-normalization preprocessing: ``scale`` and ``regress_out``.

scanpy's ``pp.scale`` / ``pp.regress_out`` surface over this library's
device kernels. Both are one-jitted-graph operations: column moments
ride the fused ELL reductions, densification is a single device
scatter, and ``regress_out``'s projector is two matmuls plus a
q x q solve (q = covariate count, tiny). The reference ships the
normalize/log1p half of preprocessing (``src/utils/mod.rs:6-39``);
these are the steps its downstream pipelines run next.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ops.precise_math import log1p as _plog1p

__all__ = [
    "normalize_total",
    "normalize_pearson_residuals",
    "tfidf",
    "scale",
    "regress_out",
    "combat",
    "subsample",
    "downsample_counts",
    "aggregate",
]


def normalize_total(
    m,
    *,
    target_sum: Optional[float] = None,
    exclude_highly_expressed: bool = False,
    max_fraction: float = 0.05,
):
    """Total-count normalize rows (scanpy ``pp.normalize_total``).

    ``target_sum=None`` uses the median of per-cell counts (scanpy
    default). ``exclude_highly_expressed`` recomputes each cell's size
    factor WITHOUT genes that take more than ``max_fraction`` of any
    cell's counts (scanpy semantics) — the genes themselves stay in the
    matrix. Returns ``(normalized_matrix, size_factors)``.
    """

    from .types import Direction

    sums = np.asarray(m.sum_row(), np.float64)
    if exclude_highly_expressed:
        # gene is "highly expressed" if its share exceeds max_fraction
        # of ANY cell's counts: max over cells of x_ig / sum_i
        shares = m.normalize(
            jnp.asarray(np.where(sums > 0, sums, 1.0), m.dtype),
            1.0,
            Direction.ROW,
        )
        _, col_max = shares.min_max_col()
        keep = np.asarray(col_max) <= max_fraction
        sums = np.asarray(m.sum_row_masked(keep), np.float64)
    if target_sum is None:
        pos = sums[sums > 0]
        target_sum = float(np.median(pos)) if pos.size else 1.0
    out = m.normalize(jnp.asarray(sums, m.dtype), target_sum, Direction.ROW)
    return out, sums / target_sum


def _tfidf_fn(v, r, c, row_fac, col_fac, sf, log_tf, log_tfidf):
    """Stored-entry TF-IDF map for ``SparseMatrix.map_stored``: the
    1/rowsum TF factor gathers by row id, the IDF factor by column id.
    All branches map 0 -> 0, so sparsity is preserved. Module-level with
    traced operands so the jitted map-graph caches on the fn identity."""

    tf = v * jnp.take(row_fac, r, axis=0, mode="clip")
    tf = jnp.where(log_tf, _plog1p(tf * sf), tf)
    out = tf * jnp.take(col_fac, c, axis=0, mode="clip")
    return jnp.where(log_tfidf, _plog1p(out * sf), out)


def _scale_cols_fn(v, r, c, inv_std):
    """Per-column scaling map (``scale(zero_center=False)``); 0 -> 0."""

    return v * jnp.take(inv_std, c, axis=0, mode="clip")


def _scale_cols_clip_fn(v, r, c, inv_std, maxv):
    return jnp.minimum(v * jnp.take(inv_std, c, axis=0, mode="clip"), maxv)


def tfidf(
    m,
    *,
    scale_factor: float = 1e4,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
):
    """TF-IDF normalization of a cells x peaks count matrix (the scATAC
    preprocessing step; muon ``atac.pp.tfidf`` / Signac ``RunTFIDF``
    semantics).

    TF_ig = x_ig / rowsum_i, IDF_g = n_cells / colsum_g. With the
    defaults (``log_tf=log_idf=True``) the result is
    ``log1p(TF * scale_factor) * log1p(IDF)``; ``log_tfidf=True``
    (mutually exclusive with the other logs, the Signac method-1 form)
    gives ``log1p(TF * IDF * scale_factor)``. Every variant maps zeros
    to zeros, so the result stays a SparseMatrix (one fused device pass
    over the stored values). Zero-sum rows/columns contribute zero
    factors (no NaN/inf).
    """

    if log_tfidf and (log_tf or log_idf):
        raise ValueError(
            "log_tfidf cannot be combined with log_tf / log_idf "
            "(muon rule: pass log_tf=False, log_idf=False)"
        )
    n = m.nrows
    rs = np.asarray(m.sum_row(), np.float64)
    cs = np.asarray(m.sum_col(), np.float64)
    inv_rs = np.where(rs > 0, 1.0 / np.where(rs > 0, rs, 1.0), 0.0)
    idf = np.where(cs > 0, n / np.where(cs > 0, cs, 1.0), 0.0)
    if log_idf:
        idf = np.log1p(idf)
    return m.map_stored(
        _tfidf_fn,
        jnp.asarray(inv_rs, m.dtype),
        jnp.asarray(idf, m.dtype),
        jnp.asarray(scale_factor, m.dtype),
        jnp.asarray(log_tf),
        jnp.asarray(log_tfidf),
    )


@partial(jax.jit, static_argnames=("ncols", "nrows"))
def _pearson_residual_graph(
    ell_data, ell_ids, row_nnz, ncols, nrows, t, g, theta, clip
):
    """Dense [n, p] clipped analytic Pearson residuals in one graph."""

    dense = _ell_densify(ell_data, ell_ids, row_nnz, ncols)[:nrows]
    total = jnp.sum(t)
    mu = jnp.outer(t, g) / jnp.where(total > 0, total, 1.0)
    denom = jnp.sqrt(mu + mu * mu / theta)
    r = jnp.where(denom > 0, (dense - mu) / jnp.where(denom > 0, denom, 1.0), 0.0)
    return jnp.clip(r, -clip, clip)


def normalize_pearson_residuals(
    m,
    *,
    theta: float = 100.0,
    clip: Optional[float] = None,
):
    """Analytic Pearson residuals of raw counts (Lause, Berens & Kobak
    2021; scanpy ``experimental.pp.normalize_pearson_residuals``).

    Under the NB model with fixed inverse overdispersion ``theta``,
    mu_ig = t_i g_g / total and r = (x - mu) / sqrt(mu + mu^2 / theta),
    clipped to ``[-clip, clip]`` (default ``sqrt(n)``, the scanpy/paper
    rule). ``theta=inf`` gives Poisson residuals. Expects RAW counts.
    Returns a dense device array [n, p] — centering destroys sparsity,
    like ``scale(zero_center=True)``; for HVG selection use
    ``highly_variable_genes(flavor='pearson_residuals')``, which never
    materializes the dense residuals. Cells with zero total count and
    genes with zero total count get all-zero residuals (no NaNs).
    """

    if not theta > 0:
        raise ValueError(f"theta={theta} must be > 0")
    n = m.nrows
    if clip is None:
        clip = float(np.sqrt(n))
    if clip <= 0:
        raise ValueError(f"clip={clip} must be > 0 (scanpy: None -> sqrt(n))")
    mr = m._layout_for("row")
    t = m.sum_row()
    g = m.sum_col()
    return _pearson_residual_graph(
        mr.ell_data,
        mr.ell_ids,
        mr.row_nnz,
        m.ncols,
        n,
        jnp.asarray(t, mr.dtype),
        jnp.asarray(g, mr.dtype),
        jnp.asarray(theta, mr.dtype),
        jnp.asarray(clip, mr.dtype),
    )


def aggregate(
    m,
    labels,
    *,
    funcs=("mean", "frac_nonzero"),
):
    """Per-group per-gene aggregates (scanpy ``sc.get.aggregate`` role;
    the dotplot/matrixplot data): dict of [n_groups, p] arrays keyed by
    func, plus ``groups`` order. Supported funcs: 'mean' (zeros
    included), 'sum', 'var' (Bessel, zeros included), 'frac_nonzero',
    'count_nonzero'. All ride the grouped one-hot SpMM."""

    n, p = m.shape
    names, codes = m._batch_codes(list(labels), n, "row")
    sizes = np.bincount(codes, minlength=len(names)).astype(np.float64)
    out = {"groups": np.asarray(names, object)}
    need_sum = {"mean", "sum", "var"} & set(funcs)
    sums = (
        np.asarray(m._batch_spmm("col", codes, "sum"), np.float64).T
        if need_sum
        else None
    )  # [G, p]
    for f in funcs:
        if f == "sum":
            out[f] = sums
        elif f == "mean":
            out[f] = sums / np.maximum(sizes, 1.0)[:, None]
        elif f == "var":
            sumsq = np.asarray(
                m._batch_spmm("col", codes, "sumsq"), np.float64
            ).T
            mean = sums / np.maximum(sizes, 1.0)[:, None]
            out[f] = np.maximum(
                (sumsq - sums * mean) / np.maximum(sizes - 1.0, 1.0)[:, None],
                0.0,
            )
        elif f in ("frac_nonzero", "count_nonzero"):
            cnt = np.asarray(
                m._batch_spmm("col", codes, "count"), np.float64
            ).T
            out[f] = (
                cnt / np.maximum(sizes, 1.0)[:, None]
                if f == "frac_nonzero"
                else cnt
            )
        else:
            raise ValueError(f"Unknown aggregate func {f!r}")
    return out


from .ops.spmm import ell_scatter_densify as _ell_densify  # noqa: E402


def _col_mean_std(X):
    """(mean, std, inv_std) per column, zeros included, Bessel; zero-var
    columns get std=1 (scanpy: left unscaled)."""

    from .sparse.matrix import SparseMatrix

    if isinstance(X, SparseMatrix):
        n = X.nrows
        mean = X.sum_col() / n
        var = X.var_col()
    else:
        X = jnp.asarray(X)
        n = X.shape[0]
        mean = jnp.mean(X, axis=0)
        var = jnp.var(X, axis=0) * (n / max(n - 1, 1))
    std = jnp.sqrt(jnp.maximum(var, 0.0))
    safe = jnp.where(std > 0, std, 1.0)
    return mean, safe, 1.0 / safe


def scale(
    X,
    *,
    zero_center: bool = True,
    max_value: Optional[float] = None,
):
    """Standardize genes (columns) to unit variance (scanpy ``pp.scale``).

    ``zero_center=True`` subtracts the column mean and returns a DENSE
    device array [n, p] (centering destroys sparsity — run after HVG
    subsetting, the scanpy workflow). ``zero_center=False`` multiplies
    by 1/std only and PRESERVES sparsity: a SparseMatrix in stays a
    SparseMatrix. ``max_value`` clips values ABOVE it after scaling
    (scanpy semantics: upper clip only); zero-variance columns are left
    unscaled.
    """

    from .sparse.matrix import SparseMatrix

    mean, _, inv_std = _col_mean_std(X)

    if isinstance(X, SparseMatrix):
        if not zero_center:
            if max_value is not None:
                return X.map_stored(
                    _scale_cols_clip_fn,
                    jnp.asarray(inv_std),
                    jnp.asarray(max_value, X.dtype),
                )
            return X.map_stored(_scale_cols_fn, jnp.asarray(inv_std))
        mr = X._layout_for("row")
        dense = _ell_densify(mr.ell_data, mr.ell_ids, mr.row_nnz, X.ncols)
        dense = dense[: X.nrows]
    else:
        dense = jnp.asarray(X)
        if not zero_center:
            out = dense * inv_std[None, :]
            if max_value is not None:
                out = jnp.minimum(out, jnp.asarray(max_value, out.dtype))
            return out

    out = (dense - mean[None, :]) * inv_std[None, :]
    if max_value is not None:
        out = jnp.minimum(out, jnp.asarray(max_value, out.dtype))
    return out


@jax.jit
def _residual_graph(dense, C):
    """dense [n, p] minus its projection onto span(C) ([n, q], q tiny)."""

    G = C.T @ C  # [q, q]
    CtX = C.T @ dense  # [q, p] matmul
    B = jnp.linalg.solve(G, CtX)
    return dense - C @ B  # [n, p] matmul


def regress_out(X, covariates, *, add_intercept: bool = True):
    """Per-gene OLS residuals against cell covariates (scanpy
    ``pp.regress_out``: remove e.g. total_counts / pct_counts_mito
    effects before scaling).

    ``covariates`` is [n] or [n, q] (host or device). All genes share
    one projector: B = (C^T C)^{-1} C^T X via two matmuls and a
    q x q solve. Returns a dense device array [n, p].
    """

    from .sparse.matrix import SparseMatrix

    cov = jnp.asarray(covariates, jnp.float32)
    if cov.ndim == 1:
        cov = cov[:, None]
    if isinstance(X, SparseMatrix):
        n = X.nrows
        mr = X._layout_for("row")
        dense = _ell_densify(mr.ell_data, mr.ell_ids, mr.row_nnz, X.ncols)
        dense = dense[:n]
    else:
        dense = jnp.asarray(X)
        n = dense.shape[0]
    if cov.shape[0] != n:
        raise ValueError(
            f"covariates rows ({cov.shape[0]}) != matrix rows ({n})"
        )
    if add_intercept:
        cov = jnp.concatenate([jnp.ones((n, 1), cov.dtype), cov], axis=1)
    return _residual_graph(dense, cov)


# ----------------------------------------------------------------------
# ComBat batch correction
# ----------------------------------------------------------------------


def _combat_eb(zs, zss, n_b, max_iter: int = 100, tol: float = 1e-4):
    """Parametric empirical-Bayes shrinkage for one batch (vectors over
    genes). ``zs``/``zss`` are the batch's sum and sum-of-squares of the
    standardized data; returns (gamma_star, delta_sq_star)."""

    g_hat = zs / n_b
    d_hat = np.maximum((zss - n_b * g_hat * g_hat) / (n_b - 1.0), 1e-12)
    g_bar, t2 = g_hat.mean(), g_hat.var()
    m, s2 = d_hat.mean(), max(d_hat.var(), 1e-12)
    a_prior = (2.0 * s2 + m * m) / s2
    b_prior = (m * s2 + m ** 3) / s2

    g_star, d_star = g_hat.copy(), d_hat.copy()
    for _ in range(max_iter):
        g_new = (n_b * t2 * g_hat + d_star * g_bar) / (n_b * t2 + d_star)
        sum2 = zss - 2.0 * g_new * zs + n_b * g_new * g_new
        d_new = (b_prior + 0.5 * sum2) / (n_b / 2.0 + a_prior - 1.0)
        change = max(
            np.abs(g_new - g_star).max() / max(np.abs(g_star).max(), 1e-12),
            np.abs(d_new - d_star).max() / d_star.max(),
        )
        g_star, d_star = g_new, d_new
        if change < tol:
            break
    return g_star, np.maximum(d_star, 1e-12)


@jax.jit
def _affine_by_code(dense, A, C, codes):
    """out[i, g] = dense[i, g] * A[codes[i], g] + C[codes[i], g]."""

    return dense * jnp.take(A, codes, axis=0) + jnp.take(C, codes, axis=0)


def combat(X, batch, *, eb: bool = True):
    """ComBat batch correction (Johnson et al. 2007; scanpy
    ``pp.combat`` without covariates).

    Per-gene location/scale batch effects are estimated from the grouped
    one-hot SpMM moments (zeros included — no dense pass), shrunk with
    the parametric empirical-Bayes fixed point (``eb=False`` skips
    shrinkage), and removed with ONE device affine transform
    ``x * A[batch] + C[batch]``. Input should be log-normalized.
    Returns a dense device array [n, p].
    """

    from .sparse.matrix import SparseMatrix

    if isinstance(X, SparseMatrix):
        n, p = X.shape
        labels, codes = X._batch_codes(list(batch), n, "row")
        sums = np.asarray(X._batch_spmm("col", codes, "sum"), np.float64)
        sumsq = np.asarray(X._batch_spmm("col", codes, "sumsq"), np.float64)
        mr = X._layout_for("row")
        dense = _ell_densify(mr.ell_data, mr.ell_ids, mr.row_nnz, p)[:n]
    else:
        dense = jnp.asarray(X)
        n, p = dense.shape
        batch = list(batch)
        if len(batch) != n:
            raise ValueError(
                f"batch vector length ({len(batch)}) != rows ({n})"
            )
        labels = list(dict.fromkeys(batch))
        code_of = {b: i for i, b in enumerate(labels)}
        codes = np.fromiter((code_of[b] for b in batch), np.int32, n)
        onehot = np.eye(len(labels))[codes]
        Xh = np.asarray(dense, np.float64)
        sums = (Xh.T @ onehot).astype(np.float64)
        sumsq = ((Xh * Xh).T @ onehot).astype(np.float64)

    B = len(labels)
    sizes = np.bincount(codes, minlength=B).astype(np.float64)
    if B < 2:
        return dense  # nothing to correct
    if (sizes < 2).any():
        small = [labels[i] for i in np.where(sizes < 2)[0]]
        raise ValueError(f"batches need >= 2 cells, got singletons: {small}")

    mu = sums / sizes[None, :]  # [p, B] batch means
    alpha = mu @ (sizes / n)  # [p] grand (size-weighted) mean
    # pooled within-batch variance
    var = ((sumsq - sizes[None, :] * mu * mu).sum(axis=1)) / n
    sigma = np.sqrt(np.maximum(var, 1e-12))

    # standardized-data batch moments, derived from the raw moments
    zs = (sums - sizes[None, :] * alpha[:, None]) / sigma[:, None]
    zss = (
        sumsq - 2.0 * alpha[:, None] * sums
        + sizes[None, :] * (alpha ** 2)[:, None]
    ) / (sigma ** 2)[:, None]

    A = np.empty((B, p), np.float64)
    C = np.empty((B, p), np.float64)
    for b in range(B):
        if eb:
            g_star, d_star = _combat_eb(zs[:, b], zss[:, b], sizes[b])
        else:
            g_star = zs[:, b] / sizes[b]
            d_star = np.maximum(
                (zss[:, b] - sizes[b] * g_star * g_star) / (sizes[b] - 1.0),
                1e-12,
            )
        d_std = np.sqrt(d_star)
        A[b] = 1.0 / d_std
        C[b] = alpha - (alpha + sigma * g_star) / d_std

    return _affine_by_code(
        dense,
        jnp.asarray(A, dense.dtype),
        jnp.asarray(C, dense.dtype),
        jnp.asarray(codes),
    )


# ----------------------------------------------------------------------
# sampling utilities
# ----------------------------------------------------------------------


def subsample(m, *, fraction: Optional[float] = None,
              n_obs: Optional[int] = None, seed: int = 0):
    """Random cell subset (scanpy ``pp.subsample``): exactly one of
    ``fraction`` / ``n_obs``. Returns ``(subset_matrix, row_indices)``
    (indices sorted ascending) so metadata subsets stay aligned."""

    n = m.shape[0]
    if (fraction is None) == (n_obs is None):
        raise ValueError("provide exactly one of fraction / n_obs")
    if fraction is not None:
        if not (0 < fraction <= 1):
            raise ValueError(f"fraction={fraction} must be in (0, 1]")
        n_obs = max(1, int(round(fraction * n)))
    if not (1 <= n_obs <= n):
        raise ValueError(f"n_obs={n_obs} must be in [1, {n}]")
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=n_obs, replace=False))
    return m.select_rows(idx), idx


def downsample_counts(m, counts_per_cell: float, *, seed: int = 0):
    """Downsample raw counts so no cell exceeds ``counts_per_cell``
    total (scanpy ``pp.downsample_counts``): EXACT sampling without
    replacement per cell (multivariate hypergeometric over its stored
    genes), cells already at or below the target untouched. Requires
    integer count data; returns a new SparseMatrix."""

    import scipy.sparse as sp

    from .sparse.matrix import SparseMatrix

    target = int(counts_per_cell)
    if target < 1:
        raise ValueError(f"counts_per_cell={counts_per_cell} must be >= 1")
    X = m.to_scipy().tocsr() if isinstance(m, SparseMatrix) else sp.csr_matrix(m)
    data = X.data
    counts = np.rint(data).astype(np.int64)
    if not np.allclose(data, counts, atol=1e-6) or (counts < 0).any():
        raise ValueError(
            "downsample_counts needs non-negative integer count data"
        )
    rng = np.random.default_rng(seed)
    new_data = counts.copy()
    indptr = X.indptr
    for i in range(X.shape[0]):
        lo, hi = indptr[i], indptr[i + 1]
        row = counts[lo:hi]
        total = int(row.sum())
        if total > target:
            new_data[lo:hi] = rng.multivariate_hypergeometric(row, target)
    out = sp.csr_matrix(
        (new_data.astype(X.data.dtype), X.indices.copy(), indptr.copy()),
        shape=X.shape,
    )
    out.eliminate_zeros()
    return SparseMatrix.from_scipy(out)
