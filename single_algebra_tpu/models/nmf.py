"""Non-negative matrix factorization — the gene-program (cNMF) model.

X ~= W H with W [n, k] >= 0 (cell usages) and H [k, p] >= 0 (gene
programs), Frobenius loss, solved with multiplicative updates (Lee &
Seung 2000; sklearn ``NMF(solver='mu')`` semantics). Accelerator-first shape of
the solver: every update is two SpMM products against the sparse X
(``X @ H^T`` / ``X^T @ W`` on the padded-ELL matmul kernels) plus tiny
[k, k] Gram matmuls — X is never densified, and the whole iteration
(including the loss-based stopping rule) runs inside one jitted
``lax.while_loop``. The loss tracks without a dense residual via
``||X||^2 - 2 <W^T X, H> + tr((W^T W)(H H^T))``.

NNDSVD(a) initialization rides the library's randomized SVD. The
reference library has no factor model beyond PCA; this extends the
rebuilt dimred surface the way UMAP/LSI do.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NMF"]

_EPS = 1e-12


@jax.tree_util.register_pytree_node_class
class _LocalEllOp:
    """Single-device mv/rmv operator over the row-/col-major ELL payloads
    (the operator protocol ``ShardedSpMM`` implements over a mesh)."""

    def __init__(self, ed_r, ei_r, ed_c, ei_c, shape):
        self.ed_r, self.ei_r = ed_r, ei_r
        self.ed_c, self.ei_c = ed_c, ei_c
        self.shape = shape

    def mv(self, B):  # X @ B : [n, k]
        from ..ops.spmm import ell_spmm

        return ell_spmm(self.ed_r, self.ei_r, B)[: self.shape[0]]

    def rmv(self, C):  # X^T @ C : [p, k]
        from ..ops.spmm import ell_spmm

        return ell_spmm(self.ed_c, self.ei_c, C)[: self.shape[1]]

    def tree_flatten(self):
        return (self.ed_r, self.ei_r, self.ed_c, self.ei_c), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@partial(jax.jit, static_argnames=("max_iter",))
def _mu_loop(op, W0, H0, x_sq, tol, max_iter: int):
    """Multiplicative-update loop over any mv/rmv operator pytree —
    the same compiled program serves the local ELL payloads and the
    row-sharded mesh operator (whose products are shard_map + psum)."""

    # prefer the compensated products where the operator has them (the
    # densified-bf16 engine): MU tolerates small product error, but the
    # precise form costs only 2-4 matmul passes and keeps the sklearn loss
    # parity tight
    op_mv = getattr(op, "mv_precise", op.mv)
    op_rmv = getattr(op, "rmv_precise", op.rmv)

    def xh(Ht):  # X @ H^T : [n, k]
        return op_mv(Ht)

    def xtw(W):  # X^T @ W : [p, k]
        return op_rmv(W)

    def loss_from_xht(W, H, XHt):
        # <W^T X, H> = sum(W * (X H^T)) — reuses the SpMM the W update
        # already ran, so the loss costs only [k, k] Grams
        return (
            x_sq
            - 2.0 * jnp.sum(W * XHt)
            + jnp.sum((W.T @ W) * (H @ H.T))
        )

    def body(state):
        W, H, prev, _, it = state
        # H update: H *= (W^T X) / ((W^T W) H)
        num_h = xtw(W).T  # [k, p]
        den_h = (W.T @ W) @ H
        H = H * num_h / jnp.maximum(den_h, _EPS)
        # W update: W *= (X H^T) / (W (H H^T))
        num_w = xh(H.T)  # [n, k]
        den_w = W @ (H @ H.T)
        W = W * num_w / jnp.maximum(den_w, _EPS)
        cur = loss_from_xht(W, H, num_w)
        return W, H, cur, prev - cur, it + 1

    def cond(state):
        _, _, cur, drop, it = state
        # sklearn 'mu' stopping rule: relative loss improvement < tol,
        # checked against the error scale (x_sq)
        return jnp.logical_and(
            it < max_iter,
            jnp.logical_or(it < 2, drop > tol * jnp.maximum(x_sq, _EPS)),
        )

    init = (
        W0, H0, loss_from_xht(W0, H0, xh(H0.T)),
        jnp.asarray(jnp.inf, W0.dtype),
        jnp.asarray(0, jnp.int32),
    )
    W, H, final, _, n_iter = jax.lax.while_loop(cond, body, init)
    return W, H, final, n_iter


class NMF:
    """sklearn-style NMF over a sparse cells x genes matrix.

    ``init``: 'nndsvda' (default — NNDSVD with zeros filled by the data
    mean, the sklearn default for dense-ish problems; deterministic),
    'nndsvd' (zeros stay zero), or 'random' (seeded scaled uniform).
    After ``fit``/``fit_transform``: ``components_`` [k, p],
    ``reconstruction_err_`` (Frobenius), ``n_iter_``.

    ``mesh``: a ``jax.sharding.Mesh`` row-shards X across devices
    (``ShardedSpMM``) — every MU product becomes a local slab SpMM plus
    one psum for ``X^T W``, the [k, k]/[k, p] dense algebra is
    partitioned by XLA, and W stays row-sharded on the mesh. The NNDSVD
    init's randomized SVD runs over the same sharded operator.
    """

    def __init__(
        self,
        n_components: int,
        *,
        init: str = "nndsvda",
        max_iter: int = 200,
        tol: float = 1e-4,
        seed: int = 42,
        mesh=None,
    ):
        if n_components < 1:
            raise ValueError(f"n_components={n_components} must be >= 1")
        if init not in ("nndsvd", "nndsvda", "random"):
            raise ValueError(f"unknown init {init!r}")
        if max_iter < 1:
            raise ValueError(f"max_iter={max_iter} must be >= 1")
        self.n_components = int(n_components)
        self.init = init
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.seed = int(seed)
        self.mesh = mesh
        self.components_: Optional[np.ndarray] = None
        self.reconstruction_err_: Optional[float] = None
        self.n_iter_: Optional[int] = None

    # -- initialization ------------------------------------------------

    def _init_wh(self, m, dt, op=None):
        n, p = m.shape
        k = self.n_components
        if self.init == "random":
            # sklearn scaling: sqrt(mean(X) / k)
            mean = float(np.asarray(m.sum_row(), np.float64).sum()) / (n * p)
            scale = np.sqrt(max(mean, _EPS) / k)
            key = jax.random.PRNGKey(self.seed)
            kw, kh = jax.random.split(key)
            W = scale * jax.random.uniform(kw, (n, k), dt)
            H = scale * jax.random.uniform(kh, (k, p), dt)
            return W, H

        # NNDSVD (Boutsidis & Gallopoulos 2008) from the randomized SVD
        from ..linalg import randomized_svd

        if op is None:
            from .pca import make_engine_operator

            op = make_engine_operator(m, "auto")
        res = randomized_svd(op, k, n_oversamples=10, n_power_iterations=7,
                             seed=self.seed)
        u = np.asarray(res.u, np.float64)
        s = np.asarray(res.s, np.float64)
        vt = np.asarray(res.vt, np.float64)
        W = np.zeros((n, k))
        H = np.zeros((k, p))
        W[:, 0] = np.sqrt(s[0]) * np.abs(u[:, 0])
        H[0] = np.sqrt(s[0]) * np.abs(vt[0])
        for j in range(1, k):
            x, y = u[:, j], vt[j]
            xp, xn = np.maximum(x, 0), np.maximum(-x, 0)
            yp, yn = np.maximum(y, 0), np.maximum(-y, 0)
            npos = np.linalg.norm(xp) * np.linalg.norm(yp)
            nneg = np.linalg.norm(xn) * np.linalg.norm(yn)
            if npos >= nneg:
                norm, xu, yv = npos, xp, yp
            else:
                norm, xu, yv = nneg, xn, yn
            xu_n = np.linalg.norm(xu)
            yv_n = np.linalg.norm(yv)
            if xu_n * yv_n > 0:
                W[:, j] = np.sqrt(s[j] * norm) * xu / xu_n
                H[j] = np.sqrt(s[j] * norm) * yv / yv_n
        if self.init == "nndsvda":
            mean = float(np.asarray(m.sum_row(), np.float64).sum()) / (n * p)
            W[W == 0] = mean
            H[H == 0] = mean
        else:
            # exact zeros stall multiplicative updates; sklearn uses eps
            W[W == 0] = _EPS
            H[H == 0] = _EPS
        return jnp.asarray(W, dt), jnp.asarray(H, dt)

    # -- fitting ---------------------------------------------------------

    def fit_transform(self, m) -> np.ndarray:
        """Fit on a SparseMatrix and return W [n, k] (cell usages)."""

        from ..sparse.matrix import SparseMatrix

        if not isinstance(m, SparseMatrix):
            raise TypeError("NMF.fit_transform expects a SparseMatrix")
        n, p = m.shape
        if self.n_components > min(n, p):
            raise ValueError(
                f"n_components={self.n_components} > min{m.shape}"
            )
        host_min = float(np.asarray(m.min_max_col()[0], np.float64).min()) \
            if m.nnz else 0.0
        if host_min < 0:
            raise ValueError("NMF requires non-negative data")
        dt = m.dtype
        if self.mesh is not None:
            from ..parallel import ShardedSpMM

            op = ShardedSpMM.from_matrix(m, self.mesh)
        else:
            from ..linalg.operators import DensifiedOperator
            from .pca import _needs_lo

            from .. import platform

            if (
                platform.engine_ladder()
                and m.dtype == jnp.float32
                and DensifiedOperator.fits(m.shape, needs_lo=_needs_lo(m))
            ):
                # MU runs ~4 wide products per iteration; the gather
                # SpMM's [rows, W, k] budget makes those sequential
                # micro-blocks, while the bf16 densified payload runs
                # them as single matmuls
                op = DensifiedOperator.from_matrix(m)
            else:
                mr = m._layout_for("row")
                mc = m._layout_for("col")
                op = _LocalEllOp(
                    mr.ell_data, mr.ell_ids, mc.ell_data, mc.ell_ids,
                    (n, p),
                )
        W0, H0 = self._init_wh(m, dt, op if self.mesh is not None else None)
        x_sq = jnp.asarray(
            float(np.asarray(m.sum_row_squared(), np.float64).sum()), dt
        )
        W, H, final, n_iter = _mu_loop(
            op, W0, H0, x_sq, jnp.asarray(self.tol, dt), self.max_iter,
        )
        self.components_ = np.asarray(H)
        self.reconstruction_err_ = float(np.sqrt(max(float(final), 0.0)))
        self.n_iter_ = int(n_iter)
        return np.asarray(W)

    def fit(self, m) -> "NMF":
        self.fit_transform(m)
        return self

    def transform(self, m, *, max_iter: int = 500) -> np.ndarray:
        """Usages of NEW cells under the fitted programs: MU iterations
        on W with H held fixed, run until the loss improvement falls
        under the model's ``tol`` (same stopping rule as ``fit``)."""

        if self.components_ is None:
            raise ValueError("NMF is not fitted")
        from ..sparse.matrix import SparseMatrix

        if not isinstance(m, SparseMatrix):
            raise TypeError("NMF.transform expects a SparseMatrix")
        if m.ncols != self.components_.shape[1]:
            raise ValueError(
                f"matrix has {m.ncols} columns, model fitted on "
                f"{self.components_.shape[1]}"
            )
        dt = m.dtype
        H = jnp.asarray(self.components_, dt)
        HHt = H @ H.T
        XHt = m.matmul_dense(H.T)  # [n, k]
        x_sq = jnp.asarray(
            float(np.asarray(m.sum_row_squared(), np.float64).sum()), dt
        )
        tol = jnp.asarray(self.tol, dt)

        @partial(jax.jit, static_argnames=("iters",))
        def solve(W0, iters: int):
            def loss(W):
                return x_sq - 2.0 * jnp.sum(W * XHt) + jnp.sum(
                    (W.T @ W) * HHt
                )

            def body(state):
                W, prev, _, it = state
                W = W * XHt / jnp.maximum(W @ HHt, _EPS)
                cur = loss(W)
                return W, cur, prev - cur, it + 1

            def cond(state):
                _, cur, drop, it = state
                return jnp.logical_and(
                    it < iters,
                    jnp.logical_or(
                        it < 2, drop > tol * jnp.maximum(x_sq, _EPS)
                    ),
                )

            init = (W0, loss(W0), jnp.asarray(jnp.inf, dt),
                    jnp.asarray(0, jnp.int32))
            W, _, _, _ = jax.lax.while_loop(cond, body, init)
            return W

        mean = float(np.asarray(m.sum_row(), np.float64).sum()) / (
            m.nrows * m.ncols
        )
        W0 = jnp.full(
            (m.nrows, self.n_components),
            np.sqrt(max(mean, _EPS) / self.n_components),
            dt,
        )
        return np.asarray(solve(W0, int(max_iter)))
