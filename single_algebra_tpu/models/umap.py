"""UMAP — Uniform Manifold Approximation and Projection, on device.

The reference lists UMAP as a planned feature (reference ``README.md:146``,
"Planned Features"); this module ships it. The design follows the UMAP
paper (McInnes, Healy, Melville 2018) restructured for an accelerator:

* **kNN graph**: exact, via blocked pairwise squared distances as matmuls
  (``||x||^2 + ||y||^2 - 2 x.y`` with a [block, n] dot per step) +
  ``lax.top_k`` — no approximate NN forest needed at the n <= few-100k
  scale this library targets (embeddings come from :class:`SparsePCA`,
  k ~ 50 dims).
* **Fuzzy simplicial set**: the smooth-kNN sigma calibration is a
  vectorized fixed-iteration binary search (jit, no data-dependent
  control flow); symmetrization ``W + W^T - W o W^T`` on the host over
  the n*k edge list.
* **Layout optimizer**: the negative-sampling SGD runs as ONE jitted
  ``lax.fori_loop`` over epochs; each epoch processes EVERY edge,
  vectorized — attraction gated by per-edge Bernoulli draws with
  probability proportional to edge weight (the dense-accelerator equivalent of
  umap-learn's epochs_per_sample schedule), repulsion from
  ``negative_sample_rate`` uniform negatives per active edge, updates
  applied with deterministic XLA scatter-adds.

Differences from umap-learn, documented: exact kNN (not NN-descent),
per-epoch Bernoulli edge gating (not the integer epochs-per-sample
schedule), and both endpoints of an edge receive gradient updates (as in
umap-learn's move_other=True fit path).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["UMAP", "UMAPConfig"]


def _fit_ab(spread: float, min_dist: float) -> tuple[float, float]:
    """Least-squares fit of the differentiable low-dim similarity curve
    ``1 / (1 + a d^(2b))`` to the fuzzy membership target (exp decay past
    min_dist) — umap-learn's find_ab_params."""

    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.ones_like(xv)
    mask = xv >= min_dist
    yv[mask] = np.exp(-(xv[mask] - min_dist) / spread)

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=5000)
    return float(a), float(b)


@partial(jax.jit, static_argnames=("k", "block"))
def _knn_graph(X: jnp.ndarray, *, k: int, block: int = 2048):
    """Exact kNN (excluding self): returns (dists [n,k], idx [n,k]).

    Blocked [block, n] distance matmul tiles; memory O(block * n).
    """

    n = X.shape[0]
    sq = jnp.sum(X * X, axis=1)  # [n]
    nb = -(-n // block)
    Xp = jnp.pad(X, ((0, nb * block - n), (0, 0)))
    sqp = jnp.pad(sq, (0, nb * block - n), constant_values=jnp.inf)

    def body(i, acc):
        d_all, i_all = acc
        xb = jax.lax.dynamic_slice(Xp, (i * block, 0), (block, X.shape[1]))
        sb = jax.lax.dynamic_slice(sqp, (i * block,), (block,))
        d2 = (
            sb[:, None]
            + sq[None, :]
            - 2.0
            * jax.lax.dot_general(
                xb, X,
                dimension_numbers=((((1,), (1,))), ((), ())),
                preferred_element_type=jnp.float32,
            )
        )
        # exclude self-matches by masking the diagonal of this block
        rows = i * block + jnp.arange(block)
        d2 = jnp.where(rows[:, None] == jnp.arange(n)[None, :], jnp.inf, d2)
        nd, ni = jax.lax.top_k(-d2, k)
        d_all = jax.lax.dynamic_update_slice(d_all, -nd, (i * block, 0))
        i_all = jax.lax.dynamic_update_slice(
            i_all, ni.astype(jnp.int32), (i * block, 0)
        )
        return d_all, i_all

    d0 = jnp.zeros((nb * block, k), jnp.float32)
    i0 = jnp.zeros((nb * block, k), jnp.int32)
    d_all, i_all = jax.lax.fori_loop(0, nb, body, (d0, i0))
    d = jnp.sqrt(jnp.maximum(d_all[:n], 0.0))
    return d, i_all[:n]


def _metric_prep(X: jnp.ndarray, metric: str) -> jnp.ndarray:
    """Input prep for the blocked euclidean kNN kernels: 'cosine' rides
    the SAME matmul tiles on L2-normalized rows (unit-sphere euclidean is
    monotone in cosine distance; convert with :func:`_to_cosine_dist`).
    Zero rows stay zero (distance 1 to everything, like umap-learn)."""

    if metric == "euclidean":
        return X
    if metric == "cosine":
        nrm = jnp.linalg.norm(X, axis=1, keepdims=True)
        return X / jnp.maximum(nrm, 1e-12)
    raise ValueError(
        f"unknown metric {metric!r}; expected 'euclidean' or 'cosine'"
    )


def _to_cosine_dist(d_euclidean: jnp.ndarray) -> jnp.ndarray:
    """Unit-sphere euclidean -> cosine distance: 1 - cos = d^2 / 2."""

    return d_euclidean * d_euclidean * 0.5


@jax.jit
def _smooth_knn(dists: jnp.ndarray, *, n_iter: int = 64):
    """Per-point (rho, sigma) calibration: rho = nearest nonzero distance,
    sigma solves sum_j exp(-(d_ij - rho)/sigma) = log2(k) by a fixed
    64-step binary search (umap-learn smooth_knn_dist)."""

    k = dists.shape[1]
    target = jnp.log2(jnp.asarray(float(k), jnp.float32))
    pos = jnp.where(dists > 0, dists, jnp.inf)
    rho = jnp.where(
        jnp.isfinite(pos.min(axis=1)), pos.min(axis=1), 0.0
    )  # [n]

    def psum(sigma):
        return jnp.sum(
            jnp.exp(-jnp.maximum(dists - rho[:, None], 0.0) / sigma[:, None]),
            axis=1,
        )

    lo = jnp.full(rho.shape, 1e-8, jnp.float32)
    hi = jnp.full(rho.shape, 1e4, jnp.float32)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        too_big = psum(mid) > target
        return jnp.where(too_big, lo, mid), jnp.where(too_big, mid, hi)

    lo, hi = jax.lax.fori_loop(0, n_iter, body, (lo, hi))
    sigma = 0.5 * (lo + hi)
    # umap-learn floors sigma at a fraction of the mean distance
    mean_d = jnp.mean(dists)
    sigma = jnp.maximum(sigma, 1e-3 * mean_d)
    return rho, sigma


def fuzzy_connectivities(
    X, k: int, *, block: int = 2048, method: str = "auto",
    metric: str = "euclidean", mesh=None,
):
    """Symmetric fuzzy-simplicial-set weights as scipy CSR [n, n].

    The kNN distances, (rho, sigma) calibration, and directed membership
    weights are computed on device (matmul distance tiles + elementwise exp); the
    fuzzy set union ``W + W^T - W o W^T`` is sparse host algebra over the
    n*k edge list. This is scanpy's ``pp.neighbors`` connectivities — the
    graph UMAP lays out and Leiden clusters.

    ``method``: 'exact' = blocked O(n^2 d) kNN; 'ivf' = the approximate
    IVF index (``neighbors.ivf_knn``, recall ~1.0 on embeddings);
    'auto' switches to 'ivf' above 200k rows, where the exact quadratic
    pass stops being the right tool.
    """

    import scipy.sparse as sp

    X = _metric_prep(jnp.asarray(X, jnp.float32), metric)
    n = X.shape[0]
    if method not in ("auto", "exact", "ivf"):
        raise ValueError(f"Unknown kNN method {method!r}")
    if method == "ivf" or (method == "auto" and n > 200_000):
        from ..neighbors import ivf_knn

        dists, idx = ivf_knn(np.asarray(X), k)
    elif mesh is not None:
        from ..neighbors import _knn_graph_mesh

        ax = mesh.axis_names[0]
        rs = max(-(-n // mesh.shape[ax]), 8)
        blk = min(block, max(rs // 8 // 8 * 8, 8))
        rs = -(-rs // blk) * blk
        dists, idx = _knn_graph_mesh(
            X, k=k, block=blk, rs=rs, n=n, mesh=mesh, axis_name=ax
        )
    else:
        dists, idx = _knn_graph(X, k=k, block=block)
    if metric == "cosine":
        dists = _to_cosine_dist(dists)
    rho, sigma = _smooth_knn(dists)
    W = jnp.exp(-jnp.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = np.asarray(idx, np.int64).ravel()
    vals = np.asarray(W, np.float64).ravel()
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return A + A.T - A.multiply(A.T)


@partial(jax.jit, static_argnames=("epochs", "neg_rate"))
def _transform_layout(
    Ynew, Ytrain, idx, w, key, *, epochs: int, neg_rate: int,
    a: float, b: float, lr: float,
):
    """One-sided layout for out-of-sample points: only ``Ynew`` moves;
    its kNN memberships attract toward the FROZEN training embedding,
    uniform training negatives repel. [m, k, dim] vectorized epochs."""

    m, k = w.shape
    n_train = Ytrain.shape[0]
    a = jnp.float32(a)
    b = jnp.float32(b)
    eps = 1e-3

    def epoch(e, carry):
        Y, key = carry
        alpha = lr * (1.0 - e.astype(jnp.float32) / epochs)
        key, k1, k2 = jax.random.split(key, 3)
        active = jax.random.uniform(k1, (m, k)) < w
        yt = Ytrain[idx]  # [m, k, dim]
        dvec = Y[:, None, :] - yt
        d2 = jnp.sum(dvec * dvec, axis=2, keepdims=True)
        g_att = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2**b)
        g_att = jnp.where(active[:, :, None], g_att, 0.0)
        grad = jnp.clip(g_att * dvec, -4.0, 4.0).sum(axis=1)

        negs = jax.random.randint(k2, (m, neg_rate), 0, n_train)
        yn = Ytrain[negs]
        dn = Y[:, None, :] - yn
        dn2 = jnp.sum(dn * dn, axis=2, keepdims=True)
        g_rep = (2.0 * b) / ((eps + dn2) * (1.0 + a * dn2**b))
        grad = grad + jnp.clip(g_rep * dn, -4.0, 4.0).sum(axis=1)
        return Y + alpha * grad, key

    Y, _ = jax.lax.fori_loop(0, epochs, epoch, (Ynew, key))
    return Y


@partial(
    jax.jit,
    static_argnames=("n_epochs", "neg_rate", "n"),
    donate_argnums=(0,),
)
def _layout_chunk(
    Y,  # [n, dim] initial embedding
    heads,  # [m] int32, SORTED ascending (CSR row order)
    tails,  # [m] int32
    weights,  # [m] f32, normalized to max 1
    tperm,  # [m] int32: argsort(tails) — host-precomputed once
    tails_sorted,  # [m] int32: tails[tperm]
    key,
    e0,  # dynamic: first epoch of this dispatch (absolute index)
    e1,  # dynamic: one past the last
    *,
    n: int,
    n_epochs: int,
    neg_rate: int,
    a: float,
    b: float,
    lr: float,
):
    """Negative-sampling SGD layout for epochs [e0, e1) — ONE dispatch.

    Per-edge gradients are reduced into per-point updates with TWO sorted
    ``segment_sum``s per epoch (heads are CSR-sorted; tails through a
    fixed precomputed permutation) — sorted segment reductions lower to
    contiguous accumulation, where millions of row-scatters into a
    narrow [n, 2] array are both slow and fault-prone.

    The epoch bounds are DYNAMIC (traced): one compiled program serves
    every chunk, and the host loop in :func:`_optimize_layout` bounds
    single-execution device time — at n ~ 10^5 a full-epoch-count single
    execution runs for minutes in one launch, exactly as in the t-SNE
    knn mode.
    """

    m = heads.shape[0]
    a = jnp.float32(a)
    b = jnp.float32(b)
    eps = 1e-3

    def epoch(e, carry):
        Y, key = carry
        alpha = lr * (1.0 - e.astype(jnp.float32) / n_epochs)
        key, k1, k2 = jax.random.split(key, 3)
        active = jax.random.uniform(k1, (m,)) < weights  # Bernoulli gate

        yh = jnp.take(Y, heads, axis=0)  # [m, dim]
        yt = jnp.take(Y, tails, axis=0)
        d = yh - yt
        d2 = jnp.sum(d * d, axis=1, keepdims=True)
        # attractive gradient of log(1/(1+a d^{2b}))
        g_att = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2**b)
        g_att = jnp.where(active[:, None], g_att, 0.0)
        grad_h = jnp.clip(g_att * d, -4.0, 4.0)

        # repulsion: neg_rate uniform negatives per (active) edge — ONE
        # batched [m, neg_rate, dim] pass (a single gather + vectorized
        # arithmetic) instead of neg_rate sequential [m, dim] passes
        negs = jax.random.randint(k2, (m, neg_rate), 0, n)
        yn = jnp.take(Y, negs, axis=0)  # [m, neg_rate, dim]
        dn = yh[:, None, :] - yn  # [m, neg_rate, dim]
        dn2 = jnp.sum(dn * dn, axis=2, keepdims=True)
        g_rep = (2.0 * b) / ((eps + dn2) * (1.0 + a * dn2**b))
        g_rep = jnp.where(active[:, None, None], g_rep, 0.0)
        # umap-learn skips self-negatives
        g_rep = jnp.where((negs == heads[:, None])[..., None], 0.0, g_rep)
        head_grad = grad_h + jnp.sum(
            jnp.clip(g_rep * dn, -4.0, 4.0), axis=1
        )  # [m, dim]

        upd = jax.ops.segment_sum(
            head_grad, heads, num_segments=n, indices_are_sorted=True
        )
        upd = upd + jax.ops.segment_sum(
            -jnp.take(grad_h, tperm, axis=0),  # move_other
            tails_sorted,
            num_segments=n,
            indices_are_sorted=True,
        )
        return Y + alpha * upd, key

    return jax.lax.fori_loop(e0, e1, epoch, (Y, key))


# epochs per device dispatch in the chunked layout driver
_LAYOUT_CHUNK = 50


def _optimize_layout(
    Y, heads, tails, weights, tperm, tails_sorted, key, *,
    n, n_epochs, neg_rate, a, b, lr,
):
    """Chunk-dispatched driver over :func:`_layout_chunk`."""

    state = (Y, key)
    for c0 in range(0, n_epochs, _LAYOUT_CHUNK):
        state = _layout_chunk(
            state[0], heads, tails, weights, tperm, tails_sorted, state[1],
            jnp.int32(c0), jnp.int32(min(c0 + _LAYOUT_CHUNK, n_epochs)),
            n=n, n_epochs=n_epochs, neg_rate=neg_rate, a=a, b=b, lr=lr,
        )
    return state[0]


class UMAPConfig:
    """Configuration holder mirroring the builder-style configs of the
    reference (cf. ``TSNEConfig``, reference ``tsne/mod.rs:7-13``)."""

    def __init__(
        self,
        n_components: int = 2,
        n_neighbors: int = 15,
        min_dist: float = 0.1,
        spread: float = 1.0,
        n_epochs: int = 200,
        learning_rate: float = 1.0,
        negative_sample_rate: int = 5,
        random_seed: int = 42,
        metric: str = "euclidean",
    ):
        if metric not in ("euclidean", "cosine"):
            raise ValueError(
                f"unknown metric {metric!r}; expected 'euclidean' or "
                "'cosine'"
            )
        self.n_components = n_components
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.spread = spread
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.negative_sample_rate = negative_sample_rate
        self.random_seed = random_seed
        self.metric = metric


class UMAP:
    """UMAP over dense embeddings (typically :class:`SparsePCA` scores).

    ``fit_transform(X)`` with X ``[n, d]`` (numpy or jnp) returns the
    ``[n, n_components]`` embedding as a jnp array (device-resident —
    downstream similarity / clustering consumes it on-chip).
    """

    def __init__(self, config: Optional[UMAPConfig] = None, **kw):
        self.config = config or UMAPConfig(**kw)
        self.embedding_: Optional[jnp.ndarray] = None
        self.graph_: Optional[tuple] = None

    def fit_transform(self, X) -> jnp.ndarray:
        cfg = self.config
        X = jnp.asarray(X, jnp.float32)
        n = X.shape[0]
        k = min(cfg.n_neighbors, n - 1)
        if k < 1:
            raise ValueError("need at least 2 samples")

        S = fuzzy_connectivities(
            X, k, block=min(2048, max(8, n)), metric=cfg.metric
        )
        S = S.tocoo()
        keep = S.data > 1e-8
        h_np = S.row[keep].astype(np.int32)  # COO from CSR: row-sorted
        t_np = S.col[keep].astype(np.int32)
        tperm_np = np.argsort(t_np, kind="stable").astype(np.int32)
        heads = jnp.asarray(h_np)
        tails = jnp.asarray(t_np)
        tperm = jnp.asarray(tperm_np)
        tails_sorted = jnp.asarray(t_np[tperm_np])
        w = S.data[keep]
        weights = jnp.asarray((w / w.max()).astype(np.float32))
        self.graph_ = (heads, tails, weights)
        self._train_X = np.asarray(X, np.float32)  # for transform()

        a, b = _fit_ab(cfg.spread, cfg.min_dist)

        # spectral-free init: scaled PCA of X projected to n_components
        # (cheap, deterministic, good enough at library scale)
        Xc = X - X.mean(axis=0, keepdims=True)
        _, _, vt = jnp.linalg.svd(
            Xc[: min(n, 4096)], full_matrices=False
        )
        Y0 = jnp.dot(Xc, vt[: cfg.n_components].T)
        Y0 = Y0 / (jnp.std(Y0) + 1e-9) * 10.0
        key = jax.random.PRNGKey(cfg.random_seed)
        if Y0.shape[1] < cfg.n_components:
            # input had fewer dims than n_components: PCA init can only
            # seed d columns — fill the rest with small noise so the
            # documented [n, n_components] contract holds
            key, kpad = jax.random.split(key)
            Y0 = jnp.concatenate(
                [
                    Y0,
                    jax.random.normal(
                        kpad, (n, cfg.n_components - Y0.shape[1])
                    ),
                ],
                axis=1,
            )
        Y0 = Y0 + 0.1 * jax.random.normal(key, Y0.shape)

        self.embedding_ = _optimize_layout(
            Y0.astype(jnp.float32),
            heads,
            tails,
            weights,
            tperm,
            tails_sorted,
            jax.random.PRNGKey(cfg.random_seed + 1),
            n=n,
            n_epochs=cfg.n_epochs,
            neg_rate=cfg.negative_sample_rate,
            a=a,
            b=b,
            lr=cfg.learning_rate,
        )
        return self.embedding_

    def transform(self, X_new, *, epochs: int = 30) -> jnp.ndarray:
        """Embed NEW points into the fitted space (umap-learn
        ``transform``): each new point is initialized at the
        membership-weighted average of its training neighbors'
        embeddings, then optimized one-sidedly (training embedding
        frozen) — attraction along its kNN memberships, negative
        sampling against random training points. One jitted loop.
        """

        if self.embedding_ is None:
            raise RuntimeError("Must be fitted before transform!")
        cfg = self.config
        Xn = jnp.asarray(X_new, jnp.float32)
        train = self._train_X
        if Xn.ndim != 2 or Xn.shape[1] != train.shape[1]:
            raise ValueError(
                f"X_new must be [m, {train.shape[1]}], got {Xn.shape}"
            )
        n_train = train.shape[0]
        k = min(cfg.n_neighbors, n_train)

        from ..neighbors import cross_knn

        d, idx = cross_knn(np.asarray(Xn), train, k, metric=cfg.metric)
        rho, sigma = _smooth_knn(d)
        W = jnp.exp(-jnp.maximum(d - rho[:, None], 0.0) / sigma[:, None])
        Wn = W / jnp.maximum(W.sum(axis=1, keepdims=True), 1e-12)
        Ytrain = jnp.asarray(self.embedding_, jnp.float32)
        Y0 = jnp.einsum("mk,mkd->md", Wn, Ytrain[idx])

        a, b = _fit_ab(cfg.spread, cfg.min_dist)
        return _transform_layout(
            Y0, Ytrain, idx, (W / W.max()).astype(jnp.float32),
            jax.random.PRNGKey(cfg.random_seed + 2),
            epochs=epochs, neg_rate=cfg.negative_sample_rate,
            a=a, b=b, lr=cfg.learning_rate,
        )
