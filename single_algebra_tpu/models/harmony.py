"""Harmony batch integration over PCA embeddings (matmul formulation).

Korsunsky et al. 2019 (harmonypy structure): iterate (a) diversity-
penalized soft spherical k-means over the cosine-normalized embedding
and (b) per-cluster ridge regression removing batch effects, until the
objective stabilizes.

Everything is dense [n, K] / [n, B] / [K, d] linear algebra — a natural
matmul workload. The soft-assignment block updates, the co-occurrence
bookkeeping, and the K ridge solves (vmapped [B+1, B+1] systems) are
each one jitted graph; the Python level only sequences harmony/k-means
rounds. The reference ships no integration; its downstream users run
harmonypy on CPU — this is that role, built for the accelerator.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["harmony", "HarmonyResult"]


@dataclasses.dataclass
class HarmonyResult:
    embedding: np.ndarray  # [n, d] corrected
    objective: list  # per harmony round
    n_rounds: int
    converged: bool


def _l2n(X, axis=1):
    return X / jnp.maximum(
        jnp.linalg.norm(X, axis=axis, keepdims=True), 1e-12
    )


@partial(jax.jit, static_argnames=("sigma", "theta"))
def _assign_block(Zc_blk, phi_blk, Y, O, E, sigma: float, theta: float):
    """Diversity-penalized soft assignment for one cell block.

    R ~ exp(-2(1 - cos)/sigma) * prod_b ((E+1)/(O+1))^theta gathered by
    the block's batch; returns the normalized R block.
    """

    dist = 2.0 * (1.0 - Zc_blk @ Y.T)  # [blk, K]
    penalty = ((E + 1.0) / (O + 1.0)) ** theta  # [B, K]
    logr = -dist / sigma + phi_blk @ jnp.log(penalty)
    logr = logr - logr.max(axis=1, keepdims=True)
    R = jnp.exp(logr)
    return R / R.sum(axis=1, keepdims=True)


@jax.jit
def _objective(Zc, Y, R, O, E, sigma, theta):
    """Harmony objective: kmeans error + entropy + diversity penalty."""

    err = jnp.sum(R * 2.0 * (1.0 - Zc @ Y.T))
    ent = sigma * jnp.sum(R * jnp.log(jnp.maximum(R, 1e-30)))
    div = sigma * theta * jnp.sum(
        O * jnp.log(jnp.maximum((O + 1.0) / (E + 1.0), 1e-30))
    )
    return err + ent + div


@partial(jax.jit, static_argnames=("sigma", "theta"))
def _kmeans_sweep(Zc, phi, R, O, E, nb_frac, blocks, sigma: float,
                  theta: float):
    """One diversity-kmeans iteration as ONE device graph.

    Centroid update + the full permuted block sweep ride a
    ``lax.fori_loop`` over ``blocks`` ([n_blocks, blk] permuted cell ids,
    padded with ``n`` — out-of-range scatter rows are dropped, gathers
    clamp and are masked). A per-block Python loop costs ~8 host
    dispatches per block; this is one dispatch per iteration.
    """

    n = Zc.shape[0]
    Y0 = _l2n(R.T @ Zc)

    def body(bi, carry):
        R, O, E = carry
        idx = blocks[bi]
        valid = (idx < n)[:, None].astype(R.dtype)
        Rb = jnp.take(R, idx, axis=0, mode="clip") * valid
        phib = jnp.take(phi, idx, axis=0, mode="clip") * valid
        O1 = O - phib.T @ Rb
        E1 = E - jnp.outer(nb_frac, Rb.sum(0))
        Rb_new = _assign_block(
            jnp.take(Zc, idx, axis=0, mode="clip"), phib, Y0, O1, E1,
            sigma, theta,
        ).astype(R.dtype) * valid
        R = R.at[idx].set(Rb_new, mode="drop")
        O = O1 + phib.T @ Rb_new
        E = E1 + jnp.outer(nb_frac, Rb_new.sum(0))
        return R, O, E

    R, O, E = jax.lax.fori_loop(0, blocks.shape[0], body, (R, O, E))
    obj = _objective(Zc, Y0, R, O, E, sigma, theta)
    return R, O, E, obj


@partial(jax.jit, static_argnames=("sigma", "theta", "eps"))
def _kmeans_rounds(Zc, phi, R, O, E, nb_frac, perms, sigma: float,
                   theta: float, eps: float):
    """A full diversity-kmeans phase — up to ``perms.shape[0]``
    iterations with the relative-objective stopping rule — as ONE device
    graph (``perms`` [max_iters, n_blocks, blk] pre-generated permuted
    cell ids). One dispatch + one scalar pull per harmony ROUND instead
    of one per kmeans iteration."""

    max_iters = perms.shape[0]

    def cond(state):
        it, prev, obj, _ = state
        done = jnp.abs(prev - obj) < eps * jnp.abs(prev)
        return jnp.logical_and(it < max_iters,
                               jnp.logical_or(it < 2, ~done))

    def body(state):
        it, _, obj, (R, O, E) = state
        R, O, E, new_obj = _kmeans_sweep(
            Zc, phi, R, O, E, nb_frac, perms[it], sigma, theta
        )
        return it + 1, obj, new_obj, (R, O, E)

    _, _, obj, (R, O, E) = jax.lax.while_loop(
        cond,
        body,
        (jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, Zc.dtype),
         jnp.asarray(jnp.inf, Zc.dtype), (R, O, E)),
    )
    return R, O, E, obj


@partial(jax.jit, static_argnames=("lam",))
def _correct(Z, R, phi_star, lam: float):
    """Per-cluster ridge removal of batch effects.

    For each cluster k:  W_k = (Phi*^T diag(R_k) Phi* + lam I')^-1
    Phi*^T diag(R_k) Z, intercept unpenalized and its correction row
    zeroed; Z_corr = Z - sum_k R_k * (Phi* W_k).
    """

    n, q = phi_star.shape
    K = R.shape[1]
    d = Z.shape[1]

    def one(k):
        rk = R[:, k]  # [n]
        Pw = phi_star * rk[:, None]  # [n, q]
        A = Pw.T @ phi_star  # [q, q]
        ridge = jnp.concatenate(
            [jnp.zeros(1, Z.dtype), jnp.ones(q - 1, Z.dtype)]
        )
        A = A + lam * jnp.diag(ridge)
        b = Pw.T @ Z  # [q, d]
        W = jnp.linalg.solve(A, b)
        return W.at[0].set(0.0)  # keep the cluster's own centroid

    W = jax.vmap(one)(jnp.arange(K))  # [K, q, d]
    # correction = sum_k R[:, k] * (phi_star @ W_k)
    corr = jnp.einsum("nq,kqd,nk->nd", phi_star, W, R)
    return Z - corr


def harmony(
    Z,
    batch: Sequence,
    *,
    n_clusters: Optional[int] = None,
    sigma: float = 0.1,
    theta: float = 2.0,
    lam: float = 1.0,
    max_rounds: int = 10,
    max_kmeans_iters: int = 20,
    block_frac: float = 0.05,
    eps_kmeans: float = 1e-5,
    eps_harmony: float = 1e-4,
    seed: int = 0,
) -> HarmonyResult:
    """Remove batch effects from an embedding (harmonypy semantics).

    Z : [n, d] PCA embedding (host or device). batch : length-n labels.
    theta : diversity pressure (0 = plain soft kmeans). Returns the
    corrected embedding; downstream neighbors/clustering/UMAP run on it
    unchanged.
    """

    Z = np.asarray(Z, np.float32)
    if Z.ndim != 2:
        raise ValueError(f"Z must be [n, d], got {Z.shape}")
    n, d = Z.shape
    batch = list(batch)
    if len(batch) != n:
        raise ValueError(f"batch length ({len(batch)}) != rows ({n})")
    labels = list(dict.fromkeys(batch))
    B = len(labels)
    if B < 2:
        return HarmonyResult(Z.copy(), [], 0, True)
    code_of = {b: i for i, b in enumerate(labels)}
    codes = np.fromiter((code_of[b] for b in batch), np.int32, n)
    phi = jnp.asarray(np.eye(B, dtype=np.float32)[codes])  # [n, B]
    phi_star = jnp.concatenate([jnp.ones((n, 1), jnp.float32), phi], 1)

    K = n_clusters or int(min(100, max(2, round(n / 30))))
    K = min(K, n)
    rng = np.random.default_rng(seed)

    Zd = jnp.asarray(Z)
    Zc = _l2n(Zd)

    # init centroids: spherical kmeans via our KMeans on the cosine ball
    from .kmeans import KMeans

    km = KMeans(n_clusters=K, n_init=1, max_iter=10, random_seed=seed)
    km.fit(np.asarray(Zc))
    Y = _l2n(jnp.asarray(km.cluster_centers_, jnp.float32))

    blk = max(int(np.ceil(n * block_frac)), 1)
    n_blocks = -(-n // blk)

    def full_R(Zc, Y, O, E):
        return _assign_block(Zc, phi, Y, O, E, sigma, theta)

    # initial R without diversity (O == E cancels the penalty)
    O0 = jnp.ones((B, K), jnp.float32)
    R = full_R(Zc, Y, O0, O0)
    nb_frac = phi.sum(0) / n  # [B]
    O = phi.T @ R
    E = jnp.outer(nb_frac, R.sum(0))

    objective = []
    converged = False
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        # -- (a) diversity-penalized spherical kmeans ------------------
        # whole phase = one dispatch: pre-generate every iteration's
        # permutation and run the stopping rule on device
        perms = np.full((max_kmeans_iters, n_blocks * blk), n, np.int32)
        for i in range(max_kmeans_iters):
            perms[i, :n] = rng.permutation(n).astype(np.int32)
        R, O, E, obj = _kmeans_rounds(
            Zc, phi, R, O, E, nb_frac,
            jnp.asarray(perms.reshape(max_kmeans_iters, n_blocks, blk)),
            sigma, theta, eps_kmeans,
        )
        obj = float(obj)
        objective.append(obj)

        # -- (b) ridge correction --------------------------------------
        Zd = _correct(Zd, R, phi_star, lam)
        Zc = _l2n(Zd)

        if len(objective) > 1 and abs(
            objective[-2] - objective[-1]
        ) < eps_harmony * abs(objective[-2]):
            converged = True
            break

    return HarmonyResult(
        np.asarray(Zd), objective, rounds, converged
    )
