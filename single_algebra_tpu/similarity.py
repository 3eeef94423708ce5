"""Pairwise similarity measures (reference ``src/similarity/mod.rs``).

The reference ships six measures behind a ``SimilarityMeasure`` trait but
never wires the module into the crate (``src/similarity`` is absent from
``src/lib.rs:43-48`` — an orphan; SURVEY.md §2 component 12). Here the module
is first-class, and each measure has two entry points:

* ``calculate(a, b)`` — single-pair parity with the reference (same guards:
  zero-norm -> 0.0, union == 0 -> 0.0, etc.).
* ``pairwise(X, Y=None)`` — the accelerator form: batched [n, m] similarity
  over row-embedding matrices. Cosine/Pearson run as matmuls over normalized
  Gram matrices; Euclidean uses the ||x||^2 + ||y||^2 - 2<x,y> expansion;
  Manhattan/Jaccard are blocked elementwise reductions (no inner-product shortcut
  exists for L1/threshold counts).

Reference semantics preserved exactly, including the quirky ones:

* Jaccard counts |a_i - b_i| < threshold positions as intersection
  (both-zero positions included) while the union counts only positions
  where either value is positive (``similarity/mod.rs:149-166``) — the
  ratio can exceed 1; we do not "fix" this.
* Euclidean/Manhattan are RBF-style conversions ``exp(-gamma * dist)``
  with gamma defaulting to 1.0 (``similarity/mod.rs:44-51, 108-118``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .types import MATMUL_PRECISION

__all__ = [
    "SimilarityMeasure",
    "CosineSimilarity",
    "EuclideanSimilarity",
    "PearsonSimilarity",
    "ManhattanSimilarity",
    "JaccardSimilarity",
]

# row-block size for the O(n*m*p) measures' gathered intermediates
_BLOCK = 1 << 22


def _as2d(x):
    x = jnp.asarray(x)
    return x[None, :] if x.ndim == 1 else x


def _block_rows(n: int, m: int, p: int) -> int:
    br = max(1, _BLOCK // max(m * p, 1))
    return min(br, n)


def _blocked_pairwise(X, Y, row_fn):
    """Apply ``row_fn(X_block [b, 1, p], Y [1, m, p]) -> [b, m]`` in blocks."""

    n, p = X.shape
    m = Y.shape[0]
    br = _block_rows(n, m, p)
    nb = -(-n // br)
    Xp = jnp.pad(X, ((0, nb * br - n), (0, 0)))
    blocks = Xp.reshape(nb, br, p)

    def one(block):
        return row_fn(block[:, None, :], Y[None, :, :])

    out = jax.lax.map(one, blocks)
    return out.reshape(nb * br, m)[:n]


class SimilarityMeasure:
    """Base: ``calculate`` delegates to a 1x1 ``pairwise``."""

    def calculate(self, a, b) -> float:
        a = _as2d(a)
        b = _as2d(b)
        return float(self.pairwise(a, b)[0, 0])

    def pairwise(self, X, Y=None) -> jnp.ndarray:  # pragma: no cover
        raise NotImplementedError


class CosineSimilarity(SimilarityMeasure):
    """dot/(||a||*||b||); 0 when the norm product underflows
    (similarity/mod.rs:12-36)."""

    def pairwise(self, X, Y=None) -> jnp.ndarray:
        X = _as2d(X)
        Y = X if Y is None else _as2d(Y)
        return _cosine_pairwise(X, Y)


@jax.jit
def _cosine_pairwise(X, Y):
    g = jnp.dot(X, Y.T, precision=MATMUL_PRECISION)
    nx = jnp.sqrt(jnp.sum(X * X, axis=1))
    ny = jnp.sqrt(jnp.sum(Y * Y, axis=1))
    denom = nx[:, None] * ny[None, :]
    eps = jnp.finfo(X.dtype).eps
    return jnp.where(denom > eps, g / jnp.maximum(denom, eps), 0.0)


class EuclideanSimilarity(SimilarityMeasure):
    """exp(-gamma * ||a - b||_2) (similarity/mod.rs:38-67)."""

    def __init__(self, gamma: float = 1.0):
        self.gamma = float(gamma)

    def pairwise(self, X, Y=None) -> jnp.ndarray:
        X = _as2d(X)
        Y = X if Y is None else _as2d(Y)
        return _euclidean_pairwise(X, Y, self.gamma)


@partial(jax.jit, static_argnames=("gamma",))
def _euclidean_pairwise(X, Y, gamma: float):
    g = jnp.dot(X, Y.T, precision=MATMUL_PRECISION)
    sq = (
        jnp.sum(X * X, axis=1)[:, None]
        + jnp.sum(Y * Y, axis=1)[None, :]
        - 2.0 * g
    )
    dist = jnp.sqrt(jnp.maximum(sq, 0.0))
    return jnp.exp(-gamma * dist)


class PearsonSimilarity(SimilarityMeasure):
    """Pearson correlation; 0 when a denominator underflows
    (similarity/mod.rs:69-101)."""

    def pairwise(self, X, Y=None) -> jnp.ndarray:
        X = _as2d(X)
        Y = X if Y is None else _as2d(Y)
        return _pearson_pairwise(X, Y)


@jax.jit
def _pearson_pairwise(X, Y):
    p = X.shape[1]
    Xc = X - jnp.mean(X, axis=1, keepdims=True)
    Yc = Y - jnp.mean(Y, axis=1, keepdims=True)
    num = jnp.dot(Xc, Yc.T, precision=MATMUL_PRECISION)
    vx = jnp.sqrt(jnp.sum(Xc * Xc, axis=1))
    vy = jnp.sqrt(jnp.sum(Yc * Yc, axis=1))
    denom = vx[:, None] * vy[None, :]
    eps = jnp.finfo(X.dtype).eps
    return jnp.where(denom > eps, num / jnp.maximum(denom, eps), 0.0)


class ManhattanSimilarity(SimilarityMeasure):
    """exp(-gamma * ||a - b||_1) (similarity/mod.rs:103-130)."""

    def __init__(self, gamma: float = 1.0):
        self.gamma = float(gamma)

    def pairwise(self, X, Y=None) -> jnp.ndarray:
        X = _as2d(X)
        Y = X if Y is None else _as2d(Y)
        return _manhattan_pairwise(X, Y, self.gamma)


@partial(jax.jit, static_argnames=("gamma",))
def _manhattan_pairwise(X, Y, gamma: float):
    def rows(xb, yb):
        return jnp.sum(jnp.abs(xb - yb), axis=-1)

    d1 = _blocked_pairwise(X, Y, rows)
    return jnp.exp(-gamma * d1)


class JaccardSimilarity(SimilarityMeasure):
    """|{i: |a_i-b_i| < t}| / |{i: a_i>0 or b_i>0}|; 0 when the union is
    empty (similarity/mod.rs:132-172; quirks preserved — see module doc)."""

    def __init__(self, threshold: float | None = None):
        self.threshold = (
            float(np.finfo(np.float64).eps) if threshold is None else float(threshold)
        )

    def pairwise(self, X, Y=None) -> jnp.ndarray:
        X = _as2d(X)
        Y = X if Y is None else _as2d(Y)
        return _jaccard_pairwise(X, Y, self.threshold)


@partial(jax.jit, static_argnames=("threshold",))
def _jaccard_pairwise(X, Y, threshold: float):
    def rows(xb, yb):
        inter = jnp.sum(
            (jnp.abs(xb - yb) < threshold).astype(X.dtype), axis=-1
        )
        union = jnp.sum(((xb > 0) | (yb > 0)).astype(X.dtype), axis=-1)
        return jnp.where(union > 0, inter / jnp.maximum(union, 1.0), 0.0)

    return _blocked_pairwise(X, Y, rows)
