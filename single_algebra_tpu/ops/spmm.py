"""Sparse @ dense products over the padded-ELL layout.

This is the rebuild's keystone primitive: the reference's SVD engine is
generic over "anything providing matvec/dims" (``single-svdlib``'s
``svd_las2``/``randomized_svd`` accept both ``CsrMatrix`` and
``MaskedCSRMatrix``, reference ``src/dimred/pca/sparse/mod.rs:137`` vs
``sparse_masked/mod.rs:322-329``); we preserve that seam and make SpMM the
single hot kernel every higher layer wraps. Column statistics, masked
statistics, and batch group-by statistics all reduce to ``A^T @ m`` for small
dense ``m`` (ones / mask / one-hot codes), so one optimized kernel serves the
whole library.

:func:`ell_spmm` is a pure-XLA row-blocked gather + contraction. The
column-tiled layout's densify-then-contract products live in
``ops/tiled.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import MATMUL_PRECISION

__all__ = ["ell_spmm", "ell_spmm_xla", "ell_scatter_densify"]


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("n",))
def ell_scatter_densify(ell_data, ell_ids, row_nnz, n: int):
    """Major-axis ELL block -> dense [rows, n] by one device scatter.

    Shared by the DE rank kernel, preprocess densify, and imputation —
    one jit cache entry per shape instead of per-module duplicates.
    """

    R, W = ell_data.shape
    w_iota = jax.lax.broadcasted_iota(jnp.int32, (R, W), 1)
    valid = w_iota < row_nnz[:, None]
    vals = jnp.where(valid, ell_data, 0.0)
    ids = jnp.where(valid, ell_ids, 0)
    r = jax.lax.broadcasted_iota(jnp.int32, (R, W), 0)
    return jnp.zeros((R, n), ell_data.dtype).at[r, ids].add(vals)

# Elements budget for the gathered [BR, W, k] intermediate per row block.
_GATHER_BUDGET = 1 << 22


def _row_block(W: int, k: int, R: int) -> int:
    br = max(8, _GATHER_BUDGET // max(W * k, 1))
    br = (br // 8) * 8
    return min(br, R)


@jax.jit
def ell_spmm_xla(
    ell_data: jnp.ndarray,
    ell_ids: jnp.ndarray,
    B: jnp.ndarray,
) -> jnp.ndarray:
    """``out[r, :] = sum_w ell_data[r, w] * B[ell_ids[r, w], :]``.

    Padding slots have ``data == 0`` / ``id == 0`` so they contribute exact
    zeros; no validity mask is needed. Processes rows in blocks to bound the
    gathered intermediate at ~16 MB.
    """

    R, W = ell_data.shape
    k = B.shape[1]
    br = _row_block(W, k, R)
    nb = -(-R // br)
    Rp = nb * br
    if Rp != R:
        ell_data = jnp.pad(ell_data, ((0, Rp - R), (0, 0)))
        ell_ids = jnp.pad(ell_ids, ((0, Rp - R), (0, 0)))

    def block(args):
        d, i = args
        g = jnp.take(B, i, axis=0)  # [br, W, k]
        return jax.lax.dot_general(
            d[:, None, :],
            g,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            precision=MATMUL_PRECISION,
        )[:, 0, :]

    if nb == 1:
        return block((ell_data, ell_ids))[:R]

    data_b = ell_data.reshape(nb, br, W)
    ids_b = ell_ids.reshape(nb, br, W)
    out = jax.lax.map(block, (data_b, ids_b))
    return out.reshape(Rp, k)[:R]


def ell_spmm(
    ell_data: jnp.ndarray,
    ell_ids: jnp.ndarray,
    B: jnp.ndarray,
) -> jnp.ndarray:
    """SpMM over the plain padded-ELL layout (XLA gather path).

    The tiled densify-then-contract path lives behind
    ``TiledSparseOperator`` (it needs the column-tiled layout); this entry
    point serves the stats/batch ops and the sharded slabs."""

    return ell_spmm_xla(ell_data, ell_ids, B)
