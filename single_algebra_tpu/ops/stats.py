"""Statistic kernels over the padded-ELL layout (pure jitted XLA).

JAX rebuild of the reference's L1 sparse-statistics layer
(``src/sparse/mod.rs`` traits, implemented for CSR in ``src/sparse/csr.rs``
and CSC in ``src/sparse/csc.rs``). The reference parallelizes ragged CSR
walks with Rayon (per-chunk local accumulators + tree reduce,
``csr.rs:56-75``); here every statistic over the *major* axis is a masked
width-axis reduction over the ELL grid — a single fused elementwise pass — and
statistics over the *minor* axis are the same reduction applied to the
transposed layout (see ``SparseMatrix``).

Conventions:

* ``ell_data [R, W]`` float values, zero-padded.
* ``ell_ids  [R, W]`` int32 minor indices, zero-padded.
* ``row_nnz  [R]``    number of valid entries per major line. Validity comes
  from ``row_nnz`` (not ``data != 0``) so explicitly stored zeros count as
  entries, matching reference semantics (``csr.rs:50-52`` counts stored
  entries).
* Masked variants take ``mask`` over the **minor** axis (length = minor dim):
  an entry participates iff ``mask[id]``. This matches the reference where
  e.g. CSR ``sum_col_masked`` masks rows — on the transposed layout rows are
  the minor axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "valid_mask",
    "count_major",
    "sum_major",
    "sum_major_squared",
    "sum_major_masked",
    "sum_major_squared_masked",
    "count_major_masked",
    "min_max_major",
    "var_stored_major",
    "var_stored_major_masked",
    "sum_major_n_top",
]


def valid_mask(ell_ids: jnp.ndarray, row_nnz: jnp.ndarray) -> jnp.ndarray:
    """[R, W] bool — True where the slot holds a stored entry."""

    width = ell_ids.shape[1]
    w_iota = jax.lax.broadcasted_iota(jnp.int32, (1, width), 1)
    return w_iota < row_nnz[:, None]


@jax.jit
def count_major(ell_ids: jnp.ndarray, row_nnz: jnp.ndarray) -> jnp.ndarray:
    """Stored-entry count per major line (reference nonzero_row, csr.rs:79)."""

    del ell_ids
    return row_nnz


@jax.jit
def sum_major(ell_data: jnp.ndarray) -> jnp.ndarray:
    """Sum of stored entries per major line (reference sum_row, csr.rs:314).

    Padding slots are exact zeros so no mask is needed.
    """

    return jnp.sum(ell_data, axis=1)


@jax.jit
def sum_major_squared(ell_data: jnp.ndarray) -> jnp.ndarray:
    """Sum of squared stored entries per major line (csr.rs:558,610)."""

    return jnp.sum(ell_data * ell_data, axis=1)


@jax.jit
def _gathered_mask(
    ell_ids: jnp.ndarray, row_nnz: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """[R, W] bool — slot valid AND its minor index is masked-in."""

    return valid_mask(ell_ids, row_nnz) & jnp.take(
        mask, ell_ids, axis=0, mode="clip"
    )


@jax.jit
def sum_major_masked(
    ell_data: jnp.ndarray,
    ell_ids: jnp.ndarray,
    row_nnz: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    m = _gathered_mask(ell_ids, row_nnz, mask)
    return jnp.sum(jnp.where(m, ell_data, 0), axis=1)


@jax.jit
def sum_major_squared_masked(
    ell_data: jnp.ndarray,
    ell_ids: jnp.ndarray,
    row_nnz: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    m = _gathered_mask(ell_ids, row_nnz, mask)
    return jnp.sum(jnp.where(m, ell_data * ell_data, 0), axis=1)


@jax.jit
def count_major_masked(
    ell_ids: jnp.ndarray, row_nnz: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    m = _gathered_mask(ell_ids, row_nnz, mask)
    return jnp.sum(m.astype(jnp.int32), axis=1)


@jax.jit
def min_max_major(
    ell_data: jnp.ndarray, ell_ids: jnp.ndarray, row_nnz: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Min/max of stored entries per major line (csr.rs:914-1011).

    Matches the reference's sentinel behavior: lines with no stored entries
    keep ``(dtype_max, dtype_min)`` — finite extremes, not infinities
    (reference initializes with ``Item::max_value()``/``min_value()``,
    csr.rs:921-922).
    """

    info = jnp.finfo(ell_data.dtype)
    m = valid_mask(ell_ids, row_nnz)
    mins = jnp.min(jnp.where(m, ell_data, info.max), axis=1)
    maxs = jnp.max(jnp.where(m, ell_data, info.min), axis=1)
    return mins, maxs


@jax.jit
def var_stored_major(
    ell_data: jnp.ndarray, ell_ids: jnp.ndarray, row_nnz: jnp.ndarray
) -> jnp.ndarray:
    """Population variance of the *stored entries only* per major line.

    This is the semantics of the reference's ``var_*_chunk`` and ``_masked``
    variants (``csr.rs:744-762``, ``csr.rs:853-859``): mean and variance over
    the nonzero count, no Bessel correction, 0 where the count is 0. Distinct
    from :func:`var_major_dense` (see stats_dense) which the plain
    ``var_col``/``var_row`` endpoints use.
    """

    count = row_nnz.astype(ell_data.dtype)
    s = sum_major(ell_data)
    sq = sum_major_squared(ell_data)
    safe = jnp.maximum(count, 1)
    mean = s / safe
    # clamp: sq/n - mean^2 cancels catastrophically for near-constant
    # lines and can round negative
    var = jnp.maximum(sq / safe - mean * mean, 0)
    return jnp.where(count > 0, var, 0)


@jax.jit
def var_stored_major_masked(
    ell_data: jnp.ndarray,
    ell_ids: jnp.ndarray,
    row_nnz: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    count = count_major_masked(ell_ids, row_nnz, mask).astype(ell_data.dtype)
    s = sum_major_masked(ell_data, ell_ids, row_nnz, mask)
    sq = sum_major_squared_masked(ell_data, ell_ids, row_nnz, mask)
    safe = jnp.maximum(count, 1)
    mean = s / safe
    var = jnp.maximum(sq / safe - mean * mean, 0)
    return jnp.where(count > 0, var, 0)


@partial(jax.jit, static_argnames=("n",))
def sum_major_n_top(
    ell_data: jnp.ndarray,
    ell_ids: jnp.ndarray,
    row_nnz: jnp.ndarray,
    n: int,
) -> jnp.ndarray:
    """Sum of the top-n stored entries per major line (csr.rs:1347-1376).

    Lines with count <= n sum everything, matching the reference. Stored
    entries can be negative, so invalid slots are masked to -inf before the
    top-k selection rather than relying on zero padding.
    """

    width = ell_data.shape[1]
    if n >= width:
        return sum_major(ell_data)
    m = valid_mask(ell_ids, row_nnz)
    neg = jnp.finfo(ell_data.dtype).min
    masked = jnp.where(m, ell_data, neg)
    top, _ = jax.lax.top_k(masked, n)
    top_valid = top > neg  # drop -inf fills for short rows
    return jnp.sum(jnp.where(top_valid, top, 0), axis=1)


def var_bessel_dense(
    s: jnp.ndarray, sq: jnp.ndarray, n: int
) -> jnp.ndarray:
    """Bessel-corrected variance over the full dense axis of length ``n``.

    Semantics of the reference's plain ``var_col`` (``csr.rs:641-657``):
    implicit zeros participate, ``var = (sq/n - mean^2) * n/(n-1)``.

    Note: the reference's ``var_row`` divides by ``nrows`` even for row
    variances (``csr.rs:689-691``) — a defect when the matrix is not square.
    We implement the intended semantics (divide by the length of the axis
    being reduced) and document the divergence here.
    """

    dt = s.dtype
    nf = jnp.asarray(n, dtype=dt)
    mean = s / nf
    # clamp: the cancelling form can round negative for near-constant axes
    pop = jnp.maximum(sq / nf - mean * mean, 0)
    if n <= 1:
        return jnp.zeros_like(s)
    return pop * (nf / (nf - 1))
