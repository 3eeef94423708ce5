"""Densify and products over the column-tiled padded-ELL layout, in XLA.

Layout (built on the host by ``sparse.convert``): the columns are cut into
tiles of ``col_tile`` columns and every (row, tile) group is padded to
``wt`` slots, each holding a value and a within-tile local column id. The
device arrays are TRANSPOSED, ``[ntiles * wt, R]``: slot ``s`` of row ``r``
sits at ``[s, r]`` and its global column is ``(s // wt) * col_tile + lid``.
Padding slots are ``(v=0, lid=0)``.

* :func:`tiled_ell_densify_t` expands a row slab into the transposed dense
  ``[ntiles * col_tile, R]`` matrix by one scatter. Padding slots are routed
  out of range and dropped, so every stored entry lands on its own zeroed
  element and the result is exact in any dtype (int8, bf16, f32, f64).
* :func:`tiled_ell_spmm_t` (``A @ B``) and :func:`tiled_ell_rmv_t`
  (``A^T @ C``) walk the rows in blocks and read the same row-major
  payload, so no second orientation is stored. Each takes the form that
  was the faster on an H100 (PERF.md):

  - ``A @ B`` on 16-bit payloads densifies a block and contracts it with
    the dense operand on the tensor cores; on 32/64-bit payloads it
    gathers the operand's rows by global column id and reduces;
  - ``A^T @ C`` scatter-adds each stored value times its row of ``C``
    into the output row of its column.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["tiled_ell_densify_t", "tiled_ell_spmm_t", "tiled_ell_rmv_t"]

# rows densified per product step (a [ntiles * col_tile, block] buffer);
# untuned on the GPU
_PRODUCT_BLOCK = 8192
# elements of the [slots, rows, kp] intermediate per gather/scatter step
_GATHER_ELEMS = 1 << 26


def _product_block(R: int) -> int:
    """Largest row block <= ``_PRODUCT_BLOCK`` that divides ``R``. Payload
    rows are padded to a multiple of 128 (1024 past 1024 rows), so the
    block never drops below 128."""

    return R if R <= _PRODUCT_BLOCK else math.gcd(R, _PRODUCT_BLOCK)


def _gather_block(S: int, R: int, kp: int) -> int:
    """Largest power of two within the gather budget that divides ``R``."""

    budget = max(_GATHER_ELEMS // (S * kp), 1)
    return math.gcd(R, 1 << (budget.bit_length() - 1))


def _global_cols(tlocal, wt: int, col_tile: int):
    """Slot ``s`` of a row sits in tile ``s // wt``: local id -> column."""

    S = tlocal.shape[0]
    tile0 = (jnp.arange(S, dtype=jnp.int32) // wt) * col_tile
    return tlocal.astype(jnp.int32) + tile0[:, None]


def _dot_precision(dtype):
    # f32/f64 payloads contract at full precision (no TF32 on the GPU);
    # bf16 payloads take the native tensor-core path with f32 accumulation
    if jnp.dtype(dtype).itemsize == 2:
        return None
    return jax.lax.Precision.HIGHEST


def _accum_dtype(payload_dtype, operand_dtype):
    # 16-bit payloads must NOT accumulate in their own dtype
    if jnp.dtype(payload_dtype).itemsize == 2:
        return jnp.float32
    return jnp.result_type(payload_dtype, operand_dtype)


@partial(jax.jit, static_argnames=("wt", "ntiles", "col_tile", "out_dtype"))
def tiled_ell_densify_t(
    tdata_t: jnp.ndarray,  # [ntiles * wt, R]
    tlocal_t: jnp.ndarray,  # [ntiles * wt, R] local col ids (any int dtype)
    *,
    wt: int,
    ntiles: int,
    col_tile: int,
    out_dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """The tiled layout -> the TRANSPOSED dense matrix
    ``[ntiles * col_tile, R]`` (columns on axis 0, rows on axis 1)."""

    S, R = tdata_t.shape
    pp = ntiles * col_tile
    # padding (and any stored zero) goes out of range: no two updates
    # share an element, so the add into zeros is exact
    cols = jnp.where(tdata_t != 0, _global_cols(tlocal_t, wt, col_tile), pp)
    rows = jax.lax.broadcasted_iota(jnp.int32, (S, R), 1)
    out = jnp.zeros((pp, R), out_dtype)
    return out.at[cols, rows].add(tdata_t.astype(out_dtype), mode="drop")


@partial(jax.jit, static_argnames=("wt", "ntiles", "col_tile", "out_dtype"))
def tiled_ell_spmm_t(
    tdata_t: jnp.ndarray,  # [ntiles * wt, R] values
    tlocal_t: jnp.ndarray,  # [ntiles * wt, R] local col ids
    Bt: jnp.ndarray,  # [kp, ntiles * col_tile] dense operand, transposed
    *,
    wt: int,
    ntiles: int,
    col_tile: int,
    out_dtype=None,
) -> jnp.ndarray:
    """``out[k, r] = sum_c A[r, c] * B[c, k]`` -> ``[kp, R]`` (transposed).

    ``out_dtype`` is the accumulator dtype (default: f32 for 16-bit
    payloads, else the wider of payload and operand)."""

    assert Bt.shape[1] == ntiles * col_tile, (Bt.shape, ntiles, col_tile)
    if out_dtype is None:
        out_dtype = _accum_dtype(tdata_t.dtype, Bt.dtype)
    form = (
        _spmm_densify if jnp.dtype(tdata_t.dtype).itemsize == 2
        else _spmm_gather
    )
    return form(tdata_t, tlocal_t, Bt, wt=wt, ntiles=ntiles,
                col_tile=col_tile, out_dtype=out_dtype)


@partial(jax.jit, static_argnames=("wt", "ntiles", "col_tile", "out_dtype"))
def tiled_ell_rmv_t(
    tdata_t: jnp.ndarray,  # [ntiles * wt, R] values
    tlocal_t: jnp.ndarray,  # [ntiles * wt, R] local col ids
    Ct: jnp.ndarray,  # [kp, R] dense operand, transposed
    *,
    wt: int,
    ntiles: int,
    col_tile: int,
    out_dtype=None,
) -> jnp.ndarray:
    """``out[c, k] = sum_r A[r, c] * C[r, k]`` -> ``[ntiles * col_tile, kp]``."""

    S, R = tdata_t.shape
    kp = Ct.shape[0]
    assert Ct.shape[1] == R, (Ct.shape, tdata_t.shape)
    if out_dtype is None:
        out_dtype = _accum_dtype(tdata_t.dtype, Ct.dtype)
    pp = ntiles * col_tile
    blk = _gather_block(S, R, kp)

    def block(i, acc):
        v = jax.lax.dynamic_slice(tdata_t, (0, i * blk), (S, blk))
        c = _global_cols(
            jax.lax.dynamic_slice(tlocal_t, (0, i * blk), (S, blk)),
            wt, col_tile,
        )
        c = jnp.where(v != 0, c, pp)  # padding slots are dropped
        Cb = jax.lax.dynamic_slice(Ct, (0, i * blk), (kp, blk)).T
        contrib = v.astype(out_dtype)[:, :, None] * Cb.astype(out_dtype)[None]
        return acc.at[c].add(contrib, mode="drop")

    # the carry starts from block 0's scatter, so it has the payload's
    # sharding type inside shard_map bodies
    acc = block(0, jnp.zeros((pp, kp), out_dtype))
    return jax.lax.fori_loop(1, R // blk, block, acc)


def _spmm_densify(tdata_t, tlocal_t, Bt, *, wt, ntiles, col_tile, out_dtype):
    """``A @ B``: densify each row block, contract it on the tensor cores."""

    S, R = tdata_t.shape
    kp = Bt.shape[0]
    blk = _product_block(R)
    prec = _dot_precision(tdata_t.dtype)

    def block(i):
        td = jax.lax.dynamic_slice(tdata_t, (0, i * blk), (S, blk))
        tl = jax.lax.dynamic_slice(tlocal_t, (0, i * blk), (S, blk))
        D = tiled_ell_densify_t(
            td, tl, wt=wt, ntiles=ntiles, col_tile=col_tile,
            out_dtype=tdata_t.dtype,
        )
        return jax.lax.dot_general(
            Bt.astype(D.dtype), D,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=out_dtype,
            precision=prec,
        )  # [kp, blk]

    nb = R // blk
    if nb == 1:
        return block(0)
    # stacked block outputs rather than a zero-initialised loop carry, so
    # the function also traces inside shard_map bodies
    out = jax.lax.map(block, jnp.arange(nb))  # [nb, kp, blk]
    return jnp.moveaxis(out, 0, 1).reshape(kp, R)


def _spmm_gather(tdata_t, tlocal_t, Bt, *, wt, ntiles, col_tile, out_dtype):
    """``A @ B``: gather B's rows by global column id, reduce over slots.
    Padding slots gather a real row and weigh it by an exact 0."""

    S, R = tdata_t.shape
    kp = Bt.shape[0]
    B = Bt.T.astype(out_dtype)  # [P, kp]
    blk = _gather_block(S, R, kp)

    def block(i):
        v = jax.lax.dynamic_slice(tdata_t, (0, i * blk), (S, blk))
        c = _global_cols(
            jax.lax.dynamic_slice(tlocal_t, (0, i * blk), (S, blk)),
            wt, col_tile,
        )
        g = jnp.take(B, c, axis=0)  # [S, blk, kp]
        return jnp.einsum("sr,srk->rk", v.astype(out_dtype), g,
                          precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.map(block, jnp.arange(R // blk))  # [nb, blk, kp]
    return out.reshape(R, kp).T
