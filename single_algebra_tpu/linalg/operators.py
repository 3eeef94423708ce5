"""Linear-operator seam between sparse storage and the SVD engines.

The reference's SVD crate is generic over "anything with matvec + dims":
``svd_las2``/``randomized_svd`` accept both ``CsrMatrix`` and the zero-copy
column-masked ``MaskedCSRMatrix`` view (reference
``src/dimred/pca/sparse/mod.rs:137`` vs ``sparse_masked/mod.rs:322-329``;
``lanczos::masked::MaskedCSRMatrix`` at ``sparse_masked/mod.rs:15,313``).
We preserve that seam as a tiny pytree-operator hierarchy:

* :class:`SparseOperator`  — products via the padded-ELL SpMM kernels.
* :class:`MaskedOperator`  — column-masked view: an int32 gather/scatter map
  replaces the reference's mask HashMap (``sparse_masked/mod.rs:462-466``).
* :class:`CenteredOperator`— implicit mean-centering as a rank-1 correction,
  the equivalent of single-svdlib's ``center_flag`` in randomized_svd
  (``sparse/mod.rs:176``): ``A_c @ B = A @ B - 1 (mu^T B)`` — the matrix is
  never densified.

All operators are pytrees, so jitted SVD loops close over them transparently.
Shapes are logical (masked operators report the masked width).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spmm import ell_spmm
from ..ops.tiled import tiled_ell_rmv_t, tiled_ell_spmm_t
from ..types import MATMUL_PRECISION

# term count for the OPERAND split in the *_precise product paths: each
# bf16 term captures 8 mantissa bits, so the dropped residual is
# ~2^-(8*terms) relative. 2 terms floor explained variance near ~1.5e-5
# (sigma^2 doubles the 2^-17 residual, in every A-space randomized
# engine); 3 terms put the residual (~2^-26) under the f32 accumulation
# noise.
OPERAND_TERMS = 3


def bf16_terms(B: jnp.ndarray, terms: int = OPERAND_TERMS) -> list:
    """Split f32 ``B`` into ``terms`` bf16 arrays summing to ``B`` with a
    ~2^-(8*terms) relative residual. Each cast is barriered: the
    simplifier may otherwise fold the f32->bf16->f32 round trip to
    identity, zeroing every residual term (see
    :meth:`DensifiedOperator._split`)."""

    out = []
    r = B
    for _ in range(terms - 1):
        h = jax.lax.optimization_barrier(r.astype(jnp.bfloat16))
        out.append(h)
        r = r - h.astype(B.dtype)
    out.append(r.astype(jnp.bfloat16))
    return out


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SparseOperator:
    """Products with a SparseMatrix via both ELL orientations.

    Built eagerly from a :class:`SparseMatrix` (forcing the transpose cache)
    so the jitted SVD loops receive plain arrays.
    """

    row_data: jnp.ndarray  # row-major ELL  [R, Wr]
    row_ids: jnp.ndarray
    col_data: jnp.ndarray  # col-major ELL  [C, Wc]
    col_ids: jnp.ndarray
    shape: Tuple[int, int]

    @classmethod
    def from_matrix(cls, m) -> "SparseOperator":
        row = m._layout_for("row")
        col = m._layout_for("col")
        return cls(
            row.ell_data, row.ell_ids, col.ell_data, col.ell_ids, m.shape
        )

    def mv(self, B: jnp.ndarray) -> jnp.ndarray:
        """A @ B, B: [ncols, k] -> [nrows, k]."""

        return ell_spmm(self.row_data, self.row_ids, B)[: self.shape[0]]

    def rmv(self, C: jnp.ndarray) -> jnp.ndarray:
        """A.T @ C, C: [nrows, k] -> [ncols, k]."""

        return ell_spmm(self.col_data, self.col_ids, C)[: self.shape[1]]

    def tree_flatten(self):
        return (
            (self.row_data, self.row_ids, self.col_data, self.col_ids),
            (self.shape,),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenseOperator:
    """Dense fallback operator (tests, small problems)."""

    a: jnp.ndarray

    @property
    def shape(self):
        return self.a.shape

    def mv(self, B):
        return jnp.dot(self.a, B, precision=MATMUL_PRECISION)

    def rmv(self, C):
        return jnp.dot(self.a.T, C, precision=MATMUL_PRECISION)

    def tree_flatten(self):
        return (self.a,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MaskedOperator:
    """Column-masked view: logical shape (n, p_masked).

    ``mask_idx[i]`` = full-width column of masked column i. ``mv`` scatters
    the narrow operand into full width (columns outside the mask multiply
    zeros); ``rmv`` gathers the masked rows of the full-width product.
    """

    base: SparseOperator
    mask_idx: jnp.ndarray  # [p_masked] int32

    @property
    def shape(self):
        return (self.base.shape[0], self.mask_idx.shape[0])

    def mv(self, B):
        full = jnp.zeros(
            (self.base.shape[1], B.shape[1]), dtype=B.dtype
        ).at[self.mask_idx].set(B)
        return self.base.mv(full)

    def rmv(self, C):
        return jnp.take(self.base.rmv(C), self.mask_idx, axis=0)

    def mv_precise(self, B):
        full = jnp.zeros(
            (self.base.shape[1], B.shape[1]), dtype=B.dtype
        ).at[self.mask_idx].set(B)
        base = getattr(self.base, "mv_precise", self.base.mv)
        return base(full)

    def rmv_precise(self, C):
        base = getattr(self.base, "rmv_precise", self.base.rmv)
        return jnp.take(base(C), self.mask_idx, axis=0)

    def mv_fast(self, B):
        full = jnp.zeros(
            (self.base.shape[1], B.shape[1]), dtype=B.dtype
        ).at[self.mask_idx].set(B)
        base = getattr(self.base, "mv_fast", self.base.mv)
        return base(full)

    def rmv_fast(self, C):
        base = getattr(self.base, "rmv_fast", self.base.rmv)
        return jnp.take(base(C), self.mask_idx, axis=0)

    def tree_flatten(self):
        return (self.base, self.mask_idx), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CenteredOperator:
    """Implicitly column-centered view of any operator.

    ``mu`` has the operator's logical width. Rank-1 corrections keep the
    matrix sparse, matching single-svdlib's implicit centering.

    The ``rmv*`` products use OPERAND DEFLATION: ``A_c^T C`` is computed
    as ``A^T (C - 1 cbar^T) - mu (1^T (C - 1 cbar^T))`` with
    ``cbar = (1^T C)/n``. Algebraically this differs from the direct form
    only by ``(A^T 1 - n mu) cbar^T`` — bounded by ``eps32 * mu * (1^T C)``
    since ``mu`` is the stored f32 column mean — but numerically it is the
    difference between a usable and an unusable sigma: the direct form
    stores the f32 intermediate ``A^T C`` at the UNCENTERED column scale
    (entries ~``mu_j * (1^T C)_k``) and then cancels it down to the
    centered scale, flooring the relative accuracy of ``B = Q^T A_c`` at
    ~``eps32 * mu/sigma`` — a ~5e-6 explained-variance floor on
    scRNA-like counts, in every A-space randomized engine. Deflating the
    operand first keeps
    every partial sum at the centered scale. Power iterations (``rmv`` /
    ``rmv_fast``) get the same treatment — one column-sum + broadcast
    subtract per product, noise next to the SpMM itself.
    """

    base: object
    mu: jnp.ndarray  # [p]

    @property
    def shape(self):
        return self.base.shape

    def _deflate(self, C):
        """(C - 1 cbar^T, residual column sums) — the residual is the
        post-deflation ``1^T Cd`` (~n*eps32 roundoff), kept so the rank-1
        ``mu`` correction stays exact wrt the deflated operand."""

        n = self.base.shape[0]
        cbar = jnp.sum(C, axis=0) / jnp.asarray(n, C.dtype)
        Cd = C - cbar[None, :]
        return Cd, jnp.sum(Cd, axis=0)

    def mv(self, B):
        corr = jnp.dot(self.mu, B, precision=MATMUL_PRECISION)  # [k]
        return self.base.mv(B) - corr[None, :]

    def rmv(self, C):
        Cd, t = self._deflate(C)
        return self.base.rmv(Cd) - self.mu[:, None] * t[None, :]

    def mv_precise(self, B):
        base = getattr(self.base, "mv_precise", self.base.mv)
        corr = jnp.dot(self.mu, B, precision=MATMUL_PRECISION)
        return base(B) - corr[None, :]

    def rmv_precise(self, C):
        base = getattr(self.base, "rmv_precise", self.base.rmv)
        Cd, t = self._deflate(C)
        return base(Cd) - self.mu[:, None] * t[None, :]

    def mv_fast(self, B):
        base = getattr(self.base, "mv_fast", self.base.mv)
        corr = jnp.dot(self.mu, B, precision=MATMUL_PRECISION)
        return base(B) - corr[None, :]

    def rmv_fast(self, C):
        base = getattr(self.base, "rmv_fast", self.base.rmv)
        Cd, t = self._deflate(C)
        return base(Cd) - self.mu[:, None] * t[None, :]

    def tree_flatten(self):
        return (self.base, self.mu), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)





def _densify_split_device(ed, ei, nz, n: int, p: int, blk: int):
    """Row-blocked device densify + barriered bf16 hi/lo split of an ELL
    payload whose values live only on device. Returns (hi [n, p] bf16,
    lo [n, p] bf16, exact flag). Peak memory = hi + lo + one [blk, p]
    f32 block; the last block clamps its start (overlap rewrites the
    same values)."""

    from functools import partial as _partial

    from ..ops.spmm import ell_scatter_densify

    @_partial(jax.jit, static_argnames=("n", "p", "blk"))
    def run(ed, ei, nz, n, p, blk):
        W = ed.shape[1]
        nb = -(-n // blk)

        def body(b, carry):
            hi, lo = carry
            start = jnp.minimum(b * blk, n - blk)
            z = jnp.zeros((), start.dtype)
            d = jax.lax.dynamic_slice(ed, (start, z), (blk, W))
            i = jax.lax.dynamic_slice(ei, (start, z), (blk, W))
            c = jax.lax.dynamic_slice(nz, (start,), (blk,))
            dense = ell_scatter_densify(d, i, c, p)
            # barrier the hi cast: the simplifier may fold
            # f32->bf16->f32 round trips to identity (see _split below)
            h = jax.lax.optimization_barrier(dense.astype(jnp.bfloat16))
            l = (dense - h.astype(dense.dtype)).astype(jnp.bfloat16)
            hi = jax.lax.dynamic_update_slice(hi, h, (start, z))
            lo = jax.lax.dynamic_update_slice(lo, l, (start, z))
            return hi, lo

        hi0 = jnp.zeros((n, p), jnp.bfloat16)
        lo0 = jnp.zeros((n, p), jnp.bfloat16)
        hi, lo = jax.lax.fori_loop(0, nb, body, (hi0, lo0))
        return hi, lo, jnp.logical_not(jnp.any(lo != 0))

    return run(ed, ei, nz, n, p, min(blk, n))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DensifiedOperator:
    """Dense-bf16 fast path for matrices whose dense form fits the device.

    At single-cell densities (1-15%) a [n, p] bf16 densification often fits
    comfortably in device memory, and the tensor cores then run the
    sketching products at dense matmul speed. Accuracy story:

    * ``hi`` holds bf16(x). For raw count matrices with values <= 256 this
      is EXACT (bf16 has an 8-bit mantissa), so nothing is lost.
    * ``lo`` holds bf16(x - hi): together ~16 mantissa bits. ``mv_precise``/
      ``rmv_precise`` contract both halves (two bf16 passes, f32
      accumulation); the SVD engine uses the precise form for the final
      projection, while power iterations ride the fast hi-only path —
      subspace perturbations enter explained variance only at second order.
    * ``lo`` is dropped entirely when the input is bf16-exact.

    Construction densifies on the HOST in row chunks (numpy) to avoid
    device scatter; the dense array is laid out [n, p] and both products
    are XLA ``dot_general`` contractions (no explicit transpose).
    """

    hi: jnp.ndarray  # [n, p] bfloat16
    lo: jnp.ndarray | None  # [n, p] bfloat16 or None when exact
    shape: Tuple[int, int]

    @staticmethod
    def densify_host(m):
        """Host-side densification -> numpy ``(hi, lo_or_None)`` bf16
        arrays. Shared by the single-device constructor and the sharded
        engine (which must NOT stage the full array on one device)."""

        import ml_dtypes

        sp_mat = m.to_scipy().tocsr()
        n, p = m.shape
        vals = sp_mat.data.astype(np.float32)
        hi_vals = vals.astype(ml_dtypes.bfloat16)
        lo_vals = vals - hi_vals.astype(np.float32)
        exact = not np.any(lo_vals)

        from ..native import build as _native

        nat = _native.csr_densify_bf16(
            sp_mat.indptr.astype(np.int64),
            sp_mat.indices.astype(np.int32),
            vals,
            n,
            p,
            need_lo=not exact,
        )
        if nat is not None:
            hi_u16, lo_u16, _ = nat
            hi = hi_u16.view(ml_dtypes.bfloat16)
            lo = None if exact else lo_u16.view(ml_dtypes.bfloat16)
            return hi, lo

        # numpy fallback: memset + nnz-only scatter — O(dense) zeroing +
        # O(nnz) conversion, never a dense f32 intermediate
        rows = np.repeat(
            np.arange(n, dtype=np.int64),
            np.diff(sp_mat.indptr).astype(np.int64),
        )
        cols = sp_mat.indices.astype(np.int64)
        hi = np.zeros((n, p), dtype=ml_dtypes.bfloat16)
        hi[rows, cols] = hi_vals
        lo = None
        if not exact:
            lo = np.zeros((n, p), dtype=ml_dtypes.bfloat16)
            lo[rows, cols] = lo_vals.astype(ml_dtypes.bfloat16)
        return hi, lo

    @classmethod
    def from_matrix(cls, m, *, device: bool = False) -> "DensifiedOperator":
        if device or getattr(m, "_h_data", None) is None:
            # values live only on device (post value-map matrices):
            # densify + split there instead of pulling the full payload
            # to the host through to_scipy()
            return cls._from_matrix_device(m)
        hi, lo = cls.densify_host(m)
        return cls(
            jnp.asarray(hi),
            None if lo is None else jnp.asarray(lo),
            m.shape,
        )

    @classmethod
    def _from_matrix_device(cls, m) -> "DensifiedOperator":
        """Densify + barriered bf16 hi/lo split on DEVICE, in row blocks
        (peak = hi + lo + one [blk, p] f32 block). ``lo`` is dropped when
        a device reduction confirms the values are bf16-exact."""

        mr = m._layout_for("row")
        n, p = m.shape
        hi, lo, exact = _densify_split_device(
            mr.ell_data, mr.ell_ids, mr.row_nnz, n, p,
            min(max((256 << 20) // max(4 * p, 1) // 8 * 8, 8), n),
        )
        return cls(hi, None if bool(exact) else lo, m.shape)

    @staticmethod
    def hbm_budget_bytes() -> int:
        """Usable device memory for the densified payload on the default
        device — queried from the runtime, with a conservative fraction
        reserved for sketch/QR workspace and XLA temporaries. The CPU
        reports no limit and gets a fixed 9 GiB."""

        from .. import platform

        limit = platform.device_memory_limit()
        return 9 << 30 if limit is None else int(limit * 0.6)

    @classmethod
    def fits(
        cls, shape, budget_bytes: int | None = None, needs_lo: bool = False
    ) -> bool:
        if budget_bytes is None:
            budget_bytes = cls.hbm_budget_bytes()
        n, p = shape
        bytes_needed = 2 * n * p * (2 if needs_lo else 1)
        return bytes_needed <= budget_bytes

    # fast path: bf16 inputs, f32 accumulation
    def mv(self, B):
        return jax.lax.dot_general(
            self.hi,
            B.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(B.dtype)

    def rmv(self, C):
        return jax.lax.dot_general(
            self.hi,
            C.astype(jnp.bfloat16),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(C.dtype)

    # precise path: both the matrix AND the dense operand are split into
    # bf16 terms (f32-accumulated bf16 passes) — splitting only the
    # matrix is NOT enough: rounding the operand (e.g. the orthonormal Q
    # of the final projection) injects FIRST-order error into the
    # singular values. Term count matters the same way: a 2-term operand
    # split drops a ~2^-17 relative residual, a ~1.5e-5 explained-variance
    # floor on every A-space randomized engine (sigma^2 doubles the
    # relative error). The precise paths use OPERAND_TERMS=3 (~2^-26
    # residual, below the f32 accumulation noise) — one extra pass on
    # the final projection only.
    @staticmethod
    def _split(B):
        # barrier the hi cast: the simplifier may otherwise fold the
        # f32->bf16->f32 round trip to identity, making lo literally
        # zero and silently collapsing the compensated product to
        # single-bf16 accuracy
        hi = jax.lax.optimization_barrier(B.astype(jnp.bfloat16))
        lo = (B - hi.astype(B.dtype)).astype(jnp.bfloat16)
        return hi, lo

    def _precise(self, B, dims):
        b_terms = bf16_terms(B, OPERAND_TERMS)
        parts = [self.hi]
        if self.lo is not None:
            parts.append(self.lo)

        def dot(a, b):
            return jax.lax.dot_general(
                a, b, dimension_numbers=(dims, ((), ())),
                preferred_element_type=jnp.float32,
            )

        out = None
        for a in parts:
            term = sum(dot(a, bt) for bt in b_terms)
            out = term if out is None else out + term
        return out.astype(B.dtype)

    def mv_precise(self, B):
        return self._precise(B, ((1,), (0,)))

    def rmv_precise(self, C):
        return self._precise(C, ((0,), (0,)))

    @jax.jit
    def col_stats(self):
        """(sum, sum_sq) per column — one fused f32 pass over the dense
        array (x = hi + lo reconstructed exactly in f32 before squaring)."""

        x = self.hi.astype(jnp.float32)
        if self.lo is not None:
            x = x + self.lo.astype(jnp.float32)
        return jnp.sum(x, axis=0), jnp.sum(x * x, axis=0)

    def tree_flatten(self):
        if self.lo is None:
            return (self.hi,), (self.shape, False)
        return (self.hi, self.lo), (self.shape, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, has_lo = aux
        if has_lo:
            return cls(children[0], children[1], shape)
        return cls(children[0], None, shape)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TiledSparseOperator:
    """Sparse products by densify-then-contract over row blocks.

    The engine for matrices too large to densify on the device but small
    enough to hold the ~(2-3x nnz) column-tiled ELL payload. A SINGLE
    row-major tiled layout serves both products (``ops.tiled``): ``A @ B``
    densifies a block of rows and contracts it on its column axis
    (``tiled_ell_spmm_t``), ``A^T @ C`` contracts the SAME blocks on their
    row axis (``tiled_ell_rmv_t``) — no second orientation, half the
    memory/transfer/build cost. Rare heavy-row overflow entries live in
    narrow plain-ELL side arrays (one per product direction; the rmv one
    indexes rows by column). Construction is host-side (C++ native
    converter when available).

    Precision scheme (f32 matrices — mirrors :class:`DensifiedOperator`):
    narrow payloads are stored as bf16 ``hi`` (+ bf16 ``lo`` residual
    unless the values are bf16-exact, e.g. raw counts), so the contraction
    runs in native bf16. ``mv``/``rmv`` are COMPENSATED products (payload
    hi+lo against the hi/lo-split operand, stacked on the k axis —
    f32-class accuracy in at most 2 product calls); ``mv_fast``/
    ``rmv_fast`` contract hi only (one bf16 pass — what randomized power
    iterations ride; subspace error enters explained variance at second
    order). The tiny overflow side arrays stay f32 and are added exactly
    either way. Wide f32 payloads contract in f32 at HIGHEST, and f64
    matrices keep a plain f64 payload with exact products.
    """

    tdata: jnp.ndarray  # [nt * wt, Rp]  bf16 hi (f32 path) or f64 values
    tdata_lo: jnp.ndarray | None  # bf16 residual, None when exact/f64
    tlocal: jnp.ndarray
    ov_data: jnp.ndarray  # [Rp, ovw]   overflow rows->global col ids (mv)
    ov_ids: jnp.ndarray
    ovt_data: jnp.ndarray  # [Pp, ovtw] overflow cols->global row ids (rmv)
    ovt_ids: jnp.ndarray
    shape: Tuple[int, int]
    # wt, ntiles, ct, br, ovw, ovtw
    meta: Tuple[int, int, int, int, int, int]

    COL_TILE = 256
    BLOCK_ROWS = 1024

    @classmethod
    def from_matrix(cls, m) -> "TiledSparseOperator":
        from ..sparse import convert as _cv
        from ..sparse.convert import csr_to_tiled_ell_split_numpy

        ct, br = cls.COL_TILE, cls.BLOCK_ROWS
        n, p = m.shape
        src = m._layout_for("row")
        src._require_host_structure()
        td, tl, wt, nt, ovd, ovi, ovw = csr_to_tiled_ell_split_numpy(
            src._h_indptr,
            src._h_indices,
            src._csr_data_host(),
            n,
            p,
            col_tile=ct,
            rows_padded_to=br,
        )
        td, td_lo = cls._split_payload(td, wt)

        # transposed overflow (column-major plain ELL over just the ~1%
        # overflow entries) so rmv needs no scatter; padding slots in the
        # [Rp, ovw] arrays carry v=0 and contribute nothing either way
        if ovw > 0:
            r_idx, w_idx = np.nonzero(ovd)
            t_indptr, t_indices, t_vals = _coo_to_csr_arrays(
                ovi[r_idx, w_idx], r_idx, ovd[r_idx, w_idx], p, n
            )
            otd, oti, _ = _cv.csr_to_ell_numpy(t_indptr, t_indices, t_vals, p)
            ovtw = otd.shape[1]
        else:
            pp = _cv.pad_rows(p)
            otd = np.zeros((pp, 0), np.asarray(ovd).dtype)
            oti = np.zeros((pp, 0), np.int32)
            ovtw = 0

        return cls(
            jnp.asarray(td),
            None if td_lo is None else jnp.asarray(td_lo),
            jnp.asarray(tl),
            jnp.asarray(ovd),
            jnp.asarray(ovi),
            jnp.asarray(otd),
            jnp.asarray(oti),
            (n, p),
            (wt, nt, ct, br, ovw, ovtw),
        )

    # bf16 pays only while the contraction dominates the densify: the
    # densify cost grows linearly in wt while the dot does not, so the
    # split is gated on wt. The crossover was set on a 16 GB accelerator
    # and is untuned on the GPU.
    BF16_WT_MAX = 16

    @classmethod
    def _split_payload(cls, td, wt):
        """f32 payload -> (bf16 hi, bf16 lo | None) when the tile width is
        small enough for bf16 to pay (see ``BF16_WT_MAX``); other dtypes /
        wide payloads pass through unsplit (f64 runs exact)."""

        if td.dtype != np.float32 or wt > cls.BF16_WT_MAX:
            return td, None
        import ml_dtypes

        hi = td.astype(ml_dtypes.bfloat16)
        lo = td - hi.astype(np.float32)
        if not np.any(lo):
            return hi, None
        return hi, lo.astype(ml_dtypes.bfloat16)

    # -- capacity planning (the 'auto' engine selector's input) ---------

    @classmethod
    def payload_bytes(cls, m) -> int:
        """Exact device-payload size of the tiled layout for ``m`` (two
        O(nnz) host passes over the structure; values assumed f32)."""

        from ..sparse import convert as _cv
        from ..sparse.convert import tiled_split_widths

        src = m._layout_for("row")
        src._require_host_structure()
        n, p = m.shape
        wt, ntiles, ovw, n_over = tiled_split_widths(
            src._h_indptr, src._h_indices, n, p, col_tile=cls.COL_TILE
        )
        rp = max(-(-n // cls.BLOCK_ROWS), 1) * cls.BLOCK_ROWS
        main = ntiles * wt * rp * 8  # f32 values + int32 ids
        over = rp * ovw * 8
        if ovw:
            # the rmv-side transposed overflow has its OWN width (max
            # per-column overflow count) — ovw (per-row) can be far off
            # in either direction
            ovtw = _cv.tiled_overflow_col_width(
                src._h_indptr, src._h_indices, n, p, cls.COL_TILE, wt
            )
            over += _cv.pad_rows(p) * _cv.round_up(max(ovtw, 1), 8) * 8
        return main + over

    @classmethod
    def fits(cls, m, budget_bytes: int | None = None) -> bool:
        if budget_bytes is None:
            budget_bytes = DensifiedOperator.hbm_budget_bytes()
        return cls.payload_bytes(m) <= budget_bytes

    # -- products --------------------------------------------------------

    def _pad_cols(self, M, width):
        """[r, k] -> transposed [kp, width] (kp = k rounded up to a multiple
        of 8)."""

        k = M.shape[1]
        kp = max(-(-k // 8) * 8, 8)
        Mt = jnp.zeros((kp, width), M.dtype)
        return jax.lax.dynamic_update_slice(Mt, M.T.astype(Mt.dtype), (0, 0)), kp

    @property
    def _bf16(self) -> bool:
        return self.tdata.dtype == jnp.bfloat16

    def _mv_kernel(self, payload, Bt):
        wt, nt, ct, _, _, _ = self.meta
        return tiled_ell_spmm_t(
            payload, self.tlocal, Bt, wt=wt, ntiles=nt, col_tile=ct,
        )

    def _rmv_kernel(self, payload, Ct):
        wt, nt, ct, _, _, _ = self.meta
        return tiled_ell_rmv_t(
            payload, self.tlocal, Ct, wt=wt, ntiles=nt, col_tile=ct,
        )

    @staticmethod
    def _stack_split(M, width, transpose=True):
        """Split ``M`` [r, k] into :data:`OPERAND_TERMS` bf16 terms stacked
        on the k axis as one [terms*kp, width] operand — every term rides
        the SAME product call (the contraction's cost is linear in kp, so
        this is exactly the multi-pass compensated contraction with none
        of the densify work repeated). Shared by the single-device operator and
        :class:`ShardedTiled`."""

        k = M.shape[1]
        kp = max(-(-k // 8) * 8, 8)
        terms = bf16_terms(M, OPERAND_TERMS)
        Mt = jnp.zeros((OPERAND_TERMS * kp, width), jnp.bfloat16)
        for i, t in enumerate(terms):
            Mt = jax.lax.dynamic_update_slice(
                Mt, t.T if transpose else t, (i * kp, 0)
            )
        return Mt, kp

    @staticmethod
    def _unstack_sum(out, kp, k, axis=0):
        """Sum the :data:`OPERAND_TERMS` stacked result slices back."""

        sl = (
            (lambda i: out[i * kp : i * kp + k])
            if axis == 0
            else (lambda i: out[:, i * kp : i * kp + k])
        )
        acc = sl(0)
        for i in range(1, OPERAND_TERMS):
            acc = acc + sl(i)
        return acc

    def mv(self, B):
        """A @ B at f32-class accuracy (compensated bf16 on f32 payloads)."""

        wt, nt, ct, br, ovw, _ = self.meta
        n = self.shape[0]
        k = B.shape[1]
        if not self._bf16:
            Bt, _ = self._pad_cols(B, nt * ct)
            result = self._mv_kernel(self.tdata, Bt)[:k, :n].T
        else:
            Bt, kp = self._stack_split(B, nt * ct, transpose=True)
            out = self._mv_kernel(self.tdata, Bt)
            acc = self._unstack_sum(out, kp, k, axis=0)
            if self.tdata_lo is not None:
                out_lo = self._mv_kernel(self.tdata_lo, Bt)
                acc = acc + self._unstack_sum(out_lo, kp, k, axis=0)
            result = acc[:, :n].T
        if ovw > 0:  # static: baked into the jitted graph at trace time
            result = result + ell_spmm(self.ov_data, self.ov_ids, B)[:n]
        return result.astype(B.dtype)

    def mv_fast(self, B):
        """A @ B with the hi payload only — one bf16 pass (what the
        randomized power iterations ride; cf. ``DensifiedOperator.mv``)."""

        if not self._bf16:
            return self.mv(B)
        wt, nt, ct, br, ovw, _ = self.meta
        n = self.shape[0]
        k = B.shape[1]
        kp = max(-(-k // 8) * 8, 8)
        Bt = jnp.zeros((kp, nt * ct), jnp.bfloat16)
        Bt = jax.lax.dynamic_update_slice(
            Bt, B.T.astype(jnp.bfloat16), (0, 0)
        )
        result = self._mv_kernel(self.tdata, Bt)[:k, :n].T
        if ovw > 0:
            result = result + ell_spmm(self.ov_data, self.ov_ids, B)[:n]
        return result.astype(B.dtype)

    def rmv(self, C):
        """A^T @ C at f32-class accuracy."""

        wt, nt, ct, br, _, ovtw = self.meta
        n, p = self.shape
        k = C.shape[1]
        R = self.tdata.shape[1]
        if not self._bf16:
            Ct, _ = self._pad_cols(C, R)
            result = self._rmv_kernel(self.tdata, Ct)[:p, :k]
        else:
            Cp = jnp.zeros((R, k), C.dtype)
            Cp = jax.lax.dynamic_update_slice(Cp, C, (0, 0))
            Ct, kp = self._stack_split(Cp, R, transpose=True)
            out = self._rmv_kernel(self.tdata, Ct)
            acc = self._unstack_sum(out, kp, k, axis=1)
            if self.tdata_lo is not None:
                out_lo = self._rmv_kernel(self.tdata_lo, Ct)
                acc = acc + self._unstack_sum(out_lo, kp, k, axis=1)
            result = acc[:p]
        if ovtw > 0:
            result = result + ell_spmm(self.ovt_data, self.ovt_ids, C)[:p]
        return result.astype(C.dtype)

    def rmv_fast(self, C):
        """A^T @ C with the hi payload only — one bf16 pass."""

        if not self._bf16:
            return self.rmv(C)
        wt, nt, ct, br, _, ovtw = self.meta
        p = self.shape[1]
        k = C.shape[1]
        R = self.tdata.shape[1]
        kp = max(-(-k // 8) * 8, 8)
        Ct = jnp.zeros((kp, R), jnp.bfloat16)
        Ct = jax.lax.dynamic_update_slice(
            Ct, C.T.astype(jnp.bfloat16), (0, 0)
        )
        result = self._rmv_kernel(self.tdata, Ct)[:p, :k]
        if ovtw > 0:
            result = result + ell_spmm(self.ovt_data, self.ovt_ids, C)[:p]
        return result.astype(C.dtype)

    def tree_flatten(self):
        children = [
            self.tdata,
            self.tlocal,
            self.ov_data,
            self.ov_ids,
            self.ovt_data,
            self.ovt_ids,
        ]
        if self.tdata_lo is not None:
            children.append(self.tdata_lo)
        return tuple(children), (self.shape, self.meta, self.tdata_lo is not None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, meta, has_lo = aux
        lo = children[6] if has_lo else None
        return cls(children[0], lo, *children[1:6], shape, meta)


def _coo_to_csr_arrays(rows, cols, vals, n, p):
    """COO triplets -> (indptr, indices, data) CSR arrays (host numpy)."""

    import scipy.sparse as sp

    csr = sp.coo_matrix((vals, (rows, cols)), shape=(n, p)).tocsr()
    csr.sort_indices()
    return (
        csr.indptr.astype(np.int64),
        csr.indices.astype(np.int32),
        csr.data,
    )
