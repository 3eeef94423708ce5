"""``SparseMatrix`` — the device-resident sparse container and its operation surface.

Rebuilds the reference's L0/L1/L2 stack (nalgebra-sparse ``CsrMatrix``/
``CscMatrix`` + the seven operation traits of ``src/sparse/mod.rs:35-220`` +
the ``Normalize``/``Log1P`` preprocessing traits of ``src/utils/mod.rs:6-17``)
as ONE class:

* Device-resident data is a blocked **padded-ELL** grid (``ell_data``,
  ``ell_ids``, ``row_nnz``) along the matrix's *major* axis — rows for CSR,
  columns for CSC. Every major-axis statistic is a fused masked reduction;
  every minor-axis statistic is the same reduction over the lazily built,
  host-cached transpose. SpMM gathers the dense operand through ``ell_ids``.
* Host-side CSR structure (numpy ``indptr``/``indices``) is kept for O(nnz)
  format conversion, scipy round-trips, and building the transpose — the role
  the reference delegates to nalgebra-sparse.

The class is a JAX pytree (ELL arrays are children), so instances pass
through ``jit``/``shard_map`` untouched; methods that need host work
(``transpose``, conversions) must be called eagerly, which is how the
higher layers (PCA, preprocessing pipelines) are orchestrated.

Divergences from the reference (each deliberate, none copied):

* ``normalize``/``log1p`` return a **new** matrix instead of mutating —
  JAX arrays are immutable; the semantics (zero-sum lines untouched,
  reference ``csr.rs:1021-1030``) are preserved exactly.
* ``sum_row_squared`` returns ``nrows`` values (the reference sizes it by
  ``ncols``, ``csr.rs:614`` — a defect we do not copy).
* ``var_row`` normalizes by the length of the reduced axis (the reference
  divides row variances by ``nrows``, ``csr.rs:689-691``).
* ``*_chunk`` methods are functional: they take the accumulator and return
  the updated value.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import stats as _st
from ..ops.spmm import ell_spmm
from ..types import Direction, canonical_float_dtype
from . import convert as _cv

__all__ = ["SparseMatrix", "csr_matrix", "csc_matrix", "random_sparse"]

from functools import partial as _partial


@_partial(jax.jit, static_argnames=("fn", "is_csr"))
def _stored_map_graph(ell_data, ell_ids, row_nnz, operands, *, fn, is_csr):
    """One fused dispatch for ``SparseMatrix.map_stored``: index
    synthesis, the user map, and the padded-slot re-zeroing compile into
    a single executable (``fn`` is a static jit key — module-level fns
    hit the trace cache, per-call lambdas retrace)."""

    iota = jax.lax.broadcasted_iota(jnp.int32, ell_ids.shape, 0)
    rank = jax.lax.broadcasted_iota(jnp.int32, ell_ids.shape, 1)
    valid = rank < row_nnz[:, None]
    r, c = (iota, ell_ids) if is_csr else (ell_ids, iota)
    return jnp.where(
        valid, fn(ell_data, r, c, *operands), jnp.zeros_like(ell_data)
    )


@_partial(jax.jit, static_argnames=("by_major",))
def _scale_stored_graph(ell_data, ell_ids, row_nnz, sums, target, *, by_major):
    """Fused line-scaling over one ELL payload (the ``normalize`` core).

    ``by_major=True`` is the hot case (direction == the layout's major
    axis): the factor is a [n_major, 1] BROADCAST. Routing this through
    the generic ``map_stored`` machinery instead costs a payload-sized
    ``take(sums, iota_rows)`` — a real payload-sized gather where the
    broadcast multiply is a plain memory-bound pass. ``by_major=False`` (minor-axis
    scaling: the transpose twin, or col-direction on a CSR layout)
    gathers the [n_minor] factor by the stored ids — a table gather,
    unavoidable for ELL."""

    factor = jnp.where(sums > 0, target / sums, jnp.zeros_like(sums))
    if by_major:
        # payload rows are padded to a multiple of 8 past the logical major count;
        # padded rows have row_nnz == 0 and are re-zeroed below
        f = jnp.pad(factor, (0, ell_data.shape[0] - factor.shape[0]))[:, None]
    else:
        f = jnp.take(factor, ell_ids, axis=0, mode="clip")
    new = jnp.where(f > 0, ell_data * f, ell_data)
    rank = jax.lax.broadcasted_iota(jnp.int32, ell_ids.shape, 1)
    valid = rank < row_nnz[:, None]
    return jnp.where(valid, new, jnp.zeros_like(ell_data))


_WARNED_MAP_FNS: set = set()


def _warn_if_percall_fn(fn) -> None:
    """One-time (per code object) warning for per-call lambdas/local fns
    passed to ``map_stored``: ``fn`` is a STATIC jit key, so every fresh
    function object creates a new ``_stored_map_graph`` cache entry that
    embeds any closed-over device arrays as compiled constants — an
    unbounded compile-cache/memory leak in long-running services.
    Module-level fns with data via ``*operands`` hit the
    trace cache instead."""

    code = getattr(fn, "__code__", None)
    if code is None or code in _WARNED_MAP_FNS:
        return
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", ""))
    if "<lambda>" in name or "<locals>" in name:
        _WARNED_MAP_FNS.add(code)
        import warnings

        warnings.warn(
            "map_stored received a lambda/locally-defined fn "
            f"({name!r}); each fresh function object retraces and "
            "permanently caches a new compiled graph (closed-over "
            "arrays become embedded constants). Pass a module-level "
            "function and thread data through *operands for cache "
            "hits.",
            stacklevel=3,
        )


def _log1p_fn(v, r, c):
    # precise_math: this XLA build's f32 log1p is a ~4000-ULP fast
    # approximation (2e-5 value-parity error vs the reference's libm
    # ln_1p, csr.rs:1070-1079)
    from ..ops.precise_math import log1p as _plog1p

    return _plog1p(v)


def _expm1_fn(v, r, c):
    from ..ops.precise_math import expm1 as _pexpm1

    return _pexpm1(v)


class SparseMatrix:
    """Sparse matrix in padded-ELL layout (CSR- or CSC-major)."""

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def __init__(
        self,
        ell_data: jnp.ndarray,
        ell_ids: jnp.ndarray,
        row_nnz: jnp.ndarray,
        shape: Tuple[int, int],
        nnz: int,
        fmt: str = "csr",
        h_indptr: Optional[np.ndarray] = None,
        h_indices: Optional[np.ndarray] = None,
        h_data: Optional[np.ndarray] = None,
    ):
        if fmt not in ("csr", "csc"):
            raise ValueError(f"format must be 'csr' or 'csc', got {fmt!r}")
        self.ell_data = ell_data
        self.ell_ids = ell_ids
        self.row_nnz = row_nnz
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self.format = fmt
        # host-side structure (major-axis CSR of the stored layout); keeping
        # the VALUES on host too means transpose/scipy round-trips never pull
        # device buffers back to the host
        self._h_indptr = h_indptr
        self._h_indices = h_indices
        self._h_data = h_data
        self._transpose_cache: Optional["SparseMatrix"] = None
        self._operator_cache: dict = {}  # engine name -> operator

    # -- pytree protocol ------------------------------------------------

    def tree_flatten(self):
        children = (self.ell_data, self.ell_ids, self.row_nnz)
        aux = (self.shape, self.nnz, self.format)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, nnz, fmt = aux
        obj = cls.__new__(cls)
        obj.ell_data, obj.ell_ids, obj.row_nnz = children
        obj.shape, obj.nnz, obj.format = tuple(shape), nnz, fmt
        obj._h_indptr = None
        obj._h_indices = None
        obj._h_data = None
        obj._transpose_cache = None
        obj._operator_cache = {}
        return obj

    # -- factory methods -------------------------------------------------

    @classmethod
    def from_scipy(
        cls,
        mat,
        fmt: Optional[str] = None,
        dtype=None,
        device: bool = True,
    ) -> "SparseMatrix":
        """Build from any scipy.sparse matrix.

        ``fmt`` selects the major layout ('csr' default; 'csc' stores the
        transpose-major layout like the reference's CscMatrix).
        ``device=False`` keeps the ELL arrays host-side (numpy) — useful
        when a densified engine will consume the matrix and the sparse
        layouts would only waste host-to-device transfers; any op that
        needs them transfers lazily.
        """

        import scipy.sparse as sp

        if fmt is None:
            fmt = "csc" if sp.issparse(mat) and mat.format == "csc" else "csr"
        if dtype is not None:
            dt = canonical_float_dtype(dtype)
        elif np.issubdtype(mat.dtype, np.floating):
            if mat.dtype == np.float64 and not jax.config.read("jax_enable_x64"):
                dt = np.dtype(np.float32)  # silent downcast absent x64 mode
            else:
                dt = canonical_float_dtype(mat.dtype)
        else:
            dt = np.dtype(np.float32)

        if fmt == "csr":
            m = mat.tocsr()
            m.sort_indices()
            major, shape = m, (m.shape[0], m.shape[1])
            n_major = shape[0]
        else:
            m = mat.tocsc()
            m.sort_indices()
            shape = (m.shape[0], m.shape[1])
            # CSC arrays are a CSR description of the transpose
            major = m
            n_major = shape[1]

        indptr = major.indptr.astype(np.int64)
        indices = major.indices.astype(np.int32)
        data = major.data.astype(dt)
        ell_data, ell_ids, row_nnz = _cv.csr_to_ell_numpy(
            indptr, indices, data, n_major
        )
        put = jnp.asarray if device else (lambda a: a)
        return cls(
            put(ell_data),
            put(ell_ids),
            put(row_nnz),
            shape,
            int(len(indices)),
            fmt,
            h_indptr=indptr,
            h_indices=indices,
            h_data=data,
        )

    @classmethod
    def from_dense(cls, arr, fmt: str = "csr", dtype=None) -> "SparseMatrix":
        import scipy.sparse as sp

        arr = np.asarray(arr)
        mat = sp.csr_matrix(arr) if fmt == "csr" else sp.csc_matrix(arr)
        # dtype=None falls through to from_scipy's policy (silent f64
        # downcast absent x64 mode, int -> f32), matching from_scipy inputs
        return cls.from_scipy(mat, fmt=fmt, dtype=dtype)

    @classmethod
    def from_coo(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: Tuple[int, int],
        fmt: str = "csr",
        dtype=None,
    ) -> "SparseMatrix":
        import scipy.sparse as sp

        coo = sp.coo_matrix((vals, (rows, cols)), shape=shape)
        return cls.from_scipy(coo, fmt=fmt, dtype=dtype)

    # ------------------------------------------------------------------
    # basic properties / conversion
    # ------------------------------------------------------------------

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.ell_data.dtype

    @property
    def n_major(self) -> int:
        """Logical length of the major (stored) axis."""

        return self.shape[0] if self.format == "csr" else self.shape[1]

    @property
    def n_minor(self) -> int:
        return self.shape[1] if self.format == "csr" else self.shape[0]

    @property
    def ell_width(self) -> int:
        return self.ell_data.shape[1]

    def _require_host_structure(self):
        if self._h_indptr is None or self._h_indices is None:
            # reconstruct from ELL (device pull) — happens only for matrices
            # produced inside jit-free elementwise ops where we dropped it
            row_nnz = np.asarray(self.row_nnz)[: self.n_major]
            indptr = np.zeros(self.n_major + 1, dtype=np.int64)
            np.cumsum(row_nnz, out=indptr[1:])
            ids = np.asarray(self.ell_ids)
            mask = (
                np.arange(ids.shape[1])[None, :]
                < np.asarray(self.row_nnz)[:, None]
            )
            self._h_indices = ids[mask].astype(np.int32)[: int(indptr[-1])]
            self._h_indptr = indptr

    def _csr_data_host(self) -> np.ndarray:
        """Stored values in major-CSR order (host numpy, no device pull
        when the construction-time host copy is still valid)."""

        self._require_host_structure()
        if self._h_data is not None:
            return self._h_data
        d = np.asarray(self.ell_data)
        mask = (
            np.arange(d.shape[1])[None, :]
            < np.asarray(self.row_nnz)[:, None]
        )
        return d[mask]

    def values_bf16_exact(self) -> bool:
        """True when every stored value survives f32 -> bf16 round-tripping
        (raw counts always do) — decides whether the bf16 fast engines are
        lossless. One native early-exit pass, cached per matrix."""

        cached = getattr(self, "_bf16_exact_cache", None)
        if cached is not None:
            return cached
        if self._h_data is None:
            # values live only on device (post value-map): one jitted
            # reduction — _csr_data_host() here would pull the payload
            # through the host link (padding slots are zero, bf16-exact)
            out = bool(_bf16_exact_device(self.ell_data))
            self._bf16_exact_cache = out
            return out
        v = np.ascontiguousarray(self._csr_data_host(), np.float32)
        from ..native import build as _native

        lib = _native.get_lib()
        if lib is not None:
            out = bool(lib.f32_bf16_exact(v, len(v)))
        else:
            import ml_dtypes

            out = not np.any(
                v - v.astype(ml_dtypes.bfloat16).astype(np.float32)
            )
        self._bf16_exact_cache = out
        return out

    def values_int8_exact(self) -> bool:
        """True when every stored value is an integer in ``[-127, 127]`` —
        the gate for the int8 Gram tier (``linalg/gram.py``): int8 x
        int8 -> int32 products are EXACT, so raw-count matrices (the
        dominant scRNA case) get their full-data Gram pass on 1-byte
        slabs with a per-slab-exact accumulation. One pass, cached per
        matrix."""

        cached = getattr(self, "_int8_exact_cache", None)
        if cached is not None:
            return cached
        if self._h_data is None:
            out = bool(_int8_exact_device(self.ell_data))
        else:
            v = self._csr_data_host()
            out = bool(
                np.all(np.abs(v) <= 127) and not np.any(v != np.rint(v))
            )
        self._int8_exact_cache = out
        return out

    def to_scipy(self):
        import scipy.sparse as sp

        self._require_host_structure()
        data = self._csr_data_host()
        if self.format == "csr":
            return sp.csr_matrix(
                (data, self._h_indices, self._h_indptr), shape=self.shape
            )
        return sp.csc_matrix(
            (data, self._h_indices, self._h_indptr), shape=self.shape
        )

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    def _as_selection(self, sel, axis_len: int, what: str) -> np.ndarray:
        sel = np.asarray(sel)
        if sel.dtype == bool:
            if sel.shape[0] != axis_len:
                raise ValueError(
                    f"Mask length ({sel.shape[0]}) does not match number "
                    f"of {what} ({axis_len})"
                )
            return np.where(sel)[0].astype(np.int64)
        sel = sel.astype(np.int64)
        if sel.size and (sel.min() < 0 or sel.max() >= axis_len):
            raise ValueError(f"{what} indices must be in [0, {axis_len})")
        return sel

    def select_rows(self, sel) -> "SparseMatrix":
        """New matrix keeping the given rows (bool mask or index array,
        in the given order). The post-QC filtering op: row extraction is
        one native O(selected nnz) pass on the host CSR structure
        (``extract_rows_csr``), then a fresh device ELL build. When the
        values live only on device (post value-map), the geometry is
        still extracted host-side and the values move with ONE device
        gather — no host-link payload pull.
        """

        rows = self._as_selection(sel, self.nrows, "rows")
        import scipy.sparse as sp

        from .convert import extract_rows_csr

        base = self if self.format == "csr" else self.transpose()
        base._require_host_structure()
        if base._h_data is None:
            out = base._select_major_structural(rows)
            return out if self.format == "csr" else out.transpose()
        indptr, indices, data = extract_rows_csr(
            base._h_indptr, base._h_indices, base._csr_data_host(), rows
        )
        out = sp.csr_matrix(
            (data, indices, indptr), shape=(len(rows), self.ncols)
        )
        if self.format == "csc":
            out = out.tocsc()
        return SparseMatrix.from_scipy(out)

    def select_cols(self, sel) -> "SparseMatrix":
        """New matrix keeping the given columns (bool mask or index
        array, in the given order) — e.g. an HVG mask. Runs the row
        extraction on the transposed (column-major) structure; device-
        resident values move by gather (see :meth:`select_rows`)."""

        cols = self._as_selection(sel, self.ncols, "columns")
        import scipy.sparse as sp

        from .convert import extract_rows_csr

        base = self if self.format == "csc" else self.transpose()
        base._require_host_structure()
        if base._h_data is None:
            out = base._select_major_structural(cols)
            return out if self.format == "csc" else out.transpose()
        indptr, indices, data = extract_rows_csr(
            base._h_indptr, base._h_indices, base._csr_data_host(), cols
        )
        out = sp.csc_matrix(
            (data, indices, indptr), shape=(self.nrows, len(cols))
        )
        if self.format == "csr":
            out = out.tocsr()
        return SparseMatrix.from_scipy(out)

    def _select_major_structural(self, idx: np.ndarray) -> "SparseMatrix":
        """Select along the MAJOR axis of a matrix whose values live only
        on device: the sub-structure and an entry-level gather map into
        the flattened source ELL payload are computed host-side (f64
        'data' = flat slot positions, exact to 2^53), then the values
        move with one device gather — same machinery as
        :meth:`_transpose_structural`."""

        from . import convert as _cv

        W = self.ell_data.shape[1]
        indptr = self._h_indptr
        line_nnz = np.diff(indptr)
        lines = np.repeat(
            np.arange(self.n_major, dtype=np.int64), line_nnz
        )
        j = np.arange(len(self._h_indices), dtype=np.int64)
        pos = (lines * W + (j - indptr[lines])).astype(np.float64)
        s_indptr, s_indices, s_pos = _cv.extract_rows_csr(
            indptr, self._h_indices, pos, idx
        )
        ell_pos, ell_ids, s_nnz = _cv.csr_to_ell_numpy(
            s_indptr, s_indices, s_pos, len(idx)
        )
        tmap = jnp.asarray(ell_pos.astype(np.int64))
        nnz_d = jnp.asarray(s_nnz)
        ell_data = _gather_transpose_values(self.ell_data, tmap, nnz_d)
        shape = (
            (len(idx), self.shape[1])
            if self.format == "csr"
            else (self.shape[0], len(idx))
        )
        return SparseMatrix(
            ell_data,
            jnp.asarray(ell_ids),
            nnz_d,
            shape,
            int(s_indptr[-1]),
            self.format,
            h_indptr=s_indptr,
            h_indices=s_indices,
            h_data=None,
        )

    def transpose(self) -> "SparseMatrix":
        """Matrix with major/minor layouts swapped (cached; host O(nnz)).

        ``m.transpose()`` represents the SAME logical matrix stored along the
        other axis — the device equivalent of the reference's CSR<->CSC pairing.
        """

        if self._transpose_cache is None:
            self._require_host_structure()
            if self._h_data is None:
                other = self._transpose_structural()
            else:
                data = self._csr_data_host()
                t_indptr, t_indices, t_data = _cv.csr_transpose_numpy(
                    self._h_indptr,
                    self._h_indices,
                    data,
                    self.n_major,
                    self.n_minor,
                )
                ell_data, ell_ids, row_nnz = _cv.csr_to_ell_numpy(
                    t_indptr, t_indices, t_data, self.n_minor
                )
                other = SparseMatrix(
                    jnp.asarray(ell_data),
                    jnp.asarray(ell_ids),
                    jnp.asarray(row_nnz),
                    self.shape,
                    self.nnz,
                    "csc" if self.format == "csr" else "csr",
                    h_indptr=t_indptr,
                    h_indices=t_indices,
                    h_data=t_data,
                )
            other._transpose_cache = self
            self._transpose_cache = other
        return self._transpose_cache

    def _transpose_structural(self) -> "SparseMatrix":
        """Transpose a matrix whose values live only on device.

        The host still has the STRUCTURE (indptr/indices survive value
        maps), so the transposed geometry and an entry-level gather map
        into the flattened source payload are computed host-side with the
        same converters the value path uses (f64 'data' = flat source ELL
        slots, exact to 2^53), and the values move with ONE device gather
        — no device->host value pull (the gather is a memory-bound device
        op).
        """

        W = self.ell_data.shape[1]
        indptr = self._h_indptr
        row_nnz = np.diff(indptr)
        rows = np.repeat(
            np.arange(self.n_major, dtype=np.int64), row_nnz
        )
        j = np.arange(len(self._h_indices), dtype=np.int64)
        pos = (rows * W + (j - indptr[rows])).astype(np.float64)
        t_indptr, t_indices, t_pos = _cv.csr_transpose_numpy(
            indptr, self._h_indices, pos, self.n_major, self.n_minor
        )
        ell_pos, ell_ids, t_row_nnz = _cv.csr_to_ell_numpy(
            t_indptr, t_indices, t_pos, self.n_minor
        )
        tmap = jnp.asarray(ell_pos.astype(np.int64))
        t_nnz = jnp.asarray(t_row_nnz)
        ell_data = _gather_transpose_values(
            self.ell_data, tmap, t_nnz
        )
        return SparseMatrix(
            ell_data,
            jnp.asarray(ell_ids),
            t_nnz,
            self.shape,
            self.nnz,
            "csc" if self.format == "csr" else "csr",
            h_indptr=t_indptr,
            h_indices=t_indices,
            h_data=None,
        )

    # ------------------------------------------------------------------
    # internal helpers: map row/col endpoint -> major/minor layout
    # ------------------------------------------------------------------

    def _layout_for(self, axis: str) -> "SparseMatrix":
        """Matrix whose MAJOR axis is ``axis`` ('row' or 'col')."""

        major_axis = "row" if self.format == "csr" else "col"
        return self if axis == major_axis else self.transpose()

    def _n_of(self, axis: str) -> int:
        return self.nrows if axis == "row" else self.ncols

    def _check_mask(self, mask, expected: int, what: str) -> jnp.ndarray:
        mask = np.asarray(mask)
        if mask.shape[0] != expected:
            # strict parity: the reference bails on ANY length mismatch
            # (csr.rs:158-164), longer masks included
            raise ValueError(
                f"Mask length ({mask.shape[0]}) does not match number of "
                f"{what} ({expected})"
            )
        return jnp.asarray(mask.astype(bool))

    def _major_stat(self, axis: str, fn, *extra):
        m = self._layout_for(axis)
        out = fn(m.ell_data, m.ell_ids, m.row_nnz, *extra)
        return out[: self._n_of(axis)]

    # ------------------------------------------------------------------
    # MatrixNonZero (reference src/sparse/mod.rs:35-61)
    # ------------------------------------------------------------------

    def nonzero_row(self, dtype=jnp.int32) -> jnp.ndarray:
        m = self._layout_for("row")
        return m.row_nnz[: self.nrows].astype(dtype)

    def nonzero_col(self, dtype=jnp.int32) -> jnp.ndarray:
        m = self._layout_for("col")
        return m.row_nnz[: self.ncols].astype(dtype)

    def nonzero_row_masked(self, mask, dtype=jnp.int32) -> jnp.ndarray:
        """Per-row stored-entry count over masked-in COLUMNS (csr.rs:185)."""

        mk = self._check_mask(mask, self.ncols, "columns")
        m = self._layout_for("row")
        return _st.count_major_masked(m.ell_ids, m.row_nnz, mk)[
            : self.nrows
        ].astype(dtype)

    def nonzero_col_masked(self, mask, dtype=jnp.int32) -> jnp.ndarray:
        """Per-column stored-entry count over masked-in ROWS (csr.rs:153)."""

        mk = self._check_mask(mask, self.nrows, "rows")
        m = self._layout_for("col")
        return _st.count_major_masked(m.ell_ids, m.row_nnz, mk)[
            : self.ncols
        ].astype(dtype)

    def nonzero_row_chunk(self, acc) -> np.ndarray:
        return _accumulate_chunk(acc, np.asarray(self.nonzero_row()))

    def nonzero_col_chunk(self, acc) -> np.ndarray:
        return _accumulate_chunk(acc, np.asarray(self.nonzero_col()))

    # ------------------------------------------------------------------
    # MatrixSum (reference src/sparse/mod.rs:67-102)
    # ------------------------------------------------------------------

    def sum_row(self, dtype=None) -> jnp.ndarray:
        out = self._major_stat("row", lambda d, i, n: _st.sum_major(d))
        return out.astype(dtype) if dtype else out

    def sum_col(self, dtype=None) -> jnp.ndarray:
        out = self._major_stat("col", lambda d, i, n: _st.sum_major(d))
        return out.astype(dtype) if dtype else out

    def sum_row_squared(self, dtype=None) -> jnp.ndarray:
        out = self._major_stat("row", lambda d, i, n: _st.sum_major_squared(d))
        return out.astype(dtype) if dtype else out

    def sum_col_squared(self, dtype=None) -> jnp.ndarray:
        out = self._major_stat("col", lambda d, i, n: _st.sum_major_squared(d))
        return out.astype(dtype) if dtype else out

    def sum_row_masked(self, mask, dtype=None) -> jnp.ndarray:
        mk = self._check_mask(mask, self.ncols, "columns")
        out = self._major_stat("row", _st.sum_major_masked, mk)
        return out.astype(dtype) if dtype else out

    def sum_col_masked(self, mask, dtype=None) -> jnp.ndarray:
        mk = self._check_mask(mask, self.nrows, "rows")
        out = self._major_stat("col", _st.sum_major_masked, mk)
        return out.astype(dtype) if dtype else out

    def sum_row_chunk(self, acc) -> np.ndarray:
        return _accumulate_chunk(acc, np.asarray(self.sum_row()))

    def sum_col_chunk(self, acc) -> np.ndarray:
        return _accumulate_chunk(acc, np.asarray(self.sum_col()))

    # ------------------------------------------------------------------
    # MatrixVariance (reference src/sparse/mod.rs:108-142)
    # ------------------------------------------------------------------

    def var_col(self, dtype=None) -> jnp.ndarray:
        """Bessel-corrected column variance over ALL rows incl. implicit
        zeros (reference csr.rs:632-678)."""

        s = self.sum_col()
        sq = self.sum_col_squared()
        out = _st.var_bessel_dense(s, sq, self.nrows)
        return out.astype(dtype) if dtype else out

    def var_row(self, dtype=None) -> jnp.ndarray:
        """Bessel-corrected row variance over ALL columns incl. implicit
        zeros. (Divergence: the reference divides by nrows — csr.rs:689 —
        we use the reduced-axis length, ncols.)"""

        s = self.sum_row()
        sq = self.sum_row_squared()
        out = _st.var_bessel_dense(s, sq, self.ncols)
        return out.astype(dtype) if dtype else out

    def var_col_chunk(self, acc=None, dtype=None) -> np.ndarray:
        """Population variance of stored entries per column (overwrites the
        accumulator like the reference, csr.rs:729-765)."""

        out = self._major_stat("col", _st.var_stored_major)
        out = np.asarray(out.astype(dtype) if dtype else out)
        if acc is None:
            return out
        acc = np.asarray(acc)
        if acc.shape[0] != self.ncols:
            raise ValueError(
                f"Reference slice length {acc.shape[0]} does not match "
                f"number of columns {self.ncols}"
            )
        return out.astype(acc.dtype)

    def var_row_chunk(self, acc=None, dtype=None) -> np.ndarray:
        out = self._major_stat("row", _st.var_stored_major)
        out = np.asarray(out.astype(dtype) if dtype else out)
        if acc is None:
            return out
        acc = np.asarray(acc)
        if acc.shape[0] != self.nrows:
            raise ValueError(
                f"Reference slice length {acc.shape[0]} does not match "
                f"number of rows {self.nrows}"
            )
        return out.astype(acc.dtype)

    def var_col_masked(self, mask, dtype=None) -> jnp.ndarray:
        """Population variance of stored entries in masked-in rows
        (csr.rs:816-866)."""

        mk = self._check_mask(mask, self.nrows, "rows")
        out = self._major_stat("col", _st.var_stored_major_masked, mk)
        return out.astype(dtype) if dtype else out

    def var_row_masked(self, mask, dtype=None) -> jnp.ndarray:
        mk = self._check_mask(mask, self.ncols, "columns")
        out = self._major_stat("row", _st.var_stored_major_masked, mk)
        return out.astype(dtype) if dtype else out

    # ------------------------------------------------------------------
    # MatrixMinMax (reference src/sparse/mod.rs:148-166)
    # ------------------------------------------------------------------

    def min_max_row(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        m = self._layout_for("row")
        mins, maxs = _st.min_max_major(m.ell_data, m.ell_ids, m.row_nnz)
        return mins[: self.nrows], maxs[: self.nrows]

    def min_max_col(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        m = self._layout_for("col")
        mins, maxs = _st.min_max_major(m.ell_data, m.ell_ids, m.row_nnz)
        return mins[: self.ncols], maxs[: self.ncols]

    def min_max_row_chunk(self, acc: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        mins, maxs = self.min_max_row()
        return _merge_min_max(acc, np.asarray(mins), np.asarray(maxs))

    def min_max_col_chunk(self, acc: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        mins, maxs = self.min_max_col()
        return _merge_min_max(acc, np.asarray(mins), np.asarray(maxs))

    # ------------------------------------------------------------------
    # Batch group-by stats (reference src/sparse/mod.rs:172-208)
    # ------------------------------------------------------------------

    def _batch_codes(self, batches: Sequence, expected: int, what: str):
        if len(batches) != expected:
            raise ValueError(
                f"Batch vector length ({len(batches)}) doesn't match matrix "
                f"{what} count ({expected})"
            )
        labels = list(dict.fromkeys(batches))  # stable unique
        code_of = {b: i for i, b in enumerate(labels)}
        codes = np.fromiter(
            (code_of[b] for b in batches), dtype=np.int32, count=len(batches)
        )
        return labels, codes

    def _batch_spmm(self, axis: str, codes: np.ndarray, transform: str):
        """[axis-length, n_batches] of per-batch sums via one SpMM pass.

        Group-by statistics are SpMM against one-hot batch indicators — the
        Device-native replacement for the reference's per-batch HashMap loops
        (csr.rs:1081-1345).
        """

        m = self._layout_for(axis)
        nb = int(codes.max()) + 1 if len(codes) else 1
        # m.ell_data.dtype reads metadata only — never pull the device
        # buffer to the host just for its dtype
        onehot = jnp.asarray(np.eye(nb, dtype=np.dtype(m.ell_data.dtype))[codes])
        if transform == "sum":
            data = m.ell_data
        elif transform == "sumsq":
            data = m.ell_data * m.ell_data
        elif transform == "count":
            data = _st.valid_mask(m.ell_ids, m.row_nnz).astype(m.ell_data.dtype)
        else:  # pragma: no cover
            raise ValueError(transform)
        out = ell_spmm(data, m.ell_ids, onehot)
        return out[: self._n_of(axis)]

    def mean_batch_row(self, batches: Sequence) -> Dict:
        """Per-row means within COLUMN batches, zeros included in the
        denominator (reference csr.rs:1205-1249: batches.len == ncols,
        mean = batch sum / batch column count)."""

        labels, codes = self._batch_codes(batches, self.ncols, "column")
        sums = np.asarray(self._batch_spmm("row", codes, "sum"))
        sizes = np.bincount(codes, minlength=len(labels)).astype(sums.dtype)
        means = sums / sizes[None, :]
        return {b: jnp.asarray(means[:, i]) for i, b in enumerate(labels)}

    def mean_batch_col(self, batches: Sequence) -> Dict:
        """Per-column means within ROW batches (csr.rs:1252-1297)."""

        labels, codes = self._batch_codes(batches, self.nrows, "row")
        sums = np.asarray(self._batch_spmm("col", codes, "sum"))
        sizes = np.bincount(codes, minlength=len(labels)).astype(sums.dtype)
        means = sums / sizes[None, :]
        return {b: jnp.asarray(means[:, i]) for i, b in enumerate(labels)}

    def var_batch_row(self, batches: Sequence) -> Dict:
        """Per-column variance of stored entries within ROW batches,
        ``(sumsq - sum^2/count)/(count - 1)``, 0 when count <= 1
        (reference csr.rs:1087-1161)."""

        labels, codes = self._batch_codes(batches, self.nrows, "row")
        return self._batch_var(labels, codes, axis="col")

    def var_batch_col(self, batches: Sequence) -> Dict:
        """Per-row variance of stored entries within COLUMN batches
        (reference csr.rs:1163-1203)."""

        labels, codes = self._batch_codes(batches, self.ncols, "column")
        return self._batch_var(labels, codes, axis="row")

    def _batch_var(self, labels, codes, axis: str) -> Dict:
        sums = np.asarray(self._batch_spmm(axis, codes, "sum"))
        sumsq = np.asarray(self._batch_spmm(axis, codes, "sumsq"))
        counts = np.asarray(self._batch_spmm(axis, codes, "count"))
        safe = np.maximum(counts, 1.0)
        ss = sumsq - sums * sums / safe
        var = np.where(counts > 1, ss / np.maximum(counts - 1, 1), 0.0)
        return {b: jnp.asarray(var[:, i]) for i, b in enumerate(labels)}

    # ------------------------------------------------------------------
    # MatrixNTop (reference src/sparse/mod.rs:214-220)
    # ------------------------------------------------------------------

    def sum_row_n_top(self, n: int, dtype=None) -> jnp.ndarray:
        out = self._major_stat("row", _st.sum_major_n_top, n)
        return out.astype(dtype) if dtype else out

    # ------------------------------------------------------------------
    # Normalize / Log1P (reference src/utils/mod.rs:6-17, csr.rs:1013-1079)
    # ------------------------------------------------------------------

    def normalize(self, sums, target, direction: Direction) -> "SparseMatrix":
        """Scale rows/columns so each sums to ``target``.

        Zero-or-negative-sum lines are left untouched (reference guard
        ``if sum > 0 { scale } else { 0 }`` then ``if scale > 0``,
        csr.rs:1021-1030, 1041).  Returns a new matrix.
        """

        sums = jnp.asarray(sums, dtype=self.dtype)
        axis = "row" if direction == Direction.ROW else "col"
        n_axis = self._n_of(axis)
        if sums.shape[0] != n_axis:
            raise ValueError(
                f"Length of sums ({sums.shape[0]}) does not match number of "
                f"{axis}s ({n_axis})"
            )
        # scale synthesis lives INSIDE the fused graph (no eager
        # where/divide dispatches); passing device-resident sums makes
        # the whole call transfer-free.
        # Each resident layout gets the specialized scaling graph
        # (broadcast on the matching-major layout, id-gather on the
        # other) — same twin-linking contract as map_stored.
        target = jnp.asarray(target, self.dtype)

        def apply(m):
            major_is_dir = ("row" if m.format == "csr" else "col") == axis
            return _scale_stored_graph(
                m.ell_data, m.ell_ids, m.row_nnz, sums, target,
                by_major=major_is_dir,
            )

        out = self._with_data(apply(self))
        tc = self._transpose_cache
        if tc is not None:
            twin = SparseMatrix(
                apply(tc),
                tc.ell_ids,
                tc.row_nnz,
                tc.shape,
                tc.nnz,
                tc.format,
                h_indptr=tc._h_indptr,
                h_indices=tc._h_indices,
                h_data=None,
            )
            twin._transpose_cache = out
            out._transpose_cache = twin
        return out

    def log1p_normalize(self) -> "SparseMatrix":
        """ln(1 + v) on stored values; implicit zeros stay zero
        (reference csr.rs:1070-1079)."""

        return self.map_stored(_log1p_fn)

    def _with_data(self, new_ell_data: jnp.ndarray) -> "SparseMatrix":
        out = SparseMatrix(
            new_ell_data,
            self.ell_ids,
            self.row_nnz,
            self.shape,
            self.nnz,
            self.format,
            h_indptr=self._h_indptr,
            h_indices=self._h_indices,
            h_data=None,  # values changed on device; host copy is stale
        )
        return out

    def map_stored(self, fn, *operands) -> "SparseMatrix":
        """Elementwise map over stored entries, preserving BOTH layouts.

        ``fn(values, row_ids, col_ids, *operands) -> values`` runs on
        device over the ELL payload (padded slots are masked back to
        zero) as ONE jitted dispatch per resident layout — running the
        index/mask machinery eagerly costs ~8 dispatched primitives per
        map. ``fn`` is a STATIC jit key: pass a stable module-level
        function (with data via ``*operands``, which are traced) for
        compile-cache hits; a per-call lambda works but retraces every
        call. Elementwise maps commute with transposition, so when the
        transpose layout is already cached the same map is applied to
        its payload directly and the two results are linked as transpose
        twins — no host rebuild, no host round-trip. (``_with_data``
        alone drops the transpose cache, which made every ``expm1``/
        ``log1p``/``normalize`` followed by a minor-axis stat pay a full
        host transpose + re-transfer.)
        """

        operands = tuple(jnp.asarray(o) for o in operands)
        _warn_if_percall_fn(fn)

        def apply(m):
            return _stored_map_graph(
                m.ell_data, m.ell_ids, m.row_nnz, operands,
                fn=fn, is_csr=(m.format == "csr"),
            )

        out = self._with_data(apply(self))
        tc = self._transpose_cache
        if tc is not None:
            twin = SparseMatrix(
                apply(tc),
                tc.ell_ids,
                tc.row_nnz,
                tc.shape,
                tc.nnz,
                tc.format,
                h_indptr=tc._h_indptr,
                h_indices=tc._h_indices,
                h_data=None,
            )
            twin._transpose_cache = out
            out._transpose_cache = twin
        return out

    # ------------------------------------------------------------------
    # products
    # ------------------------------------------------------------------

    def matmul_dense(self, B: jnp.ndarray) -> jnp.ndarray:
        """``self @ B`` for dense ``B [ncols, k]`` -> ``[nrows, k]``."""

        B = jnp.asarray(B)
        m = self._layout_for("row")
        return ell_spmm(m.ell_data, m.ell_ids, B)[: self.nrows]

    def rmatmul_dense(self, C: jnp.ndarray) -> jnp.ndarray:
        """``self.T @ C`` for dense ``C [nrows, k]`` -> ``[ncols, k]``."""

        C = jnp.asarray(C)
        m = self._layout_for("col")
        return ell_spmm(m.ell_data, m.ell_ids, C)[: self.ncols]

    def __matmul__(self, B):
        return self.matmul_dense(B)

    def __repr__(self):
        return (
            f"SparseMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"format={self.format!r}, dtype={self.dtype}, "
            f"ell_width={self.ell_width})"
        )


jax.tree_util.register_pytree_node(
    SparseMatrix,
    lambda m: m.tree_flatten(),
    SparseMatrix.tree_unflatten,
)


# ---------------------------------------------------------------------------
# chunk helpers (functional versions of the reference's in-place streams)
# ---------------------------------------------------------------------------


@jax.jit
def _bf16_exact_device(ell_data):
    """True when every stored value survives f32 -> bf16 round-tripping,
    computed on device (the barrier stops XLA folding the round trip)."""

    hi = jax.lax.optimization_barrier(ell_data.astype(jnp.bfloat16))
    return jnp.all(hi.astype(ell_data.dtype) == ell_data)


@jax.jit
def _int8_exact_device(ell_data):
    """True when every stored value is an integer in [-127, 127] (padding
    slots are zero, int8-exact), computed on device."""

    return jnp.all(
        (jnp.abs(ell_data) <= 127) & (ell_data == jnp.round(ell_data))
    )


@jax.jit
def _gather_transpose_values(ell_data, tmap, t_row_nnz):
    """Materialize a transposed ELL payload by gathering the flattened
    source payload; padded slots (tmap 0) are masked back to zero."""

    rank = jax.lax.broadcasted_iota(jnp.int32, tmap.shape, 1)
    valid = rank < t_row_nnz[:, None]
    vals = jnp.take(ell_data.reshape(-1), tmap, axis=0, mode="clip")
    return jnp.where(valid, vals, jnp.zeros_like(vals))


def _accumulate_chunk(acc, stat: np.ndarray) -> np.ndarray:
    """acc + stat over the overlapping prefix (reference skips out-of-range
    indices, csr.rs:126-130)."""

    acc = np.array(acc, copy=True)
    k = min(acc.shape[0], stat.shape[0])
    acc[:k] = acc[:k] + stat[:k].astype(acc.dtype)
    return acc


def _merge_min_max(acc, mins: np.ndarray, maxs: np.ndarray):
    amin = np.array(acc[0], copy=True)
    amax = np.array(acc[1], copy=True)
    k = min(amin.shape[0], mins.shape[0])
    amin[:k] = np.minimum(amin[:k], mins[:k].astype(amin.dtype))
    amax[:k] = np.maximum(amax[:k], maxs[:k].astype(amax.dtype))
    return amin, amax


# ---------------------------------------------------------------------------
# convenience constructors
# ---------------------------------------------------------------------------


def csr_matrix(mat, dtype=None) -> SparseMatrix:
    """Reference ``CsrMatrix`` equivalent (row-major storage)."""

    return SparseMatrix.from_scipy(mat, fmt="csr", dtype=dtype)


def csc_matrix(mat, dtype=None) -> SparseMatrix:
    """Reference ``CscMatrix`` equivalent (column-major storage)."""

    return SparseMatrix.from_scipy(mat, fmt="csc", dtype=dtype)


def random_sparse(
    n_rows: int,
    n_cols: int,
    density: float,
    seed: int = 42,
    fmt: str = "csr",
    dtype=np.float32,
    rng_format: str = "uniform",
) -> SparseMatrix:
    """Seeded synthetic matrix mirroring the reference benches' generator
    (uniform values in [0, 1), benches/csr_matrix_benchmark.rs:18-35)."""

    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    mat = sp.random(
        n_rows,
        n_cols,
        density=density,
        format=fmt,
        dtype=np.float64,
        random_state=rng,
        data_rvs=(rng.standard_normal if rng_format == "normal" else rng.random),
    )
    return SparseMatrix.from_scipy(mat, fmt=fmt, dtype=dtype)
