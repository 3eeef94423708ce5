"""Host-side sparse format conversion: CSR/CSC/COO -> blocked padded ELL.

This is the device-side replacement for the reference's storage layer
(nalgebra-sparse ``CsrMatrix``/``CscMatrix``/``CooMatrix``, surfaced at
reference ``src/sparse/csr.rs:27-29``). Where the reference keeps ragged
CSR arrays and walks them with Rayon threads, this rebuild re-lays the
matrix out as **padded ELL**: a dense ``[rows_padded, width_padded]`` grid of
(value, minor-index) pairs, one row per major-axis line, padded with zeros.
Static shapes mean XLA can tile the arrays into (8, 128) vregs and every
statistic becomes a fused masked reduction; SpMM becomes a gather-free or
gather-light contraction.

The hot conversion loop is O(nnz) host work. A C++ implementation lives in
``single_algebra_tpu/native`` (used automatically when its shared library is
buildable); this module provides the vectorized-numpy fallback and the shared
shape logic.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_SUBLANE = 8
_LANE = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_width(max_nnz: int) -> int:
    """Pad the ELL width.

    Small widths round to a multiple of 8; widths past 128 round to a
    multiple of 128, so few distinct widths (and compiled shapes) occur.
    """

    if max_nnz == 0:
        return _SUBLANE
    if max_nnz <= _LANE:
        return round_up(max_nnz, _SUBLANE)
    return round_up(max_nnz, _LANE)


def pad_rows(n_rows: int) -> int:
    return max(round_up(n_rows, _SUBLANE), _SUBLANE)


def csr_to_ell_numpy(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n_rows: int,
    width: int | None = None,
    rows_padded: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert CSR arrays to padded ELL (vectorized numpy).

    Returns ``(ell_data [R, W], ell_ids [R, W], row_nnz [R])`` where padding
    entries carry ``data == 0`` and ``id == 0`` (safe for SpMM gathers) and
    validity is derived from ``row_nnz`` — explicit stored zeros remain valid
    entries, matching the reference's "stored entry" semantics (e.g. nonzero
    counts iterate col_indices, reference src/sparse/csr.rs:50-52).
    """

    indptr = np.asarray(indptr, dtype=np.int64)
    row_nnz = np.diff(indptr).astype(np.int32)
    max_nnz = int(row_nnz.max()) if n_rows > 0 else 0
    if width is None:
        width = pad_width(max_nnz)
    elif max_nnz > width:
        raise ValueError(f"width {width} < max row nnz {max_nnz}")
    if rows_padded is None:
        rows_padded = pad_rows(n_rows)

    if n_rows > 0 and data.dtype == np.float32:
        from ..native import build as _native

        nat = _native.csr_to_ell(
            indptr, indices, data, n_rows, width, rows_padded
        )
        if nat is not None:
            return nat

    ell_data = np.zeros((rows_padded, width), dtype=data.dtype)
    ell_ids = np.zeros((rows_padded, width), dtype=np.int32)

    if len(indices) > 0 and n_rows > 0:
        # position of each nnz within its row
        pos_in_row = np.arange(len(indices), dtype=np.int64) - np.repeat(
            indptr[:-1], row_nnz
        )
        row_of_nnz = np.repeat(
            np.arange(n_rows, dtype=np.int64), row_nnz
        )
        ell_data[row_of_nnz, pos_in_row] = data
        ell_ids[row_of_nnz, pos_in_row] = indices.astype(np.int32)

    row_nnz_padded = np.zeros(rows_padded, dtype=np.int32)
    row_nnz_padded[:n_rows] = row_nnz
    return ell_data, ell_ids, row_nnz_padded


def csr_transpose_numpy(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n_rows: int,
    n_cols: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR -> CSC of the same logical matrix == CSR of the transpose.

    Counting-sort construction, O(nnz); minor indices within each output row
    come out sorted, matching nalgebra-sparse invariants.
    """

    nnz = len(indices)
    if nnz > 0 and data.dtype == np.float32:
        from ..native import build as _native

        nat = _native.csr_transpose(indptr, indices, data, n_rows, n_cols)
        if nat is not None:
            return nat

    counts = np.bincount(indices, minlength=n_cols).astype(np.int64)
    out_indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(counts, out=out_indptr[1:])
    out_indices = np.empty(nnz, dtype=np.int32)
    out_data = np.empty(nnz, dtype=data.dtype)
    if nnz:
        row_of_nnz = np.repeat(
            np.arange(n_rows, dtype=np.int32), np.diff(indptr).astype(np.int64)
        )
        # stable sort by column gives CSC order with sorted row indices
        order = np.argsort(indices, kind="stable")
        out_indices[:] = row_of_nnz[order]
        out_data[:] = data[order]
    return out_indptr, out_indices, out_data


def coo_to_csr_numpy(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    sum_duplicates: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO triplets -> CSR with sorted columns (duplicates summed)."""

    import scipy.sparse as sp

    coo = sp.coo_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
    csr = coo.tocsr()
    if sum_duplicates:
        csr.sum_duplicates()
    csr.sort_indices()
    return (
        csr.indptr.astype(np.int64),
        csr.indices.astype(np.int32),
        csr.data,
    )


def slab_row_ranges(n_rows: int, n_slabs: int) -> list[tuple[int, int]]:
    """Split rows into ``n_slabs`` contiguous slabs of near-equal padded size.

    Each slab is a multiple of 8 rows except possibly the last,
    so device shards tile cleanly.
    """

    per = round_up(int(math.ceil(n_rows / n_slabs)), _SUBLANE)
    ranges = []
    start = 0
    for _ in range(n_slabs):
        end = min(start + per, n_rows)
        ranges.append((start, end))
        start = end
    return ranges


def csr_to_tiled_ell_numpy(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n_rows: int,
    n_cols: int,
    col_tile: int = 256,
    rows_padded_to: int = 256,
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Column-tiled padded ELL: the layout of ``ops/tiled.py``.

    Entries are grouped per (row, column-tile); each group is padded to the
    global per-tile width ``wt``. Returns ``(tdata [R, ntiles*wt],
    tlocal [R, ntiles*wt], wt, ntiles)`` where ``tlocal`` holds the
    within-tile column offset (0..col_tile-1) and padding slots carry
    ``v=0, lid=0`` (they accumulate exact zeros into dense-tile column 0).

    The products densify row blocks from this layout (one scatter) and
    contract them against the dense operand as matmuls.
    """

    indptr = np.asarray(indptr, dtype=np.int64)
    ntiles = max(-(-n_cols // col_tile), 1)
    rows_padded = max(round_up(n_rows, rows_padded_to), rows_padded_to)
    nnz = len(indices)
    if nnz == 0 or n_rows == 0:
        wt = 8
        shape = (rows_padded, ntiles * wt)
        return (
            np.zeros(shape, data.dtype),
            np.zeros(shape, np.int32),
            wt,
            ntiles,
        )

    row_nnz = np.diff(indptr)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
    tile_of = indices.astype(np.int64) // col_tile
    lid_of = (indices.astype(np.int64) % col_tile).astype(np.int32)

    # rank of each entry within its (row, tile) group; groups are contiguous
    # because CSR columns are sorted within rows
    key = row_of * ntiles + tile_of
    first = np.ones(nnz, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    group_start = np.maximum.accumulate(np.where(first, np.arange(nnz), 0))
    rank = np.arange(nnz) - group_start

    wt = int(round_up(int(rank.max()) + 1, 8))
    tdata = np.zeros((rows_padded, ntiles * wt), data.dtype)
    tlocal = np.zeros((rows_padded, ntiles * wt), np.int32)
    slot = tile_of * wt + rank
    tdata[row_of, slot] = data
    tlocal[row_of, slot] = lid_of
    return tdata, tlocal, wt, ntiles


def tiled_split_widths(
    indptr: np.ndarray,
    indices: np.ndarray,
    n_rows: int,
    n_cols: int,
    col_tile: int = 256,
    quantile: float = 0.99,
) -> tuple[int, int, int, int]:
    """(wt, ntiles, ov_w, n_overflow) of the two-level tiled layout —
    structure-only, one O(nnz) pass. Used for capacity planning (the 'auto'
    engine selector) without building the layout."""

    indptr = np.asarray(indptr, dtype=np.int64)
    ntiles = max(-(-n_cols // col_tile), 1)
    nnz = len(indices)
    if nnz == 0 or n_rows == 0:
        return 8, ntiles, 0, 0

    from ..native import build as _native

    lib = _native.get_lib()
    if lib is not None:
        indptr64 = np.ascontiguousarray(indptr, np.int64)
        idx32 = np.ascontiguousarray(indices, np.int32)
        hist = np.zeros(4096, np.int64)
        lib.csr_tile_group_hist(indptr64, idx32, n_rows, col_tile, hist, 4096)
        sizes_cum = np.cumsum(hist[1:])
        total = sizes_cum[-1]
        wt = int(np.searchsorted(sizes_cum, quantile * total, side="left") + 1)
        wt = max(round_up(wt, 8), 8)
        ov_w = int(lib.csr_overflow_width(indptr64, idx32, n_rows, col_tile, wt))
        ov_w = round_up(ov_w, 8) if ov_w else 0
        gs = np.arange(1, 4096)
        n_over = int(np.sum(hist[1:] * np.maximum(gs - wt, 0)))
        return wt, ntiles, ov_w, n_over

    row_nnz = np.diff(indptr)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
    tile_of = indices.astype(np.int64) // col_tile
    key = row_of * ntiles + tile_of
    first = np.ones(nnz, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    group_start = np.maximum.accumulate(np.where(first, np.arange(nnz), 0))
    rank = np.arange(nnz) - group_start
    last = np.ones(nnz, dtype=bool)
    last[:-1] = key[1:] != key[:-1]
    sizes = rank[last] + 1
    wt = int(round_up(max(int(np.quantile(sizes, quantile)), 1), 8))
    over = rank >= wt
    n_over = int(over.sum())
    if n_over == 0:
        return wt, ntiles, 0, 0
    ov_per_row = np.bincount(row_of[over], minlength=n_rows)
    ov_w = round_up(int(ov_per_row.max()), 8)
    return wt, ntiles, ov_w, n_over


def csr_to_tiled_ell_split_numpy(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n_rows: int,
    n_cols: int,
    col_tile: int = 256,
    rows_padded_to: int = 256,
    quantile: float = 0.99,
    force_wt: int | None = None,
    force_ov_w: int | None = None,
):
    """Two-level tiled ELL: quantile-width main level + sparse overflow.

    The plain tiled layout pads every (row, tile) group to the GLOBAL max
    group size, so a handful of heavy rows inflate every row's padding
    (4-8x slots/nnz at scRNA densities). Here the main level is padded to
    the ``quantile`` group width (covering ~99% of entries); the rare
    overflow entries go to a narrow plain-ELL side array with global
    column ids, consumed by the XLA gather path.

    Returns ``(tdata_t, tlocal_t, wt, ntiles, ov_data, ov_ids, ov_w)``
    where the first four match ``csr_to_tiled_ell_numpy`` (transposed
    orientation) and the overflow arrays are ``[rows_padded, ov_w]``
    (``ov_w == 0`` when nothing overflows).

    ``force_wt``/``force_ov_w`` pin the widths instead of deriving them
    from THIS matrix's structure — the sharded engine converts each row
    slab with the widths of the GLOBAL plan so per-device payload shapes
    stay uniform. ``force_ov_w`` must be >= the slab's true overflow
    width (it comes from a global max); a violation raises.
    """

    indptr = np.asarray(indptr, dtype=np.int64)
    ntiles = max(-(-n_cols // col_tile), 1)
    rows_padded = max(round_up(n_rows, rows_padded_to), rows_padded_to)
    nnz = len(indices)
    if nnz == 0 or n_rows == 0:
        wt = force_wt if force_wt is not None else 8
        ow = force_ov_w or 0
        shape = (ntiles * wt, rows_padded)
        return (
            np.zeros(shape, data.dtype),
            np.zeros(shape, np.int32),
            wt,
            ntiles,
            np.zeros((rows_padded, ow), data.dtype),
            np.zeros((rows_padded, ow), np.int32),
            ow,
        )

    if data.dtype == np.float32:
        from ..native import build as _native

        lib = _native.get_lib()
        if lib is not None:
            indptr64 = np.ascontiguousarray(indptr, np.int64)
            idx32 = np.ascontiguousarray(indices, np.int32)
            dat = np.ascontiguousarray(data, np.float32)
            if force_wt is not None:
                wt = force_wt
            else:
                hist = np.zeros(4096, np.int64)
                lib.csr_tile_group_hist(
                    indptr64, idx32, n_rows, col_tile, hist, 4096
                )
                sizes_cum = np.cumsum(hist[1:])
                total = sizes_cum[-1]
                wt = int(
                    np.searchsorted(sizes_cum, quantile * total, side="left")
                    + 1
                )
                wt = max(round_up(wt, 8), 8)
            ov_w = int(
                lib.csr_overflow_width(indptr64, idx32, n_rows, col_tile, wt)
            )
            ov_w = round_up(ov_w, 8) if ov_w else 0
            if force_ov_w is not None:
                if ov_w > force_ov_w:
                    raise ValueError(
                        f"forced overflow width {force_ov_w} < true slab "
                        f"overflow width {ov_w}"
                    )
                ov_w = force_ov_w
            tdata_t = np.zeros((ntiles * wt, rows_padded), np.float32)
            tlocal_t = np.zeros((ntiles * wt, rows_padded), np.int32)
            ov_data = np.zeros((rows_padded, max(ov_w, 1)), np.float32)
            ov_ids = np.zeros((rows_padded, max(ov_w, 1)), np.int32)
            lib.csr_to_tiled_ell_split_t_f32(
                indptr64, idx32, dat, n_rows, col_tile, wt, rows_padded,
                ntiles * wt, tdata_t, tlocal_t, ov_data, ov_ids,
                max(ov_w, 1),
            )
            if ov_w == 0:
                ov_data = np.zeros((rows_padded, 0), np.float32)
                ov_ids = np.zeros((rows_padded, 0), np.int32)
            return tdata_t, tlocal_t, wt, ntiles, ov_data, ov_ids, ov_w

    row_nnz = np.diff(indptr)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
    tile_of = indices.astype(np.int64) // col_tile
    lid_of = (indices.astype(np.int64) % col_tile).astype(np.int32)

    key = row_of * ntiles + tile_of
    first = np.ones(nnz, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    group_start = np.maximum.accumulate(np.where(first, np.arange(nnz), 0))
    rank = np.arange(nnz) - group_start

    # group size = rank of the LAST entry in the group + 1; quantile over
    # all (row, tile) groups picks the main-level width
    last = np.ones(nnz, dtype=bool)
    last[:-1] = key[1:] != key[:-1]
    sizes = rank[last] + 1
    if force_wt is not None:
        wt = force_wt
    else:
        wt = int(round_up(max(int(np.quantile(sizes, quantile)), 1), 8))

    main = rank < wt
    tdata_t = np.zeros((ntiles * wt, rows_padded), data.dtype)
    tlocal_t = np.zeros((ntiles * wt, rows_padded), np.int32)
    slot = tile_of[main] * wt + rank[main]
    tdata_t[slot, row_of[main]] = data[main]
    tlocal_t[slot, row_of[main]] = lid_of[main]

    over = ~main
    n_over = int(over.sum())
    if n_over == 0:
        ov_w = force_ov_w or 0
        ov_data = np.zeros((rows_padded, ov_w), data.dtype)
        ov_ids = np.zeros((rows_padded, ov_w), np.int32)
    else:
        o_rows = row_of[over]
        # rank within the row's overflow set
        o_first = np.ones(n_over, dtype=bool)
        o_first[1:] = o_rows[1:] != o_rows[:-1]
        o_start = np.maximum.accumulate(
            np.where(o_first, np.arange(n_over), 0)
        )
        o_rank = np.arange(n_over) - o_start
        ov_w = int(round_up(int(o_rank.max()) + 1, 8))
        if force_ov_w is not None:
            if ov_w > force_ov_w:
                raise ValueError(
                    f"forced overflow width {force_ov_w} < true slab "
                    f"overflow width {ov_w}"
                )
            ov_w = force_ov_w
        ov_data = np.zeros((rows_padded, ov_w), data.dtype)
        ov_ids = np.zeros((rows_padded, ov_w), np.int32)
        ov_data[o_rows, o_rank] = data[over]
        ov_ids[o_rows, o_rank] = indices[over].astype(np.int32)
    return tdata_t, tlocal_t, wt, ntiles, ov_data, ov_ids, ov_w


def row_tile_widths(
    indptr: np.ndarray,
    indices: np.ndarray,
    n_rows: int,
    col_tile: int,
) -> np.ndarray:
    """Per-row maximum (row, tile)-group size — one O(nnz) pass.

    The input of row bucketing: a row's width class is the widest of its
    column-tile groups, i.e. the ``wt`` it would force on an unbucketed
    layout.
    """

    indptr = np.asarray(indptr, np.int64)
    nnz = len(indices)
    out = np.zeros(n_rows, np.int64)
    if nnz == 0 or n_rows == 0:
        return out

    from ..native import build as _native

    lib = _native.get_lib()
    if lib is not None:
        lib.csr_row_tile_widths(
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32),
            n_rows, col_tile, out,
        )
        return out

    row_nnz = np.diff(indptr)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
    tile_of = np.asarray(indices, np.int64) // col_tile
    ntiles = max(int(tile_of.max()) + 1, 1)
    key = row_of * ntiles + tile_of
    first = np.ones(nnz, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    group_start = np.maximum.accumulate(np.where(first, np.arange(nnz), 0))
    rank = np.arange(nnz) - group_start
    last = np.ones(nnz, dtype=bool)
    last[:-1] = key[1:] != key[:-1]
    sizes = rank[last] + 1
    np.maximum.at(out, row_of[last], sizes)
    return out


def extract_rows_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    rows: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sub-CSR of a row subset, vectorized (no Python per-row loop).

    Returns ``(sub_indptr, sub_indices, sub_data)`` for the rows in the
    given order.
    """

    indptr = np.asarray(indptr, np.int64)
    rows = np.asarray(rows, np.int64)
    lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    sub_indptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=sub_indptr[1:])
    total = int(sub_indptr[-1])
    if total == 0:
        return sub_indptr, np.zeros(0, np.int32), np.zeros(0, data.dtype)

    from ..native import build as _native

    lib = _native.get_lib()
    if lib is not None and np.asarray(data).dtype == np.float32:
        out_indices = np.empty(total, np.int32)
        out_data = np.empty(total, np.float32)
        lib.csr_extract_rows_f32(
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32),
            np.ascontiguousarray(data, np.float32),
            np.ascontiguousarray(rows, np.int64),
            len(rows), sub_indptr, out_indices, out_data,
        )
        return sub_indptr, out_indices, out_data

    # gather index: for each output slot, its source position =
    # row_start[r] + offset_within_row
    out_row = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    within = np.arange(total, dtype=np.int64) - sub_indptr[out_row]
    src = indptr[rows][out_row] + within
    return sub_indptr, np.asarray(indices)[src], np.asarray(data)[src]


def fill_class_payload(
    indptr,
    indices,
    data,
    rows,
    n_cols,
    col_tile,
    class_width,
    rows_padded,
    out_td=None,
    out_tl=None,
):
    """Transposed tiled payload ``[ntiles * class_width, rows_padded]``
    for a row subset whose per-(row, tile) group widths are bounded by
    ``class_width`` (a width-class bucket). Shared by the single-chip and
    sharded Gram engines.

    Native fast path with the stale-width-plan guard (the converter
    counts entries whose rank overflows the class width — nonzero means
    the caller's cached bucket plan no longer matches the matrix); numpy
    fallback converts at the true width and pads up to the class.
    ``class_width`` should be a multiple of 8 (the engines use
    ``_width_class`` powers of two): the numpy fallback rounds its
    computed width up to 8, so a narrower class would spuriously trip
    the stale-plan check.
    ``out_td``/``out_tl`` may be preallocated zeroed views (e.g. slices
    of a stacked per-device array); allocated when omitted.
    """

    from ..native import build as _native

    nt = max(-(-n_cols // col_tile), 1)
    c, rc = class_width, rows_padded
    if out_td is None:
        out_td = np.zeros((nt * c, rc), np.float32)
        out_tl = np.zeros((nt * c, rc), np.int32)
    s_ip, s_ix, s_dt = extract_rows_csr(indptr, indices, data, rows)
    lib = _native.get_lib()
    if lib is not None and s_dt.dtype == np.float32:
        dropped = lib.csr_to_tiled_ell_t_f32(
            np.ascontiguousarray(s_ip, np.int64),
            np.ascontiguousarray(s_ix, np.int32),
            np.ascontiguousarray(s_dt, np.float32),
            len(rows), col_tile, c, rc, nt * c, out_td, out_tl,
        )
        if dropped:
            raise RuntimeError(
                f"bucket width plan stale: {dropped} entries exceed "
                f"class width {c} (col_tile={col_tile}); rebuild the "
                "operator after mutating the matrix"
            )
        return out_td, out_tl
    td, tl, wt_d, nt_d, _, _, ovw = csr_to_tiled_ell_split_numpy(
        s_ip, s_ix, s_dt, len(rows), n_cols,
        col_tile=col_tile, rows_padded_to=rc, quantile=1.0,
    )
    if ovw != 0 or nt_d != nt or wt_d > c:
        raise RuntimeError(
            f"bucket width plan stale: width {wt_d} exceeds class {c} "
            f"(col_tile={col_tile}, overflow={ovw})"
        )
    if wt_d < c:  # width-pad to class (slot = tile * c + rank)
        td = np.pad(
            td.reshape(nt, wt_d, rc), ((0, 0), (0, c - wt_d), (0, 0))
        ).reshape(nt * c, rc)
        tl = np.pad(
            tl.reshape(nt, wt_d, rc), ((0, 0), (0, c - wt_d), (0, 0))
        ).reshape(nt * c, rc)
    out_td[:] = td
    out_tl[:] = tl
    return out_td, out_tl



def tiled_overflow_col_width(
    indptr: np.ndarray,
    indices: np.ndarray,
    n_rows: int,
    n_cols: int,
    col_tile: int,
    wt: int,
) -> int:
    """Max per-COLUMN count of overflow entries (rank >= ``wt`` within
    their (row, tile) group) — the rmv-side transposed-overflow ELL width.
    Structure-only, one O(nnz) pass; capacity planning for the tiled
    engines (the mv-side ``ov_w`` is a per-ROW quantity and says nothing
    about the transposed array's width). For the sharded engine this is
    the whole-matrix value, an upper bound on the per-slab max.
    """

    nnz = len(indices)
    if nnz == 0 or n_rows == 0 or wt <= 0:
        return 0
    indptr = np.asarray(indptr, np.int64)
    row_nnz = np.diff(indptr)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
    ntiles = max(-(-n_cols // col_tile), 1)
    tile_of = np.asarray(indices, np.int64) // col_tile
    key = row_of * ntiles + tile_of
    first = np.ones(nnz, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    group_start = np.maximum.accumulate(np.where(first, np.arange(nnz), 0))
    over = (np.arange(nnz) - group_start) >= wt
    if not over.any():
        return 0
    cnt = np.bincount(
        np.asarray(indices, np.int64)[over], minlength=n_cols
    )
    return int(cnt.max())
