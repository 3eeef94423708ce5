"""Golden tests for the L1 statistics surface against scipy/numpy.

Ports the reference's observable unit-test cases (exact normalize values,
nonzero/sum/minmax goldens, zero/empty edge cases, dtype genericity —
reference src/sparse/csr.rs:1378-1551, csc.rs:1064-1315) and adds the
scipy-golden coverage the reference lacks (masked variants, batch group-by,
n-top, variance semantics).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import Direction, SparseMatrix, csc_matrix, csr_matrix
from tests.conftest import make_random_csr

FMT = ["csr", "csc"]


def to_sm(mat, fmt):
    return SparseMatrix.from_scipy(mat, fmt=fmt)


@pytest.mark.parametrize("fmt", FMT)
def test_roundtrip(small_csr, fmt):
    m = to_sm(small_csr, fmt)
    assert m.shape == small_csr.shape
    assert m.nnz == small_csr.nnz
    np.testing.assert_allclose(m.to_dense(), small_csr.toarray(), rtol=1e-12)


@pytest.mark.parametrize("fmt", FMT)
def test_nonzero(small_csr, fmt):
    m = to_sm(small_csr, fmt)
    ref = small_csr.tocsr()
    np.testing.assert_array_equal(
        np.asarray(m.nonzero_row()), np.diff(ref.indptr)
    )
    refc = small_csr.tocsc()
    np.testing.assert_array_equal(
        np.asarray(m.nonzero_col()), np.diff(refc.indptr)
    )


def test_nonzero_counts_stored_zeros():
    # explicit stored zeros count as entries (reference iterates col_indices)
    mat = sp.csr_matrix(
        (np.array([1.0, 0.0, 2.0]), np.array([0, 1, 2]), np.array([0, 2, 3])),
        shape=(2, 3),
    )
    m = SparseMatrix.from_scipy(mat)
    np.testing.assert_array_equal(np.asarray(m.nonzero_row()), [2, 1])
    np.testing.assert_array_equal(np.asarray(m.nonzero_col()), [1, 1, 1])


@pytest.mark.parametrize("fmt", FMT)
def test_sums(small_csr, fmt):
    m = to_sm(small_csr, fmt)
    dense = small_csr.toarray()
    np.testing.assert_allclose(np.asarray(m.sum_row()), dense.sum(1), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(m.sum_col()), dense.sum(0), rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(m.sum_row_squared()), (dense**2).sum(1), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(m.sum_col_squared()), (dense**2).sum(0), rtol=1e-10
    )


@pytest.mark.parametrize("fmt", FMT)
def test_masked_sums_and_counts(small_csr, fmt):
    m = to_sm(small_csr, fmt)
    dense = small_csr.toarray()
    rng = np.random.default_rng(0)
    row_mask = rng.random(dense.shape[0]) < 0.6
    col_mask = rng.random(dense.shape[1]) < 0.6

    # col stats masked over rows
    np.testing.assert_allclose(
        np.asarray(m.sum_col_masked(row_mask)),
        dense[row_mask].sum(0),
        rtol=1e-10,
    )
    np.testing.assert_array_equal(
        np.asarray(m.nonzero_col_masked(row_mask)),
        (dense[row_mask] != 0).sum(0),
    )
    # row stats masked over columns
    np.testing.assert_allclose(
        np.asarray(m.sum_row_masked(col_mask)),
        dense[:, col_mask].sum(1),
        rtol=1e-10,
    )
    np.testing.assert_array_equal(
        np.asarray(m.nonzero_row_masked(col_mask)),
        (dense[:, col_mask] != 0).sum(1),
    )


def test_mask_too_short_raises(small_csr):
    m = to_sm(small_csr, "csr")
    with pytest.raises(ValueError, match="Mask length"):
        m.sum_col_masked(np.ones(3, dtype=bool))
    with pytest.raises(ValueError, match="Mask length"):
        m.nonzero_row_masked(np.ones(3, dtype=bool))


def test_mask_too_long_raises(small_csr):
    """Strict parity: the reference bails on ANY mask-length mismatch
    (csr.rs:158-164), longer masks included — no silent truncation."""

    m = to_sm(small_csr, "csr")
    n, p = m.shape
    with pytest.raises(ValueError, match="Mask length"):
        m.sum_col_masked(np.ones(n + 5, dtype=bool))
    with pytest.raises(ValueError, match="Mask length"):
        m.sum_row_masked(np.ones(p + 1, dtype=bool))
    with pytest.raises(ValueError, match="Mask length"):
        m.var_col_masked(np.ones(n + 2, dtype=bool))


def test_from_dense_and_coo_dtype_policy():
    """from_dense/from_coo follow from_scipy's dtype policy: integer input
    defaults to f32 instead of raising."""

    from single_algebra_tpu import SparseMatrix

    arr = np.array([[1, 0, 2], [0, 3, 0]], dtype=np.int64)
    m = SparseMatrix.from_dense(arr)
    assert m.dtype == np.float32
    np.testing.assert_allclose(m.to_dense(), arr.astype(np.float32))

    mc = SparseMatrix.from_coo(
        np.array([0, 1]), np.array([2, 0]),
        np.array([5, 7], dtype=np.int32), shape=(2, 3),
    )
    assert mc.dtype == np.float32
    assert mc.nnz == 2


@pytest.mark.parametrize("fmt", FMT)
def test_var_dense_semantics(small_csr, fmt):
    m = to_sm(small_csr, fmt)
    dense = small_csr.toarray()
    np.testing.assert_allclose(
        np.asarray(m.var_col()), dense.var(0, ddof=1), rtol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(m.var_row()), dense.var(1, ddof=1), rtol=1e-8
    )


@pytest.mark.parametrize("fmt", FMT)
def test_var_stored_semantics(small_csr, fmt):
    """_chunk/_masked variance = population variance of stored entries."""

    m = to_sm(small_csr, fmt)
    dense = small_csr.toarray()

    def stored_var(axis_vals):
        nz = axis_vals[axis_vals != 0]
        if nz.size == 0:
            return 0.0
        return float((nz**2).mean() - nz.mean() ** 2)

    expected_col = np.array([stored_var(dense[:, j]) for j in range(dense.shape[1])])
    np.testing.assert_allclose(m.var_col_chunk(), expected_col, atol=1e-10)

    row_mask = np.arange(dense.shape[0]) % 2 == 0
    dm = dense.copy()
    dm[~row_mask] = 0
    expected_masked = np.array(
        [stored_var(dm[:, j]) for j in range(dense.shape[1])]
    )
    np.testing.assert_allclose(
        np.asarray(m.var_col_masked(row_mask)), expected_masked, atol=1e-10
    )


@pytest.mark.parametrize("fmt", FMT)
def test_min_max(small_csr, fmt):
    m = to_sm(small_csr, fmt)
    dense = small_csr.toarray()
    mins, maxs = m.min_max_col()
    finfo = np.finfo(dense.dtype)
    for j in range(dense.shape[1]):
        nz = dense[:, j][dense[:, j] != 0]
        if nz.size:
            assert np.isclose(mins[j], nz.min())
            assert np.isclose(maxs[j], nz.max())
        else:
            # empty columns keep the sentinel init values (csr.rs:921-922)
            assert mins[j] == finfo.max
            assert maxs[j] == finfo.min


def test_empty_and_all_zero():
    empty = sp.csr_matrix((4, 5))
    m = SparseMatrix.from_scipy(empty)
    np.testing.assert_array_equal(np.asarray(m.nonzero_row()), np.zeros(4))
    np.testing.assert_array_equal(np.asarray(m.sum_col()), np.zeros(5))
    np.testing.assert_array_equal(np.asarray(m.var_col()), np.zeros(5))

    zero_rows = sp.csr_matrix((0, 5))
    m0 = SparseMatrix.from_scipy(zero_rows)
    assert np.asarray(m0.sum_row()).shape == (0,)


def test_dtype_genericity(small_csr):
    m = to_sm(small_csr, "csr")
    # integer count output types (reference tests u8/u64, csr.rs:1458-1468)
    import jax.numpy as jnp

    for dt in (jnp.uint8, jnp.int32, jnp.uint32, jnp.int64):
        counts = np.asarray(m.nonzero_row(dtype=dt))
        np.testing.assert_array_equal(
            counts.astype(np.int64), np.diff(small_csr.tocsr().indptr)
        )
    # f32 storage
    m32 = SparseMatrix.from_scipy(small_csr, fmt="csr", dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(m32.sum_col()), small_csr.toarray().sum(0), rtol=1e-5
    )


def test_chunk_accumulation(small_csr):
    """Streamed accumulation over row chunks == whole-matrix stats
    (reference _chunk variants, src/sparse/mod.rs:44-50)."""

    dense = small_csr.toarray()
    acc = np.zeros(dense.shape[1])
    cnt = np.zeros(dense.shape[1], dtype=np.int64)
    mins = np.full(dense.shape[1], np.finfo(np.float64).max)
    maxs = np.full(dense.shape[1], np.finfo(np.float64).min)
    for start in range(0, dense.shape[0], 16):
        chunk = SparseMatrix.from_scipy(
            sp.csr_matrix(small_csr[start : start + 16])
        )
        acc = chunk.sum_col_chunk(acc)
        cnt = chunk.nonzero_col_chunk(cnt)
        mins, maxs = chunk.min_max_col_chunk((mins, maxs))
    np.testing.assert_allclose(acc, dense.sum(0), rtol=1e-10)
    np.testing.assert_array_equal(cnt, (dense != 0).sum(0))
    nzmask = (dense != 0).any(0)
    np.testing.assert_allclose(
        mins[nzmask],
        np.where(
            nzmask, np.where(dense == 0, np.inf, dense).min(0), np.inf
        )[nzmask],
    )


def test_chunk_smaller_reference(small_csr):
    """Out-of-range indices are skipped (reference csr.rs:126-130,
    test at csr.rs:1490-1501)."""

    m = to_sm(small_csr, "csr")
    short = np.zeros(10, dtype=np.int64)
    out = m.nonzero_col_chunk(short)
    dense = small_csr.toarray()
    np.testing.assert_array_equal(out, (dense[:, :10] != 0).sum(0))


@pytest.mark.parametrize("fmt", FMT)
def test_sum_row_n_top(fmt):
    mat = make_random_csr(30, 20, density=0.4, seed=7)
    mat.data = mat.data - 0.5  # include negatives
    m = to_sm(mat, fmt)
    dense = mat.toarray()
    for n in (1, 3, 100):
        expected = []
        for r in range(dense.shape[0]):
            vals = dense[r][dense[r] != 0]
            vals = np.sort(vals)[::-1]
            expected.append(vals[:n].sum())
        np.testing.assert_allclose(
            np.asarray(m.sum_row_n_top(n)), expected, atol=1e-10
        )


@pytest.mark.parametrize("fmt", FMT)
def test_batch_stats(fmt):
    mat = make_random_csr(24, 15, density=0.5, seed=3)
    m = to_sm(mat, fmt)
    dense = mat.toarray()
    row_batches = ["a", "b", "c"] * 8
    col_batches = ["x", "y", "z"] * 5

    # mean_batch_col: batches over rows -> per-col mean incl. zeros
    out = m.mean_batch_col(row_batches)
    for b in "abc":
        rows = [i for i, lbl in enumerate(row_batches) if lbl == b]
        np.testing.assert_allclose(
            np.asarray(out[b]), dense[rows].mean(0), rtol=1e-10
        )

    # mean_batch_row: batches over columns -> per-row mean incl. zeros
    out = m.mean_batch_row(col_batches)
    for b in "xyz":
        cols = [j for j, lbl in enumerate(col_batches) if lbl == b]
        np.testing.assert_allclose(
            np.asarray(out[b]), dense[:, cols].mean(1), rtol=1e-10
        )

    # var_batch_row: batches over rows -> per-col stored-entry sample var
    out = m.var_batch_row(row_batches)
    for b in "abc":
        rows = [i for i, lbl in enumerate(row_batches) if lbl == b]
        sub = dense[rows]
        expected = []
        for j in range(sub.shape[1]):
            nz = sub[:, j][sub[:, j] != 0]
            expected.append(nz.var(ddof=1) if nz.size > 1 else 0.0)
        np.testing.assert_allclose(np.asarray(out[b]), expected, atol=1e-9)

    # var_batch_col: batches over columns -> per-row stored-entry sample var
    out = m.var_batch_col(col_batches)
    for b in "xyz":
        cols = [j for j, lbl in enumerate(col_batches) if lbl == b]
        sub = dense[:, cols]
        expected = []
        for i in range(sub.shape[0]):
            nz = sub[i][sub[i] != 0]
            expected.append(nz.var(ddof=1) if nz.size > 1 else 0.0)
        np.testing.assert_allclose(np.asarray(out[b]), expected, atol=1e-9)


def test_batch_length_validation(small_csr):
    m = to_sm(small_csr, "csr")
    with pytest.raises(ValueError, match="Batch vector length"):
        m.var_batch_row(["a"] * 3)


@pytest.mark.parametrize("fmt", FMT)
def test_matmul(small_csr, fmt):
    m = to_sm(small_csr, fmt)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((small_csr.shape[1], 8))
    C = rng.standard_normal((small_csr.shape[0], 8))
    np.testing.assert_allclose(
        np.asarray(m.matmul_dense(B)), small_csr @ B, rtol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(m.rmatmul_dense(C)), small_csr.T @ C, rtol=1e-8
    )


def test_normalize_column_on_csc(small_csr):
    """COLUMN normalize where the minor axis needs a gathered scale."""

    from single_algebra_tpu import Direction

    m = SparseMatrix.from_scipy(small_csr.tocsc(), fmt="csc")
    sums = np.asarray(m.sum_col())
    out = m.normalize(sums, 5.0, Direction.COLUMN)
    cs = out.to_dense().sum(0)
    np.testing.assert_allclose(cs[sums > 0], 5.0, atol=1e-5)


def test_batch_singleton_batches():
    """Batches with a single member: var over <2 stored entries -> 0."""

    mat = sp.csr_matrix(np.array([[1.0, 2.0], [3.0, 0.0], [0.0, 5.0]]))
    m = SparseMatrix.from_scipy(mat)
    out = m.var_batch_row(["a", "b", "c"])  # every batch has one row
    for b in "abc":
        np.testing.assert_array_equal(np.asarray(out[b]), 0.0)
    means = m.mean_batch_col(["a", "b", "c"])
    np.testing.assert_allclose(np.asarray(means["a"]), [1.0, 2.0])


def test_n_top_with_ties_and_negatives():
    mat = sp.csr_matrix(np.array([[2.0, 2.0, -1.0, 0.0], [-3.0, -1.0, 0.0, 0.0]]))
    m = SparseMatrix.from_scipy(mat)
    np.testing.assert_allclose(np.asarray(m.sum_row_n_top(2)), [4.0, -4.0])
    np.testing.assert_allclose(np.asarray(m.sum_row_n_top(1)), [2.0, -1.0])


def test_masked_all_false(small_csr):
    m = SparseMatrix.from_scipy(small_csr)
    mask = np.zeros(small_csr.shape[0], bool)
    np.testing.assert_array_equal(
        np.asarray(m.sum_col_masked(mask)), np.zeros(small_csr.shape[1])
    )
    np.testing.assert_array_equal(
        np.asarray(m.var_col_masked(mask)), np.zeros(small_csr.shape[1])
    )


def test_from_dense_and_coo_constructors():
    dense = np.array([[0.0, 1.5], [2.0, 0.0], [0.0, 0.0]])
    m = SparseMatrix.from_dense(dense)
    np.testing.assert_allclose(m.to_dense(), dense)
    m2 = SparseMatrix.from_coo(
        np.array([0, 1]), np.array([1, 0]), np.array([1.5, 2.0]),
        shape=(3, 2),
    )
    np.testing.assert_allclose(m2.to_dense(), dense)
    # duplicate COO entries are summed (nalgebra CooMatrix semantics)
    m3 = SparseMatrix.from_coo(
        np.array([0, 0]), np.array([1, 1]), np.array([1.0, 0.5]),
        shape=(3, 2),
    )
    assert m3.to_dense()[0, 1] == 1.5


def test_native_lib_rebuild(tmp_path, small_csr):
    """The native converter self-builds from source when the .so is absent
    and falls back to numpy when disabled."""

    import os
    from single_algebra_tpu.native import build as nb

    assert os.path.exists(nb._SRC)
    # numpy fallback path (explicit disable)
    os.environ["SINGLE_ALGEBRA_TPU_NO_NATIVE"] = "1"
    nb._tried, nb._lib = True, None
    try:
        m = SparseMatrix.from_scipy(small_csr, dtype=np.float32)
        np.testing.assert_allclose(
            np.asarray(m.sum_col()), small_csr.toarray().sum(0), rtol=1e-5
        )
    finally:
        os.environ.pop("SINGLE_ALGEBRA_TPU_NO_NATIVE")
        nb._tried, nb._lib = False, None


def test_fill_class_payload_native_matches_numpy():
    """The shared class-payload converter (both Gram engines) produces
    identical payloads from its native and numpy paths, and rejects a
    stale width plan instead of truncating silently."""

    import os

    import scipy.sparse as sp

    from single_algebra_tpu.native import build as native_build
    from single_algebra_tpu.sparse.convert import (
        fill_class_payload,
        row_tile_widths,
    )

    rng = np.random.default_rng(4)
    X = sp.random(
        300, 200, density=0.08, format="csr", dtype=np.float32,
        random_state=rng, data_rvs=lambda s: rng.poisson(2, s) + 1.0,
    )
    indptr = X.indptr.astype(np.int64)
    indices = X.indices.astype(np.int32)
    data = X.data.astype(np.float32)
    from single_algebra_tpu.linalg.gram import _width_class

    ct = 64
    rows = np.arange(0, 300, 2, dtype=np.int64)
    w = row_tile_widths(indptr, indices, 300, ct)[rows].max()
    c, rc = _width_class(int(max(8, w))), 256
    assert c > 8  # the stale-plan probe below needs a smaller class

    td_n, tl_n = fill_class_payload(
        indptr, indices, data, rows, 200, ct, c, rc
    )
    if native_build.get_lib() is not None:
        os.environ["SINGLE_ALGEBRA_TPU_NO_NATIVE"] = "1"
        native_build._lib, native_build._tried = None, True
        try:
            td_p, tl_p = fill_class_payload(
                indptr, indices, data, rows, 200, ct, c, rc
            )
        finally:
            del os.environ["SINGLE_ALGEBRA_TPU_NO_NATIVE"]
            native_build._tried = False
        np.testing.assert_array_equal(td_n, td_p)
        np.testing.assert_array_equal(tl_n, tl_p)

    # stale plan: a class width below the true max must raise, not drop
    with pytest.raises(RuntimeError, match="stale"):
        fill_class_payload(indptr, indices, data, rows, 200, ct, 8, rc)


def test_map_stored_preserves_transpose_cache():
    """Elementwise maps (log1p/normalize/expm1) must keep BOTH cached
    layouts device-side: rebuilding the transpose after a value map costs
    a host round-trip per call."""

    import jax.numpy as jnp
    import scipy.sparse as sp
    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.types import Direction

    rng = np.random.default_rng(0)
    A = sp.random(40, 30, density=0.2, random_state=1, format="csr")
    A.data = rng.uniform(0.5, 2.0, A.nnz)
    m = SparseMatrix.from_scipy(A)
    m.sum_col()  # materialize + cache the column-major layout
    assert m._transpose_cache is not None

    # log1p: twin present, no host structure consulted, values correct
    ml = m.log1p_normalize()
    assert ml._transpose_cache is not None
    np.testing.assert_allclose(
        np.asarray(ml.sum_col()),
        np.asarray(np.log1p(A.toarray()).sum(axis=0)).ravel(),
        rtol=1e-6,
    )
    # twin round-trips: transpose of the twin IS the mapped matrix
    assert ml._transpose_cache._transpose_cache is ml

    # normalize (minor-axis gather path) keeps the twin too
    sums = np.asarray(m.sum_row())
    mn = m.normalize(jnp.asarray(sums, m.dtype), 100.0, Direction.ROW)
    assert mn._transpose_cache is not None
    np.testing.assert_allclose(
        np.asarray(mn.sum_row()),
        np.where(sums > 0, 100.0, 0.0),
        rtol=1e-5,
    )
    # column stat on the twin matches a from-scratch build
    ref = SparseMatrix.from_scipy(
        sp.csr_matrix(
            A.multiply(np.where(sums > 0, 100.0 / sums, 1.0)[:, None])
        )
    )
    np.testing.assert_allclose(
        np.asarray(mn.sum_col()), np.asarray(ref.sum_col()), rtol=1e-5
    )

    # map_stored with row+col dependence (the tfidf shape)
    rfac = jnp.asarray(rng.uniform(0.5, 1.5, 40), m.dtype)
    cfac = jnp.asarray(rng.uniform(0.5, 1.5, 30), m.dtype)
    mt = m.map_stored(
        lambda v, r, c: v * jnp.take(rfac, r) * jnp.take(cfac, c)
    )
    dense = A.toarray() * np.asarray(rfac)[:, None] * np.asarray(cfac)
    np.testing.assert_allclose(
        np.asarray(mt.sum_col()), dense.sum(axis=0), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(mt.sum_row()), dense.sum(axis=1), rtol=1e-5
    )


def test_map_stored_without_cached_transpose():
    """No twin cached: map_stored still works and later transposes are
    built lazily from host structure."""

    import scipy.sparse as sp
    from single_algebra_tpu import SparseMatrix

    A = sp.random(20, 15, density=0.3, random_state=2, format="csr")
    m = SparseMatrix.from_scipy(A)
    assert m._transpose_cache is None
    ml = m.log1p_normalize()
    assert ml._transpose_cache is None
    np.testing.assert_allclose(
        np.asarray(ml.sum_col()),
        np.log1p(A.toarray()).sum(axis=0),
        rtol=1e-6,
    )


def test_select_on_device_valued_matrix():
    """select_rows/select_cols on a value-mapped matrix (h_data=None)
    must route through the structural gather and match selection on the
    equivalent host-built matrix, for both formats and both bool/index
    selections."""

    import scipy.sparse as sp
    from single_algebra_tpu import SparseMatrix

    rng = np.random.default_rng(5)
    A = sp.random(60, 45, density=0.25, random_state=4, format="csr")
    A.data = rng.uniform(0.5, 2.0, A.nnz)
    L = np.log1p(A.toarray())

    for fmt in ("csr", "csc"):
        base = A.tocsr() if fmt == "csr" else A.tocsc()
        m = SparseMatrix.from_scipy(base)
        ml = m.log1p_normalize()
        assert ml._h_data is None

        rows = np.asarray([3, 0, 17, 44, 59])
        mr = ml.select_rows(rows)
        assert mr.format == fmt and mr.shape == (5, 45)
        np.testing.assert_allclose(
            np.asarray(mr.to_dense()), L[rows], rtol=1e-6
        )
        # column bool mask
        cmask = np.zeros(45, bool)
        cmask[[1, 7, 8, 30, 44]] = True
        mc = ml.select_cols(cmask)
        assert mc.format == fmt and mc.shape == (60, 5)
        np.testing.assert_allclose(
            np.asarray(mc.to_dense()), L[:, cmask], rtol=1e-6
        )
        # stats on the selected matrices agree with dense truth
        np.testing.assert_allclose(
            np.asarray(mc.sum_col()), L[:, cmask].sum(0), rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(mr.sum_row()), L[rows].sum(1), rtol=1e-5
        )
