"""Column-tiled ELL densify and products (``ops/tiled.py``) against scipy,
plus the host layouts and the operator built on them."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu.ops.tiled import (
    tiled_ell_densify_t,
    tiled_ell_rmv_t,
    tiled_ell_spmm_t,
)
from single_algebra_tpu.sparse.convert import csr_to_tiled_ell_numpy


@pytest.mark.parametrize(
    "n,p,k,density,ct",
    [
        (512, 300, 16, 0.1, 128),
        (1024, 700, 60, 0.05, 256),
        (512, 90, 5, 0.3, 128),  # single tile, p < ct
    ],
)
def test_tiled_spmm_matches_scipy(n, p, k, density, ct):
    rng = np.random.default_rng(0)
    X = sp.random(
        n, p, density=density, format="csr", dtype=np.float64,
        random_state=rng, data_rvs=rng.random,
    ).astype(np.float32)
    td, tl, wt, nt = csr_to_tiled_ell_numpy(
        X.indptr, X.indices, X.data, n, p, col_tile=ct, rows_padded_to=512
    )
    B = rng.standard_normal((p, k)).astype(np.float32)
    kp = max(-(-k // 8) * 8, 8)
    Btp = np.zeros((kp, nt * ct), np.float32)
    Btp[:k, :p] = B.T

    out = tiled_ell_spmm_t(
        jnp.asarray(np.ascontiguousarray(td.T)),
        jnp.asarray(np.ascontiguousarray(tl.T)),
        jnp.asarray(Btp),
        wt=wt,
        ntiles=nt,
        col_tile=ct,
    )
    ref = X @ B
    np.testing.assert_allclose(
        np.asarray(out)[:k, :n].T, ref, rtol=1e-5,
        atol=1e-5 * max(1.0, np.abs(ref).max()),
    )


def test_tiled_converter_roundtrip():
    rng = np.random.default_rng(1)
    X = sp.random(100, 500, density=0.08, format="csr", random_state=rng)
    td, tl, wt, nt = csr_to_tiled_ell_numpy(
        X.indptr, X.indices, X.data, 100, 500, col_tile=128
    )
    dense = np.zeros((td.shape[0], nt * 128))
    for t in range(nt):
        bd = td[:, t * wt : (t + 1) * wt]
        bl = tl[:, t * wt : (t + 1) * wt]
        for w in range(wt):
            np.add.at(dense, (np.arange(td.shape[0]), t * 128 + bl[:, w]), bd[:, w])
    np.testing.assert_allclose(dense[:100, :500], X.toarray(), rtol=1e-12)


def test_empty_matrix_tiled():
    td, tl, wt, nt = csr_to_tiled_ell_numpy(
        np.zeros(11, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32),
        10, 20, col_tile=128,
    )
    assert td.shape[0] >= 10 and not td.any()


@pytest.mark.parametrize(
    "n,p,k,density,ct",
    [
        (512, 300, 16, 0.1, 128),
        (1024, 700, 60, 0.05, 256),
        (512, 90, 5, 0.3, 128),
    ],
)
def test_tiled_rmv_matches_scipy(n, p, k, density, ct):
    """A^T @ C from the SAME row-major tiled payload (no second
    orientation) — the densified block contracted on its row axis."""

    rng = np.random.default_rng(0)
    X = sp.random(
        n, p, density=density, format="csr", dtype=np.float64,
        random_state=rng, data_rvs=rng.random,
    ).astype(np.float32)
    td, tl, wt, nt = csr_to_tiled_ell_numpy(
        X.indptr, X.indices, X.data, n, p, col_tile=ct, rows_padded_to=512
    )
    C = rng.standard_normal((n, k)).astype(np.float32)
    R = td.shape[0]
    kp = max(-(-k // 8) * 8, 8)
    Ctp = np.zeros((kp, R), np.float32)
    Ctp[:k, :n] = C.T

    out = tiled_ell_rmv_t(
        jnp.asarray(np.ascontiguousarray(td.T)),
        jnp.asarray(np.ascontiguousarray(tl.T)),
        jnp.asarray(Ctp),
        wt=wt,
        ntiles=nt,
        col_tile=ct,
    )
    ref = X.T @ C
    np.testing.assert_allclose(
        np.asarray(out)[:p, :k], ref, rtol=1e-5,
        atol=1e-5 * max(1.0, np.abs(ref).max()),
    )


def test_tiled_operator_single_orientation_products():
    """TiledSparseOperator: mv and rmv (+ heavy-row overflow in both
    directions) from ONE row-major payload, vs scipy."""

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.linalg import TiledSparseOperator

    rng = np.random.default_rng(3)
    X = sp.random(700, 520, density=0.05, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random).astype(np.float32)
    # heavy rows to force the overflow side arrays
    X = X.tolil()
    X[10, :400] = rng.random(400)
    X[211, 100:520] = rng.random(420)
    X = X.tocsr().astype(np.float32)
    m = SparseMatrix.from_scipy(X)
    op = TiledSparseOperator.from_matrix(m)
    assert op.meta[4] > 0  # overflow engaged (mv side)
    assert op.meta[5] > 0  # transposed overflow engaged (rmv side)
    B = rng.standard_normal((520, 7)).astype(np.float32)
    C = rng.standard_normal((700, 7)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(op.mv(B)), X @ B, rtol=1e-4,
        atol=1e-4 * np.abs(X @ B).max(),
    )
    np.testing.assert_allclose(
        np.asarray(op.rmv(C)), X.T @ C, rtol=1e-4,
        atol=1e-4 * np.abs(X.T @ C).max(),
    )


def test_tiled_split_widths_matches_build():
    """Capacity planning (structure-only widths) agrees with the built
    layout, native and numpy paths alike."""

    from single_algebra_tpu.sparse.convert import (
        csr_to_tiled_ell_split_numpy,
        tiled_split_widths,
    )

    rng = np.random.default_rng(5)
    X = sp.random(900, 640, density=0.04, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random).astype(np.float32)
    indptr = X.indptr.astype(np.int64)
    idx = X.indices.astype(np.int32)
    wt, nt, ovw, n_over = tiled_split_widths(indptr, idx, 900, 640, col_tile=128)
    td, tl, wtb, ntb, ovd, ovi, ovwb = csr_to_tiled_ell_split_numpy(
        indptr, idx, X.data, 900, 640, col_tile=128
    )
    assert (wt, nt, ovw) == (wtb, ntb, ovwb)
    assert n_over == int((ovd != 0).sum())


def _tiled(X, ct, rows_padded_to=512):
    n, p = X.shape
    td, tl, wt, nt = csr_to_tiled_ell_numpy(
        X.indptr, X.indices, X.data, n, p, col_tile=ct,
        rows_padded_to=rows_padded_to,
    )
    return (
        jnp.asarray(np.ascontiguousarray(td.T)),
        jnp.asarray(np.ascontiguousarray(tl.T)),
        wt,
        nt,
    )


def test_tiled_f64_products_match_scipy():
    """f64 payloads run both products in f64 (the suite enables x64):
    agreement with scipy at 1e-10."""

    rng = np.random.default_rng(2)
    n, p, k, ct = 700, 450, 9, 128
    X = sp.random(n, p, density=0.06, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.standard_normal)
    td, tl, wt, nt = _tiled(X, ct, rows_padded_to=1024)
    assert td.dtype == jnp.float64
    R = td.shape[1]
    B = rng.standard_normal((p, k))
    C = rng.standard_normal((n, k))
    Bt = np.zeros((k, nt * ct))
    Bt[:, :p] = B.T
    Ct = np.zeros((k, R))
    Ct[:, :n] = C.T
    mv = tiled_ell_spmm_t(td, tl, jnp.asarray(Bt), wt=wt, ntiles=nt,
                          col_tile=ct)
    rmv = tiled_ell_rmv_t(td, tl, jnp.asarray(Ct), wt=wt, ntiles=nt,
                          col_tile=ct)
    assert mv.dtype == jnp.float64 and rmv.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(mv)[:, :n].T, X @ B,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(rmv)[:p], X.T @ C,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize(
    "dtype,values",
    [
        (jnp.int8, "counts"),
        (jnp.bfloat16, "counts"),
        (jnp.float32, "uniform"),
    ],
)
def test_tiled_densify_matches_scipy(dtype, values):
    """The densified slab equals the scipy matrix exactly in each tier's
    dtype (no two updates share an element; padding slots are dropped)."""

    rng = np.random.default_rng(4)
    n, p, ct = 300, 700, 256
    rvs = (
        (lambda s: rng.integers(1, 128, s).astype(np.float64))
        if values == "counts" else rng.random
    )
    X = sp.random(n, p, density=0.05, format="lil", dtype=np.float64,
                  random_state=rng, data_rvs=rvs)
    X[3, :] = 0.0  # an empty row amid populated ones
    X = X.tocsr().astype(np.float32)
    td, tl, wt, nt = _tiled(X, ct)
    D = tiled_ell_densify_t(td, tl, wt=wt, ntiles=nt, col_tile=ct,
                            out_dtype=dtype)
    assert D.shape == (nt * ct, td.shape[1]) and D.dtype == dtype
    full = np.asarray(D.astype(jnp.float32), np.float64)
    ref = np.asarray(
        jnp.asarray(X.toarray()).astype(dtype).astype(jnp.float32), np.float64
    )
    np.testing.assert_array_equal(full[:p, :n].T, ref)
    # padded columns and rows stay zero
    assert not full[p:].any() and not full[:, n:].any()


def test_tiled_payload_split_gated_on_width():
    """f32 payloads split to bf16 hi/lo only at wt <= BF16_WT_MAX (the
    crossover where the bf16 matmul saving beats the bf16 densify
    overhead); wide payloads and f64 stay unsplit."""

    from single_algebra_tpu.linalg.operators import TiledSparseOperator as T

    rng = np.random.default_rng(0)
    td = rng.random((8 * 4, 128)).astype(np.float32)
    hi, lo = T._split_payload(td, wt=8)
    assert hi.dtype.itemsize == 2 and lo is not None
    hi_w, lo_w = T._split_payload(td, wt=T.BF16_WT_MAX + 8)
    assert hi_w.dtype == np.float32 and lo_w is None
    # bf16-exact values drop lo entirely
    hi_e, lo_e = T._split_payload(np.round(td * 8) / 8, wt=8)
    assert hi_e.dtype.itemsize == 2 and lo_e is None
    # f64 passes through untouched
    hi64, lo64 = T._split_payload(td.astype(np.float64), wt=8)
    assert hi64.dtype == np.float64 and lo64 is None


def test_tiled_fast_vs_precise_accuracy_classes():
    """On a split (bf16) payload: mv/rmv stay f32-faithful (compensated),
    mv_fast/rmv_fast carry bf16-class error — the contract the randomized
    power iterations rely on."""

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.linalg.operators import TiledSparseOperator

    rng = np.random.default_rng(1)
    X = sp.random(600, 400, density=0.02, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random).astype(np.float32)
    m = SparseMatrix.from_scipy(X)
    op = TiledSparseOperator.from_matrix(m)
    assert op.tdata.dtype.itemsize == 2 and op.tdata_lo is not None
    B = rng.standard_normal((400, 5)).astype(np.float32)
    C = rng.standard_normal((600, 5)).astype(np.float32)
    ref_mv, ref_rv = X @ B, X.T @ C
    prec_mv = np.abs(np.asarray(op.mv(B)) - ref_mv).max() / np.abs(ref_mv).max()
    prec_rv = np.abs(np.asarray(op.rmv(C)) - ref_rv).max() / np.abs(ref_rv).max()
    fast_mv = np.abs(np.asarray(op.mv_fast(B)) - ref_mv).max() / np.abs(ref_mv).max()
    fast_rv = np.abs(np.asarray(op.rmv_fast(C)) - ref_rv).max() / np.abs(ref_rv).max()
    assert prec_mv < 1e-5 and prec_rv < 1e-5, (prec_mv, prec_rv)
    assert fast_mv < 3e-2 and fast_rv < 3e-2  # bf16-class
    assert fast_mv > prec_mv and fast_rv > prec_rv
