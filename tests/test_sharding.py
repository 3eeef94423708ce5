"""Multi-device tests on the virtual 8-device CPU mesh.

Verifies the sharded operator and sharded PCA agree with the single-device
path bit-for-bit (same seed, same algorithm) — the distributed-test story
the reference entirely lacks (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import SparseMatrix
from single_algebra_tpu.linalg import CenteredOperator, SparseOperator, randomized_svd
from single_algebra_tpu.parallel import ShardedSpMM, make_mesh, sharded_pca_fit_transform
from single_algebra_tpu.types import PowerIterationNormalizer as PIN, SVDMethod

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh"
)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = sp.random(403, 97, density=0.2, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random)
    return X, SparseMatrix.from_scipy(X, dtype=np.float64)


def test_sharded_products_match(problem):
    X, m = problem
    mesh = make_mesh(8)
    op = ShardedSpMM.from_matrix(m, mesh)
    rng = np.random.default_rng(1)
    B = rng.standard_normal((97, 6))
    C = rng.standard_normal((403, 6))
    np.testing.assert_allclose(np.asarray(op.mv(B)), X @ B, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(op.rmv(C)), X.T @ C, rtol=1e-10)


def test_sharded_col_stats(problem):
    X, m = problem
    op = ShardedSpMM.from_matrix(m, make_mesh(8))
    s, sq, cnt = op.col_stats()
    dense = X.toarray()
    np.testing.assert_allclose(np.asarray(s), dense.sum(0), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sq), (dense**2).sum(0), rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(cnt), (dense != 0).sum(0))


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_svd_matches_single_device(problem, ndev):
    X, m = problem
    op1 = SparseOperator.from_matrix(m)
    res1 = randomized_svd(op1, 5, 10, 4, PIN.QR, seed=3)
    opn = ShardedSpMM.from_matrix(m, make_mesh(ndev))
    resn = randomized_svd(opn, 5, 10, 4, PIN.QR, seed=3)
    np.testing.assert_allclose(
        np.asarray(resn.s), np.asarray(res1.s), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.abs(np.asarray(resn.u)), np.abs(np.asarray(res1.u)), atol=1e-7
    )


def test_sharded_pca_matches_sklearn():
    from sklearn.decomposition import PCA as SkPCA
    from tests.conftest import cluster_counts

    X = cluster_counts(500, 120, n_clusters=10, seed=2)
    res = sharded_pca_fit_transform(
        X, n_components=6, mesh=make_mesh(8),
        svd_method=SVDMethod.random(10, 7, PIN.QR), seed=42,
    )
    sk = SkPCA(n_components=6, svd_solver="full").fit(X.toarray())
    rel = (
        np.abs(np.asarray(res.explained_variance) - sk.explained_variance_)
        / sk.explained_variance_
    )
    assert rel[:5].max() < 1e-6
    np.testing.assert_allclose(
        float(res.total_variance),
        X.toarray().var(0, ddof=1).sum(),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(res.transformed)[:, :5],
        sk.transform(X.toarray())[:, :5],
        rtol=1e-3, atol=1e-5 * np.abs(np.asarray(res.transformed)).max(),
    )


@pytest.mark.parametrize("n_rows", [5, 20, 100])
def test_sharded_small_row_counts(n_rows):
    """Slab bounds must clamp to n_rows: rounding the per-device slab up
    to a multiple of 8 can push d*rs past the matrix end (n=20 and n=100
    on an 8-device mesh used to crash with IndexError)."""

    rng = np.random.default_rng(7)
    X = sp.random(n_rows, 33, density=0.4, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random)
    m = SparseMatrix.from_scipy(X, dtype=np.float64)
    op = ShardedSpMM.from_matrix(m, make_mesh(8))
    B = rng.standard_normal((33, 4))
    C = rng.standard_normal((n_rows, 4))
    np.testing.assert_allclose(np.asarray(op.mv(B)), X @ B, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(op.rmv(C)), X.T @ C, rtol=1e-10)


def test_sharded_lanczos_matches_single_device(problem):
    from single_algebra_tpu.linalg import lanczos_svd

    X, m = problem
    op1 = SparseOperator.from_matrix(m)
    res1 = lanczos_svd(op1, 5, steps=60, seed=3)
    opn = ShardedSpMM.from_matrix(m, make_mesh(8))
    resn = lanczos_svd(opn, 5, steps=60, seed=3)
    np.testing.assert_allclose(
        np.asarray(resn.s), np.asarray(res1.s), rtol=1e-8
    )
    np.testing.assert_allclose(
        np.abs(np.asarray(resn.u)), np.abs(np.asarray(res1.u)), atol=1e-6
    )


def test_sharded_pca_lanczos_path():
    """Mesh path supports BOTH SVDMethods (reference pca/mod.rs:49-68)."""

    from single_algebra_tpu.models import SparsePCABuilder
    from tests.conftest import cluster_counts

    X = cluster_counts(300, 80, n_clusters=6, seed=4)
    res = sharded_pca_fit_transform(
        X, n_components=5, mesh=make_mesh(8),
        svd_method=SVDMethod.lanczos(), seed=42, lanczos_steps=60,
    )
    single = (
        SparsePCABuilder().n_components(5).svd_method(SVDMethod.lanczos())
        .build()
    )
    single.lanczos_steps = 60
    single.fit(X)
    np.testing.assert_allclose(
        np.asarray(res.explained_variance),
        np.asarray(single.explained_variance_),
        rtol=1e-8,
    )


def test_sharded_masked_pca_matches_masked_model():
    """Sharded masked PCA == single-device MaskedSparsePCA on the same
    mask/seed (both SVD methods ride the same MaskedOperator gather)."""

    from single_algebra_tpu.models import MaskedSparsePCABuilder
    from single_algebra_tpu.types import SVDMethod as SM
    from tests.conftest import cluster_counts

    X = cluster_counts(300, 90, n_clusters=6, seed=9)
    rng = np.random.default_rng(1)
    mask = rng.random(90) < 0.4
    mask[:5] = True
    method = SM.random(8, 5, PIN.QR)
    res = sharded_pca_fit_transform(
        X, n_components=4, mesh=make_mesh(8), svd_method=method,
        seed=42, mask=mask,
    )
    single = (
        MaskedSparsePCABuilder().mask(mask).n_components(4)
        .svd_method(method).build()
    )
    T1 = single.fit_transform(X)
    assert res.components.shape == (4, int(mask.sum()))
    np.testing.assert_allclose(
        np.asarray(res.explained_variance),
        np.asarray(single.explained_variance_),
        rtol=1e-8,
    )
    np.testing.assert_allclose(
        np.asarray(res.transformed), np.asarray(T1), rtol=1e-6, atol=1e-9
    )


def test_sharded_centered_operator(problem):
    X, m = problem
    op = ShardedSpMM.from_matrix(m, make_mesh(4))
    mu = np.asarray(X.mean(axis=0)).ravel()
    cop = CenteredOperator(op, mu)
    rng = np.random.default_rng(2)
    B = rng.standard_normal((97, 3))
    C = rng.standard_normal((403, 3))
    np.testing.assert_allclose(
        np.asarray(cop.mv(B)), (X.toarray() - mu) @ B, rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(cop.rmv(C)), (X.toarray() - mu).T @ C, rtol=1e-9
    )


def test_sharded_tiled_products(problem):
    """ShardedTiled (tiled products per slab) == scipy on both
    product directions, including the heavy-row overflow side arrays."""

    from single_algebra_tpu.parallel import ShardedTiled

    X, m = problem
    op = ShardedTiled.from_matrix(m, make_mesh(8))
    rng = np.random.default_rng(1)
    B = rng.standard_normal((97, 6))
    C = rng.standard_normal((403, 6))
    np.testing.assert_allclose(np.asarray(op.mv(B)), X @ B, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(op.rmv(C)), X.T @ C, rtol=1e-10)
    s, sq, cnt = op.col_stats()
    dense = X.toarray()
    np.testing.assert_allclose(np.asarray(s), dense.sum(0), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sq), (dense**2).sum(0), rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(cnt), (dense != 0).sum(0))


def test_sharded_tiled_overflow_rows():
    """A few ultra-dense rows must land in the overflow side arrays (global
    width plan) and still produce exact products on every device."""

    from single_algebra_tpu.parallel import ShardedTiled

    rng = np.random.default_rng(3)
    X = sp.random(300, 500, density=0.02, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random).tolil()
    X[7, :] = rng.random(500)  # dense rows force per-tile overflow
    X[205, ::2] = rng.random(250)
    X = X.tocsr()
    m = SparseMatrix.from_scipy(X, dtype=np.float64)
    op = ShardedTiled.from_matrix(m, make_mesh(8))
    assert op.meta[4] > 0, "expected mv-side overflow entries"
    assert op.meta[5] > 0, "expected rmv-side overflow entries"
    B = rng.standard_normal((500, 5))
    C = rng.standard_normal((300, 5))
    np.testing.assert_allclose(np.asarray(op.mv(B)), X @ B, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(op.rmv(C)), X.T @ C, rtol=1e-10)


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_tiled_mesh_invariance(problem, ndev):
    """Same SVD result at every mesh size (and vs the single-device
    gather operator)."""

    from single_algebra_tpu.parallel import ShardedTiled

    X, m = problem
    op1 = SparseOperator.from_matrix(m)
    res1 = randomized_svd(op1, 5, 10, 4, PIN.QR, seed=3)
    opn = ShardedTiled.from_matrix(m, make_mesh(ndev))
    resn = randomized_svd(opn, 5, 10, 4, PIN.QR, seed=3)
    np.testing.assert_allclose(
        np.asarray(resn.s), np.asarray(res1.s), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.abs(np.asarray(resn.u)), np.abs(np.asarray(res1.u)), atol=1e-7
    )


def test_sharded_tiled_pca_matches_sklearn():
    from sklearn.decomposition import PCA as SkPCA
    from tests.conftest import cluster_counts

    X = cluster_counts(500, 120, n_clusters=10, seed=2)
    res = sharded_pca_fit_transform(
        X, n_components=6, mesh=make_mesh(8),
        svd_method=SVDMethod.random(10, 7, PIN.QR), seed=42, engine="tiled",
    )
    sk = SkPCA(n_components=6, svd_solver="full").fit(X.toarray())
    rel = (
        np.abs(np.asarray(res.explained_variance) - sk.explained_variance_)
        / sk.explained_variance_
    )
    assert rel[:5].max() < 1e-6
    np.testing.assert_allclose(
        np.asarray(res.transformed)[:, :5],
        sk.transform(X.toarray())[:, :5],
        rtol=1e-3, atol=1e-5 * np.abs(np.asarray(res.transformed)).max(),
    )


@pytest.mark.parametrize("n_rows", [5, 20, 100])
def test_sharded_tiled_small_row_counts(n_rows):
    from single_algebra_tpu.parallel import ShardedTiled

    rng = np.random.default_rng(7)
    X = sp.random(n_rows, 33, density=0.4, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random)
    m = SparseMatrix.from_scipy(X, dtype=np.float64)
    op = ShardedTiled.from_matrix(m, make_mesh(8))
    B = rng.standard_normal((33, 4))
    C = rng.standard_normal((n_rows, 4))
    np.testing.assert_allclose(np.asarray(op.mv(B)), X @ B, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(op.rmv(C)), X.T @ C, rtol=1e-10)


def test_sharded_densified_products():
    from single_algebra_tpu.parallel import ShardedDensified
    from tests.conftest import cluster_counts

    X = cluster_counts(400, 96, n_clusters=6, seed=5).astype(np.float32)
    m = SparseMatrix.from_scipy(X, device=False)
    op = ShardedDensified.from_matrix(m, make_mesh(8))
    rng = np.random.default_rng(0)
    B = rng.standard_normal((96, 5)).astype(np.float32)
    C = rng.standard_normal((400, 5)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(op.mv_precise(B)), X @ B, rtol=2e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(op.rmv_precise(C)), X.T @ C, rtol=2e-3, atol=1e-3
    )
    s, sq = op.col_stats()
    np.testing.assert_allclose(np.asarray(s), X.toarray().sum(0), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(sq), (X.toarray() ** 2).sum(0), rtol=1e-5
    )


def test_sharded_densified_pca():
    from single_algebra_tpu.parallel import sharded_pca_fit_transform
    from tests.conftest import cluster_counts
    from sklearn.decomposition import PCA as SkPCA

    X = cluster_counts(500, 120, n_clusters=10, seed=2).astype(np.float32)
    res = sharded_pca_fit_transform(
        X, n_components=6, mesh=make_mesh(8),
        svd_method=SVDMethod.random(10, 7, PIN.QR), seed=42, engine="dense",
    )
    sk = SkPCA(n_components=6, svd_solver="full").fit(X.toarray())
    rel = (
        np.abs(np.asarray(res.explained_variance) - sk.explained_variance_.astype(np.float32))
        / sk.explained_variance_
    )
    # bf16-exact count data: parity like the single-device dense engine
    assert rel[:5].max() < 1e-5


def test_choose_sharded_engine_dtype_gate(problem, monkeypatch):
    """dense/tiled split f32 values into bf16 terms: the auto ladder must
    route f64 matrices to the gather path even where the ladder is on."""

    from single_algebra_tpu import platform
    from single_algebra_tpu.parallel import choose_sharded_engine

    X, m = problem  # f64 fixture
    monkeypatch.setattr(platform, "engine_ladder", lambda: True)
    assert choose_sharded_engine(m, make_mesh(8)) == "sparse"
    m32 = SparseMatrix.from_scipy(X.astype(np.float32))
    assert choose_sharded_engine(m32, make_mesh(8)) != "sparse"


def test_sharded_tiled_bf16_payload_products():
    """f32 matrices take the bf16 hi/lo payload in the sharded engine too
    (wt-gated): precise products stay f32-class, fast products bf16-class,
    across the 8-device mesh."""

    from single_algebra_tpu.parallel import ShardedTiled

    rng = np.random.default_rng(5)
    # sparse enough that the quantile tile width lands under the bf16 gate
    X32 = sp.random(403, 600, density=0.02, format="csr", dtype=np.float64,
                    random_state=rng, data_rvs=rng.random).astype(np.float32)
    m = SparseMatrix.from_scipy(X32)
    op = ShardedTiled.from_matrix(m, make_mesh(8))
    assert op.tdata.dtype == jnp.bfloat16, op.meta
    B = rng.standard_normal((600, 6)).astype(np.float32)
    C = rng.standard_normal((403, 6)).astype(np.float32)
    ref_mv, ref_rv = X32 @ B, X32.T @ C
    prec = np.abs(np.asarray(op.mv(B)) - ref_mv).max() / np.abs(ref_mv).max()
    fast = np.abs(np.asarray(op.mv_fast(B)) - ref_mv).max() / np.abs(ref_mv).max()
    prec_r = np.abs(np.asarray(op.rmv(C)) - ref_rv).max() / np.abs(ref_rv).max()
    fast_r = np.abs(np.asarray(op.rmv_fast(C)) - ref_rv).max() / np.abs(ref_rv).max()
    assert prec < 1e-5 and prec_r < 1e-5, (prec, prec_r)
    assert fast < 3e-2 and fast_r < 3e-2
