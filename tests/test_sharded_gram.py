"""Sharded Gram-PCA: mesh-size invariance and exactness (8-dev CPU mesh)."""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import SparseMatrix
from single_algebra_tpu.parallel import make_mesh, sharded_gram_pca
from tests.conftest import cluster_counts


@pytest.fixture(scope="module")
def data():
    return cluster_counts(600, 120, n_clusters=8, seed=4).astype(np.float32)


def _truth(X, k):
    D = X.toarray().astype(np.float64)
    Dc = D - D.mean(axis=0)
    s = np.linalg.svd(Dc, compute_uv=False)
    return s[:k] ** 2 / (X.shape[0] - 1)


@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_sharded_gram_matches_truth(data, ndev):
    m = SparseMatrix.from_scipy(data)
    mesh = make_mesh(ndev)
    res = sharded_gram_pca(m, mesh, n_components=5, seed=0)
    ev = np.asarray(res.explained_variance, np.float64)
    ev_ref = _truth(data, 5)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    T = np.asarray(res.transformed)
    assert T.shape == (data.shape[0], 5)
    # scores parity vs host projection
    D = data.toarray().astype(np.float64)
    Dc = D - D.mean(axis=0)
    T_ref = Dc @ np.asarray(res.components, np.float64).T
    assert np.abs(np.abs(T) - np.abs(T_ref)).max() < 1e-3 * np.abs(
        T_ref
    ).max()


def test_sharded_gram_mesh_invariance(data):
    m1 = SparseMatrix.from_scipy(data)
    m8 = SparseMatrix.from_scipy(data)
    r1 = sharded_gram_pca(m1, make_mesh(1), n_components=4, seed=3)
    r8 = sharded_gram_pca(m8, make_mesh(8), n_components=4, seed=3)
    np.testing.assert_allclose(
        np.asarray(r1.explained_variance),
        np.asarray(r8.explained_variance),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(r1.transformed),
        np.asarray(r8.transformed),
        rtol=1e-3, atol=1e-4,
    )


def test_sharded_gram_masked(data):
    m = SparseMatrix.from_scipy(data)
    p = data.shape[1]
    mask = np.zeros(p, bool)
    mask[::2] = True
    res = sharded_gram_pca(m, make_mesh(4), n_components=3, mask=mask, seed=1)
    assert np.asarray(res.components).shape == (3, int(mask.sum()))
    # equals PCA on the physically sliced matrix
    ev_ref = _truth(data[:, mask].tocsr(), 3)
    ev = np.asarray(res.explained_variance, np.float64)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    with pytest.raises(ValueError, match="mask vector length"):
        sharded_gram_pca(m, make_mesh(2), n_components=2, mask=mask[:-1])


def test_sharded_gram_uncentered(data):
    m = SparseMatrix.from_scipy(data)
    res = sharded_gram_pca(
        m, make_mesh(4), n_components=3, center=False, seed=2
    )
    s_ref = np.linalg.svd(
        data.toarray().astype(np.float64), compute_uv=False
    )
    ev_ref = s_ref[:3] ** 2 / (data.shape[0] - 1)
    ev = np.asarray(res.explained_variance, np.float64)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4


def test_sharded_gram_odd_slab_granularity():
    """n/ndev landing between 1024 and 8192 off the 1024 grid (slab=1280)
    stays exact."""

    X = cluster_counts(10_000, 60, n_clusters=4, seed=9).astype(np.float32)
    m = SparseMatrix.from_scipy(X)
    res = sharded_gram_pca(m, make_mesh(8), n_components=3, seed=0)
    ev = np.asarray(res.explained_variance, np.float64)
    ev_ref = _truth(X, 3)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    assert np.asarray(res.transformed).shape == (10_000, 3)


def test_sharded_gram_bucketed_payload_tracks_row_structure():
    """On power-law rows the bucketed payload must be far smaller than a
    single global-width layout (one dense row no longer multiplies the
    densify work of every row), and the engine must stay exact."""

    rng = np.random.default_rng(13)
    n, p = 4000, 96
    X = sp.random(
        n, p, density=0.02, format="csr", dtype=np.float32,
        random_state=rng, data_rvs=lambda s: rng.poisson(2, s) + 1.0,
    ).tolil()
    X[7] = rng.poisson(3, p) + 1.0  # one dense row
    X = X.tocsr().astype(np.float32)

    from single_algebra_tpu.parallel.gram import ShardedGram

    m = SparseMatrix.from_scipy(X)
    mesh = make_mesh(4)
    op = ShardedGram.from_matrix(m, mesh)
    assert len(op.bwidths) >= 2  # the dense row landed in its own class
    assert op.payload_bytes < 0.55 * op.unbucketed_payload_bytes, (
        op.payload_bytes, op.unbucketed_payload_bytes, op.bwidths,
    )

    res = sharded_gram_pca(m, mesh, n_components=3, seed=0)
    ev = np.asarray(res.explained_variance, np.float64)
    ev_ref = _truth(sp.csr_matrix(X), 3)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    # natural row order restored by the local gather
    D = X.toarray().astype(np.float64)
    Dc = D - D.mean(axis=0)
    T_ref = Dc @ np.asarray(res.components, np.float64).T
    T = np.asarray(res.transformed)
    assert np.abs(np.abs(T) - np.abs(T_ref)).max() < 1e-3 * np.abs(T_ref).max()


def test_sharded_gram_rejects_bad_slab(data):
    from single_algebra_tpu.parallel.gram import ShardedGram

    m = SparseMatrix.from_scipy(data)
    with pytest.raises(ValueError, match="slab"):
        ShardedGram.from_matrix(m, make_mesh(2), slab=0)
