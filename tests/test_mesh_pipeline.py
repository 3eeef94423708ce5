"""Mesh-sharded pipeline stages == single-device stages.

Every stage in ``parallel/pipeline.py`` is pinned against its
single-device counterpart on the virtual 8-device CPU mesh, plus
mesh-size invariance (1 vs 8 devices). The stages share one matrix
fixture (cluster counts: gapped structure, integer values)."""

import numpy as np
import pytest

from single_algebra_tpu import SparseMatrix
from single_algebra_tpu.de import _full_moments, rank_genes_groups
from single_algebra_tpu.feature_selection import highly_variable_genes
from single_algebra_tpu.parallel import ShardedSpMM, make_mesh
from single_algebra_tpu.parallel.pipeline import (
    mesh_col_moments,
    mesh_grouped_moments,
    mesh_highly_variable_genes,
    mesh_log1p,
    mesh_map_stored,
    mesh_normalize_total,
    mesh_qc_metrics,
    mesh_rank_genes_groups,
    mesh_row_stats,
    mesh_scale,
    mesh_sum_row_masked,
)
from single_algebra_tpu.preprocess import normalize_total, scale
from single_algebra_tpu.qc import calculate_qc_metrics

from tests.conftest import cluster_counts


@pytest.fixture(scope="module")
def data():
    X = cluster_counts(600, 120, n_clusters=8, seed=3).astype(np.float32)
    m = SparseMatrix.from_scipy(X)
    op = ShardedSpMM.from_matrix(m, make_mesh(8))
    return X, m, op


def _mesh_dense(op):
    """Materialize the sharded operator for equality checks: A @ I."""

    p = op.shape[1]
    return np.asarray(op.mv(np.eye(p, dtype=np.float32)))


# ----------------------------------------------------------------------
# stats
# ----------------------------------------------------------------------


def test_mesh_row_stats_match(data):
    X, m, op = data
    s, nz = mesh_row_stats(op)
    np.testing.assert_allclose(
        np.asarray(s), np.asarray(m.sum_row()), rtol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(nz), np.asarray(m.nonzero_row()))


def test_mesh_sum_row_masked_matches(data):
    X, m, op = data
    mask = np.zeros(X.shape[1], bool)
    mask[::3] = True
    np.testing.assert_allclose(
        np.asarray(mesh_sum_row_masked(op, mask)),
        np.asarray(m.sum_row_masked(mask)),
        rtol=1e-6,
    )
    with pytest.raises(ValueError, match="bool mask"):
        mesh_sum_row_masked(op, mask[:-1])


def test_mesh_col_moments_match(data):
    X, m, op = data
    mean, var = mesh_col_moments(op)
    n = X.shape[0]
    np.testing.assert_allclose(mean, np.asarray(m.sum_col()) / n, rtol=1e-6)
    np.testing.assert_allclose(
        var, np.asarray(m.var_col()), rtol=1e-5, atol=1e-8
    )


def test_mesh_qc_matches_single_device(data):
    X, m, op = data
    mito = np.zeros(X.shape[1], bool)
    mito[:7] = True
    obs_s, var_s = calculate_qc_metrics(m, qc_vars={"mito": mito})
    obs_m, var_m = mesh_qc_metrics(op, qc_vars={"mito": mito})
    assert set(obs_m) == set(obs_s) and set(var_m) == set(var_s)
    for k in obs_s:
        np.testing.assert_allclose(obs_m[k], obs_s[k], rtol=1e-6, atol=1e-9)
    for k in var_s:
        np.testing.assert_allclose(var_m[k], var_s[k], rtol=1e-6, atol=1e-9)


# ----------------------------------------------------------------------
# value transforms
# ----------------------------------------------------------------------


def test_mesh_normalize_log1p_matches(data):
    X, m, op = data
    m_n, sf_s = normalize_total(m, target_sum=1e4)
    m_nl = m_n.log1p_normalize()
    op_n, sf_m = mesh_normalize_total(op, target_sum=1e4)
    op_nl = mesh_log1p(op_n)
    np.testing.assert_allclose(sf_m, sf_s, rtol=1e-6)
    np.testing.assert_allclose(
        _mesh_dense(op_nl), np.asarray(m_nl.to_dense()), rtol=1e-5, atol=1e-6
    )
    # the transposed layout was rewritten consistently too (col sums ride it)
    mean_mesh, _ = mesh_col_moments(op_nl)
    np.testing.assert_allclose(
        mean_mesh, np.asarray(m_nl.sum_col()) / X.shape[0], rtol=1e-5,
    )


def test_mesh_normalize_median_default_and_zero_rows():
    import scipy.sparse as sp

    X = sp.csr_matrix(
        np.array(
            [[1, 0, 3], [0, 0, 0], [2, 2, 0], [0, 5, 0]], np.float32
        )
    )
    m = SparseMatrix.from_scipy(X)
    op = ShardedSpMM.from_matrix(m, make_mesh(4))
    m_n, sf_s = normalize_total(m)  # median target
    op_n, sf_m = mesh_normalize_total(op)
    np.testing.assert_allclose(sf_m, sf_s, rtol=1e-6)
    dense = _mesh_dense(op_n)
    np.testing.assert_allclose(
        dense, np.asarray(m_n.to_dense()), rtol=1e-6, atol=1e-7
    )
    assert not dense[1].any()  # zero-sum row untouched, not NaN


def test_mesh_scale_matches(data):
    X, m, op = data
    m_s = scale(m, zero_center=False, max_value=3.0)
    op_s = mesh_scale(op, max_value=3.0)
    np.testing.assert_allclose(
        _mesh_dense(op_s), np.asarray(m_s.to_dense()), rtol=1e-5, atol=1e-6
    )
    with pytest.raises(ValueError, match="zero_center"):
        mesh_scale(op, zero_center=True)


def test_mesh_map_stored_row_col_ids(data):
    X, m, op = data
    # fn depends on BOTH coordinates: catches id-plumbing mistakes in
    # either layout
    import jax.numpy as jnp

    fn = lambda v, r, c: v * (r + 1).astype(v.dtype) + 0.0 * c
    op2 = mesh_map_stored(op, fn)
    ref = X.toarray() * (np.arange(X.shape[0]) + 1)[:, None]
    np.testing.assert_allclose(_mesh_dense(op2), ref, rtol=1e-5)
    mean2, _ = mesh_col_moments(op2)
    np.testing.assert_allclose(
        mean2, ref.sum(0) / X.shape[0], rtol=1e-5
    )


# ----------------------------------------------------------------------
# HVG
# ----------------------------------------------------------------------


def test_mesh_hvg_matches(data):
    X, m, op = data
    m_n, _ = normalize_total(m, target_sum=1e4)
    m_nl = m_n.log1p_normalize()
    op_n, _ = mesh_normalize_total(op, target_sum=1e4)
    op_nl = mesh_log1p(op_n)
    hs = highly_variable_genes(m_nl, flavor="seurat", n_top_genes=25)
    hm = mesh_highly_variable_genes(op_nl, flavor="seurat", n_top_genes=25)
    np.testing.assert_array_equal(hm.mask, hs.mask)
    np.testing.assert_allclose(hm.means, hs.means, rtol=1e-5)
    # f32 moment noise is amplified by the per-bin standardization near
    # zero-dispersion bins — measured mesh-vs-single diff is ~5e-6 abs
    np.testing.assert_allclose(
        hm.dispersions_norm, hs.dispersions_norm, rtol=1e-4, atol=1e-5
    )
    with pytest.raises(ValueError, match="not supported on the mesh"):
        mesh_highly_variable_genes(op_nl, flavor="seurat_v3", n_top_genes=5)


# ----------------------------------------------------------------------
# grouped moments + DE
# ----------------------------------------------------------------------


def test_mesh_grouped_moments_match(data):
    X, m, op = data
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, X.shape[0]).astype(np.int32)
    sz_s, mean_s, var_s = _full_moments(m, codes, 5)
    sz_m, mean_m, var_m = mesh_grouped_moments(op, codes, 5)
    np.testing.assert_allclose(sz_m, sz_s)
    np.testing.assert_allclose(mean_m, mean_s, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(var_m, var_s, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method", ["t-test", "t-test_overestim_var"])
def test_mesh_rank_genes_groups_matches(data, method):
    X, m, op = data
    rng = np.random.default_rng(1)
    labels = [f"c{i}" for i in rng.integers(0, 4, X.shape[0])]
    rs = rank_genes_groups(m, labels, method=method, pts=True)
    rm = mesh_rank_genes_groups(op, labels, method=method, pts=True)
    assert set(rm.names) == set(rs.names)
    for g in rs.names:
        np.testing.assert_array_equal(rm.names[g], rs.names[g])
        np.testing.assert_allclose(
            rm.scores[g], rs.scores[g], rtol=1e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            rm.pvals[g], rs.pvals[g], rtol=1e-4, atol=1e-12
        )
        np.testing.assert_allclose(
            rm.logfoldchanges[g], rs.logfoldchanges[g], rtol=1e-4,
            atol=1e-6,
        )
        np.testing.assert_allclose(rm.pts[g], rs.pts[g], rtol=1e-6)


def test_mesh_de_rejects_entrywise_methods(data):
    _, _, op = data
    labels = ["a"] * 300 + ["b"] * 300
    for bad in ("wilcoxon", "logreg"):
        with pytest.raises(ValueError, match="not supported on the mesh"):
            mesh_rank_genes_groups(op, labels, method=bad)


# ----------------------------------------------------------------------
# mesh-size invariance
# ----------------------------------------------------------------------


def test_mesh_size_invariance(data):
    X, m, op8 = data
    op1 = ShardedSpMM.from_matrix(m, make_mesh(1))
    mean8, var8 = mesh_col_moments(op8)
    mean1, var1 = mesh_col_moments(op1)
    np.testing.assert_allclose(mean8, mean1, rtol=1e-6)
    np.testing.assert_allclose(var8, var1, rtol=1e-5, atol=1e-8)
    n8, sf8 = mesh_normalize_total(op8, target_sum=1e4)
    n1, sf1 = mesh_normalize_total(op1, target_sum=1e4)
    np.testing.assert_allclose(sf8, sf1, rtol=1e-6)
    np.testing.assert_allclose(
        _mesh_dense(n8), _mesh_dense(n1), rtol=1e-6, atol=1e-7
    )
