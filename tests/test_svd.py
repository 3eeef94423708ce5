"""SVD engine tests: randomized + Lanczos vs numpy/sklearn goldens.

The reference has no SVD tests at all (single-svdlib is external); these
encode the accuracy bars SURVEY.md §7 prescribes: Lanczos near machine
precision on dense-able problems, randomized at sklearn's accuracy class,
svd_flip bit-matching sklearn's convention.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import SparseMatrix
from single_algebra_tpu.linalg import (
    CenteredOperator,
    DenseOperator,
    MaskedOperator,
    SparseOperator,
    lanczos_svd,
    randomized_svd,
    svd_flip,
)
from single_algebra_tpu.types import PowerIterationNormalizer as PIN


def make_problem(n=300, p=120, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    X = sp.random(
        n, p, density=density, format="csr", dtype=np.float64,
        random_state=rng, data_rvs=rng.random,
    )
    return X, SparseOperator.from_matrix(
        SparseMatrix.from_scipy(X, dtype=np.float64)
    )


def test_lanczos_machine_precision():
    X, op = make_problem()
    s_ref = np.linalg.svd(X.toarray(), compute_uv=False)
    res = lanczos_svd(op, 10, seed=1)
    np.testing.assert_allclose(np.asarray(res.s), s_ref[:10], rtol=1e-10)
    # residual check: A v = s u for each triplet
    for i in range(10):
        r = X @ np.asarray(res.vt)[i] - np.asarray(res.s)[i] * np.asarray(res.u)[:, i]
        assert np.linalg.norm(r) < 1e-8


def test_randomized_matches_sklearn_class():
    from sklearn.utils.extmath import randomized_svd as sk_rsvd

    X, op = make_problem()
    s_ref = np.linalg.svd(X.toarray(), compute_uv=False)
    _, s_sk, _ = sk_rsvd(
        X, n_components=10, n_oversamples=10, n_iter=7,
        power_iteration_normalizer="QR", random_state=0,
    )
    res = randomized_svd(op, 10, 10, 7, PIN.QR, seed=42)
    ours = np.abs(np.asarray(res.s) - s_ref[:10]).max()
    theirs = np.abs(s_sk - s_ref[:10]).max()
    assert ours < max(2.5 * theirs, 1e-8)
    # top singular value is always sharp
    np.testing.assert_allclose(np.asarray(res.s)[0], s_ref[0], rtol=1e-8)


@pytest.mark.parametrize("normalizer", [PIN.QR, PIN.LU, PIN.NONE])
def test_normalizers_run(normalizer):
    X, op = make_problem(n=120, p=80)
    s_ref = np.linalg.svd(X.toarray(), compute_uv=False)
    res = randomized_svd(op, 5, 10, 2, normalizer, seed=3)
    np.testing.assert_allclose(np.asarray(res.s)[0], s_ref[0], rtol=1e-4)


def test_centered_operator_svd():
    X, op = make_problem()
    mu = np.asarray(X.mean(axis=0)).ravel()
    cop = CenteredOperator(op, mu)
    res = lanczos_svd(cop, 8, seed=2)
    s_ref = np.linalg.svd(X.toarray() - mu[None, :], compute_uv=False)
    np.testing.assert_allclose(np.asarray(res.s), s_ref[:8], rtol=1e-9)


def test_masked_operator_equals_sliced():
    X, op = make_problem()
    rng = np.random.default_rng(7)
    mask = rng.random(X.shape[1]) < 0.5
    idx = np.where(mask)[0].astype(np.int32)
    mop = MaskedOperator(op, idx)
    assert mop.shape == (X.shape[0], int(mask.sum()))
    res = lanczos_svd(mop, 6, seed=2)
    s_ref = np.linalg.svd(X.toarray()[:, mask], compute_uv=False)
    np.testing.assert_allclose(np.asarray(res.s), s_ref[:6], rtol=1e-9)
    # product parity
    B = rng.standard_normal((int(mask.sum()), 4))
    np.testing.assert_allclose(
        np.asarray(mop.mv(B)), X.toarray()[:, mask] @ B, rtol=1e-10
    )
    C = rng.standard_normal((X.shape[0], 4))
    np.testing.assert_allclose(
        np.asarray(mop.rmv(C)), X.toarray()[:, mask].T @ C, rtol=1e-10
    )


def test_svd_flip_matches_sklearn():
    from sklearn.utils.extmath import svd_flip as sk_flip

    rng = np.random.default_rng(3)
    u = rng.standard_normal((40, 6))
    vt = rng.standard_normal((6, 25))
    for ubd in (False, True):
        ju, jvt = svd_flip(u, vt, u_based_decision=ubd)
        su, svt = sk_flip(u.copy(), vt.copy(), u_based_decision=ubd)
        np.testing.assert_allclose(np.asarray(ju), su)
        np.testing.assert_allclose(np.asarray(jvt), svt)


def test_dense_operator():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((60, 40))
    res = lanczos_svd(DenseOperator(A), 5, seed=0)
    s_ref = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(np.asarray(res.s), s_ref[:5], rtol=1e-10)


def test_seed_reproducibility():
    _, op = make_problem(n=100, p=60)
    r1 = randomized_svd(op, 5, 10, 3, PIN.QR, seed=123)
    r2 = randomized_svd(op, 5, 10, 3, PIN.QR, seed=123)
    np.testing.assert_array_equal(np.asarray(r1.s), np.asarray(r2.s))
    r3 = randomized_svd(op, 5, 10, 3, PIN.QR, seed=124)
    assert not np.array_equal(np.asarray(r1.u), np.asarray(r3.u))


def test_lanczos_adaptive_converges_where_short_budget_fails():
    """Convergence-adaptive mode (tol -> while_loop with a Ritz
    stabilization test, las2's kappa analog) reaches machine precision
    without hand-tuning steps, on a spectrum where a tight fixed budget
    visibly under-converges."""

    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    X = sp.random(900, 700, density=0.08, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random)
    m = SparseMatrix.from_scipy(X, dtype=np.float64)
    op = SparseOperator.from_matrix(m)
    k = 12
    s_ref = np.linalg.svd(X.toarray(), compute_uv=False)[:k]

    short = lanczos_svd(op, k, steps=32, seed=1)
    err_short = (np.abs(np.asarray(short.s) - s_ref) / s_ref).max()
    assert err_short > 1e-2  # fixed short budget demonstrably insufficient

    adaptive = lanczos_svd(op, k, seed=1, tol=1e-8)
    err_ad = (np.abs(np.asarray(adaptive.s) - s_ref) / s_ref).max()
    assert err_ad < 1e-10


def test_lanczos_adaptive_handles_krylov_exhaustion():
    """Budget past min_dim: the while_loop must stop on beta underflow
    (Krylov-space exhaustion) and still return exact values."""

    rng = np.random.default_rng(4)
    A = rng.standard_normal((40, 30))
    res = lanczos_svd(DenseOperator(A), 5, seed=0, tol=1e-8)
    s_ref = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(np.asarray(res.s), s_ref[:5], rtol=1e-10)


def test_pca_lanczos_tolerance_flows_through():
    """SparsePCA's (previously parity-only) tolerance field drives the
    adaptive Lanczos loop; default tolerance converges without a manual
    lanczos_steps."""

    import scipy.sparse as sp

    from single_algebra_tpu.models import SparsePCABuilder
    from single_algebra_tpu.types import SVDMethod

    rng = np.random.default_rng(2)
    X = sp.random(500, 350, density=0.1, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random)
    pca = SparsePCABuilder().n_components(8).svd_method(
        SVDMethod.lanczos()
    ).build()
    pca.fit(X)
    # Lanczos-path semantics: truncated SVD of RAW X (no centering)
    s_ref = np.linalg.svd(X.toarray(), compute_uv=False)[:8]
    ev_ref = s_ref**2 / (X.shape[0] - 1)
    np.testing.assert_allclose(
        np.asarray(pca.explained_variance_), ev_ref, rtol=1e-8
    )
