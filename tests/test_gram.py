"""Gram-engine tests.

The Gram path is an EXACT PCA (eigendecomposition of A^T A restricted to
the top-k subspace), so its parity bar against sklearn's full SVD is
tighter than the randomized path's.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import SparseMatrix
from single_algebra_tpu.linalg import GramPCAEngine, gram_matrix
from single_algebra_tpu.models import MaskedSparsePCABuilder, SparsePCABuilder
from single_algebra_tpu.types import PowerIterationNormalizer as PIN, SVDMethod

from tests.conftest import cluster_counts


@pytest.fixture(scope="module")
def counts():
    X = cluster_counts(600, 140, n_clusters=8, seed=3).astype(np.float32)
    return X, SparseMatrix.from_scipy(X)


def test_gram_matrix_matches_dense(counts):
    X, m = counts
    eng = GramPCAEngine.from_matrix(m)
    G = np.asarray(gram_matrix(eng))
    p = X.shape[1]
    ref = X.toarray().T @ X.toarray()
    assert np.abs(G[:p, :p] - ref).max() / np.abs(ref).max() < 1e-5
    assert not G[p:].any() and not G[:, p:].any()


@pytest.mark.parametrize("exact_vals", [True, False])
def test_gram_symmetric_blocked_matches_full(exact_vals):
    # pp > 4096 engages the symmetric-half blocked contraction (2048-row
    # blocks, lower-triangular pairs + mirror); small shapes take the
    # single full dot, so this wide fixture is the only coverage it gets
    rng = np.random.default_rng(11)
    X = sp.random(
        1500, 4500, density=0.01, format="csr", dtype=np.float64,
        random_state=rng,
    )
    if exact_vals:
        X.data = np.round(X.data * 7)  # small ints: bf16-exact path
    X = X.astype(np.float32)
    m = SparseMatrix.from_scipy(X)
    eng = GramPCAEngine.from_matrix(m)
    assert eng.p_padded > 4096  # guard: the sym path is actually engaged
    G_sym = np.asarray(gram_matrix(eng))
    G_full = np.asarray(gram_matrix(eng, sym=False))
    scale = max(np.abs(G_full).max(), 1e-30)
    assert np.abs(G_sym - G_full).max() / scale < 1e-6
    assert np.abs(G_sym - G_sym.T).max() / scale < 1e-6
    p = X.shape[1]
    ref = (X.T @ X).toarray()
    assert np.abs(G_sym[:p, :p] - ref).max() / scale < 1e-5


def test_gram_products(counts):
    X, m = counts
    eng = GramPCAEngine.from_matrix(m)
    rng = np.random.default_rng(0)
    B = rng.standard_normal((X.shape[1], 5)).astype(np.float32)
    C = rng.standard_normal((X.shape[0], 5)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(eng.mv(B)), X @ B, rtol=1e-4,
        atol=1e-4 * np.abs(X @ B).max(),
    )
    np.testing.assert_allclose(
        np.asarray(eng.rmv(C)), X.T @ C, rtol=1e-4,
        atol=1e-4 * np.abs(X.T @ C).max(),
    )


def test_gram_pca_matches_sklearn_full(counts):
    from sklearn.decomposition import PCA as SkPCA

    X, m = counts
    pca = (
        SparsePCABuilder().n_components(6)
        .svd_method(SVDMethod.random(10, 7, PIN.QR))
        .engine("gram").build()
    )
    T = np.asarray(pca.fit_transform(m))
    sk = SkPCA(n_components=6, svd_solver="full").fit(X.toarray())
    rel = (
        np.abs(np.asarray(pca.explained_variance_) - sk.explained_variance_)
        / sk.explained_variance_
    )
    assert rel[:5].max() < 1e-5
    np.testing.assert_allclose(
        T[:, :5], sk.transform(X.toarray())[:, :5],
        rtol=5e-3, atol=1e-3 * np.abs(T).max(),
    )


def test_gram_lanczos_semantics_uncentered(counts):
    """Lanczos + gram = truncated SVD of RAW X with centered projection
    (reference semantics, SURVEY.md §3.2)."""

    X, m = counts
    pca = (
        SparsePCABuilder().n_components(5)
        .svd_method(SVDMethod.lanczos()).engine("gram").build()
    )
    pca.fit(m)
    s_ref = np.linalg.svd(X.toarray(), compute_uv=False)[:5]
    ev_ref = s_ref**2 / (X.shape[0] - 1)
    np.testing.assert_allclose(
        np.asarray(pca.explained_variance_), ev_ref, rtol=1e-5
    )


def test_gram_masked_submatrix(counts):
    """Masked gram PCA (submatrix of the cached G) == masked PCA on the
    sparse path."""

    X, m = counts
    rng = np.random.default_rng(1)
    mask = rng.random(X.shape[1]) < 0.4
    mask[:3] = True
    method = SVDMethod.random(8, 6, PIN.QR)
    g = (
        MaskedSparsePCABuilder().mask(mask).n_components(4)
        .svd_method(method).engine("gram").build()
    )
    Tg = np.asarray(g.fit_transform(m))
    s = (
        MaskedSparsePCABuilder().mask(mask).n_components(4)
        .svd_method(method).engine("sparse").build()
    )
    Ts = np.asarray(s.fit_transform(m))
    np.testing.assert_allclose(
        np.asarray(g.explained_variance_),
        np.asarray(s.explained_variance_),
        rtol=1e-4,
    )
    np.testing.assert_allclose(Tg, Ts, rtol=1e-3, atol=1e-3 * np.abs(Ts).max())


def test_gram_cache_reused(counts):
    _, m = counts
    eng = GramPCAEngine.from_matrix(m)
    g1 = eng.gram_cached()
    g2 = eng.gram_cached()
    assert g1 is g2


def test_gram_inexact_values_f32_path():
    """Non-bf16-exact values force the f32 densify + HIGHEST contraction."""

    rng = np.random.default_rng(7)
    X = sp.random(300, 90, density=0.2, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random).astype(np.float32)
    m = SparseMatrix.from_scipy(X)
    eng = GramPCAEngine.from_matrix(m)
    assert eng.meta[3] is False or eng.meta[3] == False  # noqa: E712
    G = np.asarray(gram_matrix(eng))
    ref = X.toarray().T @ X.toarray()
    assert np.abs(G[:90, :90] - ref).max() / np.abs(ref).max() < 1e-6


def test_gram_int8_path_exact():
    """Integer values in [-127, 127] gate the int8 Gram tier, whose
    slab products are bit-exact (int8 x int8 -> int32); the whole Gram
    must match the f64 reference exactly up to f32 cross-slab rounding —
    at this size, one slab, so exactly."""

    rng = np.random.default_rng(5)
    X = sp.random(
        700, 200, density=0.08, format="csr", dtype=np.float32,
        random_state=rng,
        data_rvs=lambda s: rng.integers(1, 127, s).astype(np.float32),
    )
    m = SparseMatrix.from_scipy(X)
    assert m.values_int8_exact()
    eng = GramPCAEngine.from_matrix(m)
    assert eng.meta[4] is True
    G = np.asarray(gram_matrix(eng))
    ref = (X.astype(np.float64).T @ X.astype(np.float64)).toarray()
    assert np.abs(G[:200, :200] - ref).max() == 0.0


def test_gram_int8_gate_rejects():
    """Values > 127 or non-integers fall back off the int8 path (bf16 /
    f32 engines) and the result is still correct."""

    rng = np.random.default_rng(6)
    base = sp.random(
        300, 80, density=0.1, format="csr", dtype=np.float32,
        random_state=rng,
        data_rvs=lambda s: rng.integers(1, 100, s).astype(np.float32),
    )
    big = base.copy()
    big.data[0] = 200.0  # > 127: still bf16-exact, not int8
    frac = base.copy()
    frac.data = frac.data + 0.5  # non-integer
    for Xv, want_i8 in ((big, False), (frac, False)):
        m = SparseMatrix.from_scipy(Xv)
        assert m.values_int8_exact() is want_i8
        eng = GramPCAEngine.from_matrix(m)
        assert eng.meta[4] is want_i8
        G = np.asarray(gram_matrix(eng))
        ref = (Xv.astype(np.float64).T @ Xv.astype(np.float64)).toarray()
        scale = np.abs(ref).max()
        assert np.abs(G[:80, :80] - ref).max() / scale < 1e-5


def test_gram_warns_on_ignored_lanczos_knobs(counts):
    """engine='gram' maps Lanczos to the exact solve — tuning
    lanczos_steps/lanczos_block there must emit a signal, not silence."""

    import warnings

    X, m = counts
    pca = (
        SparsePCABuilder().n_components(4)
        .svd_method(SVDMethod.lanczos())
        .lanczos_steps(64).engine("gram").build()
    )
    with pytest.warns(UserWarning, match="lanczos_steps"):
        pca.fit(m)

    # no knobs tuned -> no warning; randomized method -> no warning
    for builder in (
        SparsePCABuilder().n_components(4)
        .svd_method(SVDMethod.lanczos()).engine("gram"),
        SparsePCABuilder().n_components(4)
        .svd_method(SVDMethod.random(10, 7, PIN.QR))
        .lanczos_steps(64).engine("gram"),
    ):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            builder.build().fit(m)

    # masked surface warns too
    mask = np.zeros(X.shape[1], bool)
    mask[:100] = True
    mpca = (
        MaskedSparsePCABuilder().n_components(4).mask(mask)
        .svd_method(SVDMethod.lanczos())
        .lanczos_block(8).engine("gram").build()
    )
    with pytest.warns(UserWarning, match="lanczos_block"):
        mpca.fit(m)


def test_large_gram_solve_accuracy_floor():
    """The randomized large-Gram path (pp > EIGH_MAX_PP) must resolve a
    gapped top-k to the f32 floor: oversamples/iters are minimums, so a
    bare k+10 sketch can no longer leave ~1e-3 Rayleigh-Ritz leakage
    (caught at the wide flagship shape in r3)."""

    import jax
    import jax.numpy as jnp

    from single_algebra_tpu.linalg.gram import _solve_topk, EIGH_MAX_PP

    rng = np.random.default_rng(1)
    pp, k, n = EIGH_MAX_PP + 512, 30, 50_000
    r = pp // 8
    Q, _ = np.linalg.qr(rng.standard_normal((pp, r)))
    w = np.concatenate(
        [np.geomspace(30, 3, 40), np.abs(rng.standard_normal(r - 40))]
    )
    G = ((Q * w) @ Q.T * n).astype(np.float32)
    ev_ref = np.sort(w)[::-1][:k] * n / (n - 1)

    @jax.jit
    def solve(G, mu, n_, seed):
        return _solve_topk(
            G, mu, n_, seed, k=k, center=False, oversamples=10, iters=6
        )

    s, _vt = solve(
        jnp.asarray(G), jnp.zeros(pp, jnp.float32), jnp.asarray(n), 0
    )
    ev = np.asarray(s, np.float64) ** 2 / (n - 1)
    err = np.abs(ev - ev_ref).max() / ev_ref[0]
    assert err < 5e-6, err
