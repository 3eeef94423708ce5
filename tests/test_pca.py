"""PCA parity tests vs sklearn + reference-semantic tests.

Covers what the reference's suite never did (its only PCA test asserts
``fit().is_ok()`` on a stress shape, src/dimred/pca/sparse/mod.rs:540-562):
golden-value parity against sklearn PCA, masked-vs-sliced equivalence,
the Lanczos-does-not-center semantic, builder defaults, and persistence.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu.models import (
    MaskedSparsePCA,
    MaskedSparsePCABuilder,
    SparsePCA,
    SparsePCABuilder,
)
from single_algebra_tpu.types import PowerIterationNormalizer as PIN
from single_algebra_tpu.types import SVDMethod


from tests.conftest import cluster_counts


RAND = SVDMethod.random(10, 7, PIN.QR)


@pytest.fixture(scope="module")
def data():
    return cluster_counts(800, 300, n_clusters=16, seed=1)


def test_randomized_pca_explained_variance_parity(data):
    from sklearn.decomposition import PCA as SkPCA

    pca = SparsePCABuilder().n_components(10).svd_method(RAND).build()
    pca.fit(data)
    sk = SkPCA(n_components=10, svd_solver="full").fit(data.toarray())
    rel = (
        np.abs(np.asarray(pca.explained_variance_) - sk.explained_variance_)
        / sk.explained_variance_
    )
    # the BASELINE bar: explained-variance parity <= 1e-6 on well-separated
    # signal directions (16 clusters -> ~15; the last computed components sit
    # at the bulk edge where no solver pins them to 1e-6)
    assert rel[:8].max() < 1e-6
    assert rel.max() < 1e-4
    # total variance matches the exact dense computation
    total = data.toarray().var(0, ddof=1).sum()
    np.testing.assert_allclose(pca.total_variance_, total, rtol=1e-10)


def test_randomized_pca_transform_parity(data):
    from sklearn.decomposition import PCA as SkPCA

    k = 5
    pca = SparsePCABuilder().n_components(k).svd_method(RAND).build()
    T = np.asarray(pca.fit_transform(data))
    sk = SkPCA(n_components=k, svd_solver="full").fit(data.toarray())
    Tsk = sk.transform(data.toarray())
    # svd_flip on both sides -> signs must agree, not just magnitudes
    np.testing.assert_allclose(T, Tsk, rtol=1e-4, atol=1e-6 * np.abs(Tsk).max())


def test_lanczos_is_uncentered_svd(data):
    """Reference semantic: Lanczos path = truncated SVD of RAW X, even with
    center=true; the mean only enters at transform time (SURVEY §3.2)."""

    k = 6
    pca = SparsePCABuilder().n_components(k).build()  # default Lanczos
    T = np.asarray(pca.fit_transform(data))

    dense = data.toarray()
    u, s, vt = np.linalg.svd(dense, full_matrices=False)
    # explained variance from RAW singular values
    np.testing.assert_allclose(
        np.asarray(pca.explained_variance_),
        s[:k] ** 2 / (dense.shape[0] - 1),
        rtol=1e-8,
    )
    # transform subtracts the mean despite the uncentered fit
    from sklearn.utils.extmath import svd_flip as sk_flip

    _, vt_f = sk_flip(
        u[:, :k].copy(), vt[:k].copy(), u_based_decision=False
    )
    expected = (dense - dense.mean(0)) @ vt_f.T
    np.testing.assert_allclose(T, expected, rtol=1e-6, atol=1e-8)


def test_uncentered_pca(data):
    pca = (
        SparsePCABuilder()
        .n_components(4)
        .center(False)
        .svd_method(RAND)
        .build()
    )
    T = np.asarray(pca.fit_transform(data))
    dense = data.toarray()
    s = np.linalg.svd(dense, compute_uv=False)
    np.testing.assert_allclose(
        np.asarray(pca.explained_variance_),
        s[:4] ** 2 / (dense.shape[0] - 1),
        rtol=1e-6,
    )
    # mean_ must be feature-width zeros (reference bug: zeros(n_samples))
    assert np.asarray(pca.mean_).shape == (dense.shape[1],)
    assert np.all(np.asarray(pca.mean_) == 0)


def test_ratio_semantics(data):
    """Reference: ratios normalize over computed components and sum to 1
    (sparse/mod.rs:312-322)."""

    pca = SparsePCABuilder().n_components(6).svd_method(RAND).build()
    pca.fit(data)
    ratios = np.asarray(pca.explained_variance_ratio())
    np.testing.assert_allclose(ratios.sum(), 1.0, rtol=1e-12)
    cum = np.asarray(pca.cumulative_explained_variance_ratio())
    np.testing.assert_allclose(cum, np.cumsum(ratios), rtol=1e-12)
    fi = np.asarray(pca.feature_importances())
    assert fi.shape == (6, data.shape[1])
    np.testing.assert_allclose(
        fi, np.asarray(pca.components_) ** 2, rtol=1e-12
    )


def test_unfitted_errors(data):
    pca = SparsePCABuilder().build()
    with pytest.raises(RuntimeError, match="fitted"):
        pca.transform(data)
    with pytest.raises(RuntimeError, match="fitted"):
        pca.feature_importances()


def test_masked_pca_equals_sliced(data):
    """Masked PCA == PCA on the physically sliced matrix (the equivalence
    the reference never tests)."""

    from sklearn.decomposition import PCA as SkPCA

    rng = np.random.default_rng(3)
    mask = rng.random(data.shape[1]) < 0.5
    k = 5
    mp = (
        MaskedSparsePCABuilder()
        .mask(mask)
        .n_components(k)
        .svd_method(RAND)
        .build()
    )
    T = np.asarray(mp.fit_transform(data))
    sliced = data.toarray()[:, mask]
    sk = SkPCA(n_components=k, svd_solver="full").fit(sliced)
    rel = (
        np.abs(np.asarray(mp.explained_variance_) - sk.explained_variance_)
        / sk.explained_variance_
    )
    assert rel[:4].max() < 1e-6
    np.testing.assert_allclose(
        T[:, :4],
        sk.transform(sliced)[:, :4],
        rtol=1e-4,
        atol=1e-5 * np.abs(T).max(),
    )
    # components_ is k x p_masked; mean_ is FULL width (reference semantic)
    assert np.asarray(mp.components_).shape == (k, int(mask.sum()))
    assert np.asarray(mp.mean_).shape == (data.shape[1],)


def test_masked_lanczos(data):
    rng = np.random.default_rng(4)
    mask = rng.random(data.shape[1]) < 0.6
    mp = MaskedSparsePCABuilder().mask(mask).n_components(4).build()
    mp.fit(data)
    s_ref = np.linalg.svd(data.toarray()[:, mask], compute_uv=False)
    np.testing.assert_allclose(
        np.asarray(mp.explained_variance_),
        s_ref[:4] ** 2 / (data.shape[0] - 1),
        rtol=1e-8,
    )


def test_masked_mask_validation(data):
    mp = MaskedSparsePCABuilder().mask([True] * 10).n_components(2).build()
    with pytest.raises(ValueError, match="mask vector length"):
        mp.fit(data)
    with pytest.raises(ValueError, match="requires a mask"):
        MaskedSparsePCABuilder().build()


def test_builder_defaults():
    pca = SparsePCABuilder().build()
    assert pca.n_components == 50
    assert pca.alpha == 1.0
    assert pca.tolerance == 1e-6
    assert pca.random_seed == 42
    assert pca.center is True
    assert pca.verbose is False
    assert not pca.svd_method.is_random  # Lanczos default


def test_save_load(tmp_path, data):
    pca = SparsePCABuilder().n_components(4).svd_method(RAND).build()
    T = np.asarray(pca.fit_transform(data))
    path = str(tmp_path / "pca.npz")
    pca.save(path)
    loaded = SparsePCA.load(path)
    np.testing.assert_allclose(
        np.asarray(loaded.transform(data)), T, rtol=1e-10
    )

    rng = np.random.default_rng(5)
    mask = rng.random(data.shape[1]) < 0.5
    mp = (
        MaskedSparsePCABuilder()
        .mask(mask)
        .n_components(3)
        .svd_method(RAND)
        .build()
    )
    Tm = np.asarray(mp.fit_transform(data))
    mpath = str(tmp_path / "mpca.npz")
    mp.save(mpath)
    mloaded = MaskedSparsePCA.load(mpath)
    np.testing.assert_allclose(
        np.asarray(mloaded.transform(data)), Tm, rtol=1e-10
    )


def test_seed_determinism(data):
    a = SparsePCABuilder().n_components(4).svd_method(RAND).random_seed(7).build()
    b = SparsePCABuilder().n_components(4).svd_method(RAND).random_seed(7).build()
    np.testing.assert_array_equal(
        np.asarray(a.fit_transform(data)), np.asarray(b.fit_transform(data))
    )


def test_csc_input(data):
    from single_algebra_tpu import SparseMatrix

    mc = SparseMatrix.from_scipy(data.tocsc(), fmt="csc")
    pca = SparsePCABuilder().n_components(4).svd_method(RAND).build()
    T_csc = np.asarray(pca.fit_transform(mc))
    pca2 = SparsePCABuilder().n_components(4).svd_method(RAND).build()
    T_csr = np.asarray(pca2.fit_transform(data))
    np.testing.assert_allclose(T_csc, T_csr, rtol=1e-8, atol=1e-10)


def test_tiled_engine_matches_sparse(data):
    """The tiled engine reproduces the sparse-engine PCA."""

    a = SparsePCABuilder().n_components(4).svd_method(RAND).engine("sparse").build()
    b = SparsePCABuilder().n_components(4).svd_method(RAND).engine("tiled").build()
    Xf = data.astype(np.float32)
    Ta = np.asarray(a.fit_transform(Xf))
    Tb = np.asarray(b.fit_transform(Xf))
    np.testing.assert_allclose(Ta, Tb, rtol=1e-3, atol=1e-3 * np.abs(Ta).max())
    np.testing.assert_allclose(
        np.asarray(a.explained_variance_),
        np.asarray(b.explained_variance_),
        rtol=1e-4,
    )


def test_transform_new_data(data):
    """transform() on data NOT seen at fit time (builds its own operator)."""

    from tests.conftest import cluster_counts

    pca = SparsePCABuilder().n_components(4).svd_method(RAND).build()
    pca.fit(data)
    new = cluster_counts(100, data.shape[1], n_clusters=4, seed=9)
    T = np.asarray(pca.transform(new))
    expected = (new.toarray() - np.asarray(pca.mean_)) @ np.asarray(
        pca.components_
    ).T
    np.testing.assert_allclose(T, expected, rtol=1e-6, atol=1e-8)


def test_verbose_output(data, capsys):
    """Verbose mode emits the reference-style stage logs
    (sparse/mod.rs:146-168, sparse_masked/mod.rs:276-289)."""

    pca = (
        SparsePCABuilder().n_components(3).svd_method(RAND).verbose(True).build()
    )
    pca.fit(data)
    out = capsys.readouterr().out
    assert "randomized" in out and "Reduced to: 3 components" in out
    assert "noise variance" in out

    rng = np.random.default_rng(0)
    mask = rng.random(data.shape[1]) < 0.5
    mp = (
        MaskedSparsePCABuilder()
        .mask(mask)
        .n_components(3)
        .verbose(True)
        .build()
    )
    mp.fit(data)
    out = capsys.readouterr().out
    assert "PCA | SparseMasked" in out
    assert "Total variance explained" in out


def test_uncentered_ratio_uses_computed_sum(data):
    """No-center path: total variance falls back to the computed
    components' sum (reference sparse/mod.rs:218-223)."""

    pca = (
        SparsePCABuilder().n_components(4).center(False).svd_method(RAND).build()
    )
    pca.fit(data)
    assert np.isclose(
        pca.total_variance_,
        float(np.asarray(pca.explained_variance_).sum()),
        rtol=1e-6,
    )


def test_save_load_without_npz_suffix(tmp_path, data):
    from single_algebra_tpu.models import SparsePCA

    pca = SparsePCA(n_components=3, svd_method=__import__(
        "single_algebra_tpu").types.SVDMethod.random(4, 4)
    )
    pca.fit(data)
    path = str(tmp_path / "model")  # no .npz
    pca.save(path)
    back = SparsePCA.load(path)
    import numpy as np
    np.testing.assert_allclose(
        np.asarray(back.components_), np.asarray(pca.components_)
    )


def test_inverse_transform_roundtrip(data):
    """inverse_transform matches sklearn's reconstruction and converges
    to the data as k grows."""

    from sklearn.decomposition import PCA as SkPCA

    pca = SparsePCABuilder().n_components(20).svd_method(RAND).build()
    T = np.asarray(pca.fit_transform(data))
    R = np.asarray(pca.inverse_transform(T))
    assert R.shape == data.shape
    dense = data.toarray()
    sk = SkPCA(n_components=20, svd_solver="full").fit(dense)
    R_sk = sk.inverse_transform(sk.transform(dense))
    # the rank-20 PCA reconstruction is the optimal one; ours must match
    # sklearn's error (element-wise comparison is ill-posed: tail
    # components beyond the cluster gap live in a noise bulk where the
    # subspace is not unique)
    err = np.linalg.norm(R - dense)
    err_sk = np.linalg.norm(R_sk - dense)
    assert err <= 1.02 * err_sk
    # reconstruction error shrinks with k
    pca5 = SparsePCABuilder().n_components(5).svd_method(RAND).build()
    R5 = np.asarray(pca5.inverse_transform(np.asarray(pca5.fit_transform(data))))
    assert err < np.linalg.norm(R5 - dense)


def test_inverse_transform_uncentered(data):
    pca = (
        SparsePCABuilder().n_components(8).svd_method(RAND)
        .center(False).build()
    )
    T = np.asarray(pca.fit_transform(data))
    R = np.asarray(pca.inverse_transform(T))
    # uncentered: R = T @ V exactly
    np.testing.assert_allclose(
        R, T @ np.asarray(pca.components_), rtol=1e-5, atol=1e-5
    )


def test_masked_inverse_transform(data):
    mask = np.zeros(data.shape[1], bool)
    mask[::3] = True
    pca = MaskedSparsePCABuilder().mask(mask).n_components(10).svd_method(
        RAND
    ).build()
    T = np.asarray(pca.fit_transform(data))
    R = np.asarray(pca.inverse_transform(T))
    assert R.shape == data.shape
    dense = data.toarray()
    mu = dense.mean(axis=0)
    # unmasked columns reconstruct as their mean
    np.testing.assert_allclose(R[:, ~mask], np.broadcast_to(
        mu[~mask], (data.shape[0], (~mask).sum())), rtol=1e-4, atol=1e-4)
    # masked columns: sklearn PCA on the sliced matrix gives the same
    # reconstruction
    from sklearn.decomposition import PCA as SkPCA

    sk = SkPCA(n_components=10, svd_solver="full").fit(dense[:, mask])
    R_sk = sk.inverse_transform(sk.transform(dense[:, mask]))
    np.testing.assert_allclose(
        R[:, mask], R_sk, atol=5e-3 * np.abs(dense).max()
    )


def test_dense_engine_on_value_mapped_matrix():
    """A matrix whose values live only on device (map_stored output)
    must feed the densified engine through the DEVICE densify+split
    path (host densify would pull the payload through the host link)
    and produce the same fit as the host-built equivalent."""

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.linalg.operators import DensifiedOperator

    X = cluster_counts(3000, 400, seed=11)
    m = SparseMatrix.from_scipy(sp.csr_matrix(X))
    logged = m.log1p_normalize()
    assert logged._h_data is None  # device-only values

    op = DensifiedOperator.from_matrix(logged)
    assert op.lo is not None  # log1p output is not bf16-exact
    ref = SparseMatrix.from_scipy(sp.csr_matrix(np.log1p(X)))
    op_ref = DensifiedOperator.from_matrix(ref)
    np.testing.assert_allclose(
        np.asarray(op.hi, np.float32),
        np.asarray(op_ref.hi, np.float32),
        rtol=0,
        atol=0,
    )
    s1, q1 = [np.asarray(a) for a in op.col_stats()]
    s2, q2 = [np.asarray(a) for a in op_ref.col_stats()]
    np.testing.assert_allclose(s1, s2, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(q1, q2, rtol=1e-6, atol=1e-4)

    fit1 = (
        SparsePCABuilder()
        .n_components(8)
        .svd_method(SVDMethod.random(10, 7))
        .engine("dense")
        .build()
        .fit(logged)
    )
    fit2 = (
        SparsePCABuilder()
        .n_components(8)
        .svd_method(SVDMethod.random(10, 7))
        .engine("dense")
        .build()
        .fit(ref)
    )
    np.testing.assert_allclose(
        fit1.explained_variance_,
        fit2.explained_variance_,
        rtol=1e-5,
    )


def test_dense_engine_device_path_bf16_exact_drops_lo():
    """Raw counts survive bf16; the device path must detect that with
    its on-device reduction and drop lo, matching the host path."""

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.linalg.operators import DensifiedOperator

    X = cluster_counts(500, 200, seed=3)
    m = SparseMatrix.from_scipy(sp.csr_matrix(X))
    # identity map: values unchanged (ints), but host copy is dropped
    mapped = m.map_stored(lambda v, r, c: v * 1.0)
    assert mapped._h_data is None
    op = DensifiedOperator.from_matrix(mapped)
    assert op.lo is None
    op_ref = DensifiedOperator.from_matrix(m)
    np.testing.assert_array_equal(
        np.asarray(op.hi, np.float32), np.asarray(op_ref.hi, np.float32)
    )
