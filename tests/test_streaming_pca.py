"""StreamingSparsePCA: out-of-core Gram accumulation (SURVEY §2.3 _chunk
analog; reference caller-managed streaming, src/sparse/mod.rs:44-50)."""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu.models import StreamingSparsePCA


def _matrix(n=700, p=120, density=0.1, seed=0, counts=True):
    rng = np.random.default_rng(seed)
    rvs = (
        (lambda size: (rng.poisson(1.5, size) + 1).astype(np.float64))
        if counts
        else rng.standard_normal
    )
    return sp.random(
        n, p, density=density, format="csr", dtype=np.float64,
        random_state=rng, data_rvs=rvs,
    ).astype(np.float32)


@pytest.mark.parametrize("chunk_rows", [97, 256, 700])
@pytest.mark.parametrize("counts", [True, False])
def test_streaming_matches_exact_pca(chunk_rows, counts):
    X = _matrix(counts=counts)
    n, p = X.shape
    k = 5
    pca = StreamingSparsePCA(n_components=k, n_features=p, random_seed=1)
    for r0 in range(0, n, chunk_rows):
        pca.partial_fit(X[r0 : r0 + chunk_rows])
    pca.finalize()

    D = X.toarray().astype(np.float64)
    Dc = D - D.mean(axis=0, keepdims=True)
    s_ref = np.linalg.svd(Dc, compute_uv=False)
    ev_ref = s_ref[:k] ** 2 / (n - 1)
    ev = np.asarray(pca.explained_variance_, np.float64)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 5e-5

    # transform parity: scores == centered data @ components
    T = pca.transform(X)
    assert T.shape == (n, k)
    V = np.asarray(pca.components_, np.float64)
    T_ref = Dc @ V.T
    assert np.abs(np.abs(T) - np.abs(T_ref)).max() < 5e-3 * np.abs(T_ref).max()

    # moment byproducts
    ref_sums = np.asarray(X.sum(axis=0)).ravel()
    # per-slab device sums are f32: absolute tolerance scaled to the data
    # (zero-mean values cancel, so rtol on near-zero sums is meaningless)
    scale = np.abs(X.data).sum() / X.shape[1]
    np.testing.assert_allclose(
        pca.col_sums(), ref_sums, rtol=1e-5, atol=1e-6 * scale
    )
    ref_var = Dc.var(axis=0, ddof=1)
    np.testing.assert_allclose(pca.col_var(), ref_var, rtol=1e-5, atol=1e-8)


def test_streaming_uncentered_is_truncated_svd():
    X = _matrix(n=300, p=80)
    k = 4
    pca = StreamingSparsePCA(
        n_components=k, n_features=80, center=False, random_seed=3
    )
    pca.partial_fit(X).finalize()
    s_ref = np.linalg.svd(X.toarray().astype(np.float64), compute_uv=False)
    ev_ref = s_ref[:k] ** 2 / (X.shape[0] - 1)
    ev = np.asarray(pca.explained_variance_, np.float64)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 5e-5


def test_streaming_validation():
    pca = StreamingSparsePCA(n_components=3, n_features=50)
    with pytest.raises(ValueError, match="chunk width"):
        pca.partial_fit(sp.random(10, 49, 0.5, format="csr", dtype=np.float32))
    with pytest.raises(RuntimeError, match="fitted"):
        pca.transform(sp.random(10, 50, 0.5, format="csr", dtype=np.float32))
    with pytest.raises(ValueError, match="n_features"):
        StreamingSparsePCA(n_components=3)
    pca.partial_fit(sp.random(10, 50, 0.5, format="csr", dtype=np.float32))
    pca.finalize()
    # new data after finalize is legal (the Gram is additive) but drops
    # the stale solve until the next finalize()
    pca.partial_fit(sp.random(10, 50, 0.5, format="csr", dtype=np.float32))
    assert pca.components_ is None
    with pytest.raises(RuntimeError, match="fitted"):
        pca.transform(
            sp.random(10, 50, 0.5, format="csr", dtype=np.float32)
        )


def test_streaming_incremental_refit():
    """fit A -> finalize -> fit B -> finalize == one-shot fit of [A; B]
    (true online PCA: G is additive, the solve is just re-run)."""

    X = _matrix(n=500, p=80, seed=11)
    A, B = X[:300], X[300:]
    k = 4
    inc = StreamingSparsePCA(n_components=k, n_features=80, random_seed=1)
    inc.partial_fit(A).finalize()
    ev_a = np.asarray(inc.explained_variance_).copy()
    inc.partial_fit(B)
    inc.finalize()

    one = StreamingSparsePCA(n_components=k, n_features=80, random_seed=1)
    one.partial_fit(X).finalize()

    assert not np.allclose(ev_a, np.asarray(inc.explained_variance_))
    np.testing.assert_allclose(
        np.asarray(inc.explained_variance_),
        np.asarray(one.explained_variance_),
        rtol=1e-4,
    )
    np.testing.assert_allclose(
        np.abs(np.asarray(inc.components_)),
        np.abs(np.asarray(one.components_)),
        rtol=1e-2, atol=1e-4,
    )
    np.testing.assert_allclose(inc.col_sums(), one.col_sums(), rtol=1e-6)
    # transforms agree too
    np.testing.assert_allclose(
        inc.transform(A), one.transform(A), rtol=1e-3, atol=1e-5
    )


def test_streaming_fold_matches_unfolded():
    """The periodic f64 Gram fold is numerically transparent at small
    slab counts (its purpose is bounding drift at large ones)."""

    X = _matrix(n=600, p=64, seed=12)
    a = StreamingSparsePCA(
        n_components=3, n_features=64, random_seed=0, fold_every=1
    )
    b = StreamingSparsePCA(
        n_components=3, n_features=64, random_seed=0, fold_every=10**9
    )
    for r0 in range(0, 600, 150):
        a.partial_fit(X[r0 : r0 + 150])
        b.partial_fit(X[r0 : r0 + 150])
    a.finalize()
    b.finalize()
    assert a._G64 is not None and b._G64 is None
    np.testing.assert_allclose(
        np.asarray(a.explained_variance_),
        np.asarray(b.explained_variance_),
        rtol=1e-5,
    )


def test_streaming_mesh_matches_unsharded():
    """Mesh-mode streaming (row-sharded super-slabs + psum into the
    replicated Gram) agrees with the single-device stream."""

    from single_algebra_tpu.parallel import make_mesh

    X = _matrix(n=900, p=100, density=0.1, seed=6)
    k = 4
    ref = StreamingSparsePCA(n_components=k, n_features=100, random_seed=2)
    for r0 in range(0, 900, 300):
        ref.partial_fit(X[r0 : r0 + 300])
    ref.finalize()

    import single_algebra_tpu.models.streaming_pca as spmod

    old_slab = spmod._SLAB
    spmod._SLAB = 128  # small slabs so 8 devices see real work in tests
    try:
        mesh = make_mesh(8)
        pca = StreamingSparsePCA(
            n_components=k, n_features=100, random_seed=2, mesh=mesh
        )
        for r0 in range(0, 900, 300):
            pca.partial_fit(X[r0 : r0 + 300])
        pca.finalize()
        T = pca.transform(X[:300])
    finally:
        spmod._SLAB = old_slab

    np.testing.assert_allclose(
        np.asarray(pca.explained_variance_),
        np.asarray(ref.explained_variance_),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        pca.col_sums(), ref.col_sums(), rtol=1e-5, atol=1e-3
    )
    assert T.shape == (300, k)
    T_ref = ref.transform(X[:300])
    np.testing.assert_allclose(T, T_ref, rtol=1e-3, atol=1e-4)


def test_streaming_moment_guards():
    pca = StreamingSparsePCA(n_components=2, n_features=30)
    with pytest.raises(RuntimeError, match="no rows"):
        pca.col_sums()
    with pytest.raises(RuntimeError, match="no rows"):
        pca.col_sums_squared()
    pca.partial_fit(sp.random(1, 30, 0.5, format="csr", dtype=np.float32))
    with pytest.raises(RuntimeError, match="variance"):
        pca.col_var()


def test_streaming_refit_other_k():
    X = _matrix(n=400, p=60, seed=8)
    pca = StreamingSparsePCA(n_components=3, n_features=60, random_seed=0)
    pca.partial_fit(X).finalize()
    ev3 = np.asarray(pca.explained_variance_).copy()
    pca.refit(5)
    assert np.asarray(pca.explained_variance_).shape == (5,)
    np.testing.assert_allclose(
        np.asarray(pca.explained_variance_)[:3], ev3, rtol=1e-6
    )
    pca.refit(3)
    assert np.asarray(pca.explained_variance_).shape == (3,)


def test_streaming_inverse_transform_matches_one_shot():
    X = _matrix(n=500, p=80)
    k = 6
    spca = StreamingSparsePCA(n_components=k, n_features=80, random_seed=2)
    for r0 in range(0, 500, 128):
        spca.partial_fit(X[r0:r0 + 128])
    spca.finalize()
    T = spca.transform(X)
    R = spca.inverse_transform(T)
    assert R.shape == X.shape
    # identity: T @ components_ + mean_
    expected = T @ np.asarray(spca.components_) + np.asarray(spca.mean_)
    np.testing.assert_allclose(R, expected, rtol=1e-5, atol=1e-5)
    # reconstruction is near the optimal rank-k one
    dense = X.toarray()
    from sklearn.decomposition import PCA as SkPCA

    sk = SkPCA(n_components=k, svd_solver="full").fit(dense)
    err_sk = np.linalg.norm(
        sk.inverse_transform(sk.transform(dense)) - dense
    )
    assert np.linalg.norm(R - dense) <= 1.02 * err_sk


def test_streaming_payload_cache_roundtrip():
    """partial_fit(chunk, key=...) with a payload_cache: the second fit
    reuses device payloads (no host rebuild) and reproduces the first
    fit bit-for-bit — single-device and mesh modes."""

    from single_algebra_tpu.parallel import make_mesh

    X = _matrix(n=700, p=90, density=0.1, seed=9)
    k = 4

    for mesh in (None, make_mesh(4)):
        cache: dict = {}

        def run():
            pca = StreamingSparsePCA(
                n_components=k, n_features=90, random_seed=3, mesh=mesh,
                payload_cache=cache,
            )
            for r0 in range(0, 700, 250):
                pca.partial_fit(X[r0 : r0 + 250], key=r0)
            pca.finalize()
            return pca

        a = run()
        assert cache  # populated by the first pass
        n_keys = len(cache)
        # poison the host-build path: a cache hit must not rebuild
        import single_algebra_tpu.models.streaming_pca as spmod

        orig = spmod._slab_payload

        def boom(*a, **k):  # pragma: no cover
            raise AssertionError("cache hit must not rebuild payloads")

        spmod._slab_payload = boom
        try:
            b = run()
        finally:
            spmod._slab_payload = orig
        assert len(cache) == n_keys
        np.testing.assert_array_equal(
            np.asarray(a.explained_variance_),
            np.asarray(b.explained_variance_),
        )
        np.testing.assert_array_equal(a.col_sums(), b.col_sums())


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_delivers_every_item_to_a_slow_consumer(depth):
    """The payload prefetch must hand over every built slab even when the
    producer finishes while the queue is full (a slow device step): the
    end marker waits for room instead of displacing a queued slab."""

    import time

    from single_algebra_tpu.models.streaming_pca import _prefetch

    got = []
    for item in _prefetch(iter(range(7)), depth=depth):
        time.sleep(0.05)  # the producer runs ahead and fills the queue
        got.append(item)
    assert got == list(range(7))


def test_streaming_multi_slab_chunks_match_single_slab_chunks():
    """Chunks wider than one 8,192-row device slab (re-slabbed and
    prefetched inside partial_fit) give the same Gram as small chunks."""

    from single_algebra_tpu.models import streaming_pca as spmod

    X = _matrix(n=3 * 8192 + 100, p=40, density=0.05, seed=5)

    def run(chunk):
        pca = StreamingSparsePCA(n_components=4, n_features=40, random_seed=1)
        for r0 in range(0, X.shape[0], chunk):
            pca.partial_fit(X[r0 : r0 + chunk])
        pca.finalize()
        return pca

    assert X.shape[0] > 2 * spmod._SLAB
    a, b = run(X.shape[0]), run(4096)
    assert a._n == b._n == X.shape[0]
    np.testing.assert_allclose(a.col_sums(), b.col_sums(), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(a.explained_variance_), np.asarray(b.explained_variance_),
        rtol=1e-5,
    )
