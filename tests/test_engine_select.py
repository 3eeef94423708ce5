"""'auto' engine selection: dense -> gram -> tiled -> sparse by device-memory budget.

The selector (models/pca.py::make_engine_operator) only engages on the GPU
(``platform.engine_ladder()``), so these tests drive its *inputs* — the
fits()/payload planners — with mocked budgets, plus the selector's cache
semantics and the platform decision itself.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import SparseMatrix
from single_algebra_tpu.linalg import (
    DensifiedOperator,
    GramPCAEngine,
    TiledSparseOperator,
)
from single_algebra_tpu.models.pca import make_engine_operator


def _m(n=3000, p=400, density=0.05, seed=0):
    rng = np.random.default_rng(seed)
    X = sp.random(
        n, p, density=density, format="csr", dtype=np.float64,
        random_state=rng,
        data_rvs=lambda s: (rng.poisson(1.0, s) + 1).astype(np.float64),
    ).astype(np.float32)
    return SparseMatrix.from_scipy(X)


def test_fits_ladder_is_monotone_in_budget():
    m = _m()
    dense_b = 2 * m.shape[0] * m.shape[1]  # bf16 hi, exact counts
    assert DensifiedOperator.fits(m.shape, budget_bytes=dense_b)
    assert not DensifiedOperator.fits(m.shape, budget_bytes=dense_b - 1)

    gram_b = GramPCAEngine.payload_bytes(m)
    assert GramPCAEngine.fits(m, budget_bytes=gram_b)
    assert not GramPCAEngine.fits(m, budget_bytes=gram_b // 4)

    tiled_b = TiledSparseOperator.payload_bytes(m)
    # the two-level (overflow) tiled payload is never larger than the
    # overflow-free gram payload for the same matrix
    assert tiled_b <= gram_b
    assert TiledSparseOperator.fits(m, budget_bytes=tiled_b)
    assert not TiledSparseOperator.fits(m, budget_bytes=tiled_b - 1)


def test_gram_adaptive_col_tile_prefers_smallest_fitting():
    m = _m()
    ct_small, b_small = GramPCAEngine.choose_col_tile(m, budget_bytes=1 << 40)
    assert ct_small == GramPCAEngine.COL_TILES[0]
    # squeeze the budget below each tile's payload: the chooser must pick a
    # layout no more expensive than that candidate
    for ct in GramPCAEngine.COL_TILES:
        _, b, _, _ = GramPCAEngine._bucket_plan(m, ct)
        chosen_ct, chosen_b = GramPCAEngine.choose_col_tile(
            m, budget_bytes=b
        )
        assert chosen_b <= b


def test_gram_rejects_very_wide_matrices():
    # width guard: p > 40960 refuses regardless of budget
    wide = _m(n=50, p=500)
    wide.shape = (50, 500)
    assert GramPCAEngine.fits(wide, budget_bytes=1 << 50)
    wide.shape = (50, 50000)
    assert not GramPCAEngine.fits(wide, budget_bytes=1 << 50)


def test_auto_resolves_gram_class_to_gram(monkeypatch):
    """'auto' on a gram-class matrix (dense doesn't fit, Gram does)
    resolves to the exact Gram engine on EVERY fit, including the first
    (see make_engine_operator docs)."""

    import single_algebra_tpu.models.pca as pca_mod
    from single_algebra_tpu import platform

    m = _m(n=500, p=200)
    m._operator_cache = {}
    monkeypatch.setattr(platform, "engine_ladder", lambda: True)
    monkeypatch.setattr(
        pca_mod.DensifiedOperator, "fits",
        classmethod(lambda cls, *a, **k: False),
    )
    monkeypatch.setattr(
        pca_mod.GramPCAEngine, "fits", classmethod(lambda cls, *a, **k: True)
    )
    monkeypatch.setattr(
        pca_mod.GramPCAEngine, "from_matrix",
        classmethod(lambda cls, mm: "GRAM"),
    )
    assert make_engine_operator(m, "auto") == "GRAM"
    assert m._operator_cache["auto"] == "GRAM"
    assert "tiled" not in m._operator_cache


def test_operator_cache_shared_between_auto_and_named():
    m = _m(n=500, p=200)
    m._operator_cache = {}
    op1 = make_engine_operator(m, "sparse")
    op2 = make_engine_operator(m, "sparse")
    assert op1 is op2
    # on the CPU, auto resolves to sparse and must share the cache entry
    op3 = make_engine_operator(m, "auto")
    assert op3 is op1


def test_platform_gpu_enables_the_ladder(monkeypatch):
    import jax

    from single_algebra_tpu import platform

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.backend() == "gpu"
    assert platform.engine_ladder()


def test_platform_cpu_keeps_sparse():
    from single_algebra_tpu import platform

    assert platform.backend() == "cpu"
    assert not platform.engine_ladder()
    # the CPU reports no memory limit: the budgets take their fixed sizes
    assert platform.device_memory_limit() is None
    assert DensifiedOperator.hbm_budget_bytes() == 9 << 30
    assert GramPCAEngine.hbm_budget_bytes() == 12 << 30
    m = _m(n=500, p=200)
    m._operator_cache = {}
    from single_algebra_tpu.linalg import SparseOperator

    assert isinstance(make_engine_operator(m, "auto"), SparseOperator)


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_platform_other_backends_raise(monkeypatch, name):
    import jax

    from single_algebra_tpu import platform

    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.engine_ladder()
    m = _m(n=500, p=200)
    m._operator_cache = {}
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        make_engine_operator(m, "auto")


def test_platform_gpu_without_memory_stats_raises(monkeypatch):
    """A GPU that reports no memory limit is an error, not a guess."""

    import jax

    from single_algebra_tpu import platform

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="no memory limit"):
        DensifiedOperator.hbm_budget_bytes()
    with pytest.raises(RuntimeError, match="no memory limit"):
        GramPCAEngine.hbm_budget_bytes()


def test_platform_gpu_budgets_follow_memory_stats(monkeypatch):
    import jax

    from single_algebra_tpu import platform

    class _Dev:
        def memory_stats(self):
            return {"bytes_limit": 10 << 30}

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()])
    assert platform.device_memory_limit() == 10 << 30
    assert DensifiedOperator.hbm_budget_bytes() == int((10 << 30) * 0.6)
    assert GramPCAEngine.hbm_budget_bytes() == int((10 << 30) * 0.8)
