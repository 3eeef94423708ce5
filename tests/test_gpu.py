"""The checks of ``chip_smoke.py`` at smaller sizes, on the card.

Every test here is marked ``gpu`` and takes the ``gpu`` fixture, which
skips unless JAX's default device is a GPU. Run them there with

    SINGLE_ALGEBRA_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu -q
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

# p <= 4096: the Gram engine's exact eigh, not its randomized large-Gram solve
SMALL_WIDE = dict(n=131_072, p=4_000, density=0.01, seed=7, n_clusters=64)
SMALL_STRESS = dict(n=200_000, p=2_500, density=0.01, seed=7, n_clusters=16)


def test_gpu_device(gpu):
    info = chip_smoke.check_device()
    assert info["platform"] == "gpu" and info["count"] >= 1
    assert chip_smoke.nvidia_smi()


def test_gpu_densify_exact(gpu):
    out = chip_smoke.check_densify(rows=8192, p=8_000)
    assert out["densify_int8_max_abs_err"] == 0.0


def test_gpu_tiled_products(gpu):
    out = chip_smoke.check_tiled_products(n=40_000, p=16_384, k=32)
    assert out["f32_mv_rel_err"] <= 1e-5 and out["bf16_rmv_rel_err"] <= 1e-5


def test_gpu_auto_past_dense_picks_gram_and_meets_truth(gpu, monkeypatch):
    """At 1M x 30k the dense form exceeds the budget and 'auto' takes the
    Gram engine; here the dense budget is refused to take the same path
    at a smaller size."""

    from single_algebra_tpu.linalg.operators import DensifiedOperator

    monkeypatch.setattr(
        DensifiedOperator, "fits", classmethod(lambda cls, *a, **k: False)
    )
    out = chip_smoke.check_northstar(cfg=SMALL_WIDE, k=50, expect_nnz=None)
    assert out["engine"] == "gram" and out["tier"] == "int8"
    assert out["ev_rel_err"] <= 1e-5


def test_gpu_engines(gpu):
    chip_smoke.check_engines(cfg=SMALL_STRESS, k=16, chunk_rows=50_000)


def test_gpu_pipeline(gpu):
    out = chip_smoke.check_pipeline(cells=5_000, genes=2_000)
    assert out["leiden_communities"] >= 2
