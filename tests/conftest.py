"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerator hardware by forcing
the host CPU platform to expose 8 devices (the reference has no
distributed testing at all; SURVEY.md §4 prescribes this setup). x64 is
enabled so f64 golden tests can hit the reference's 1e-10 tolerances.

``SINGLE_ALGEBRA_TEST_GPU=1`` leaves the platform to JAX instead, so the
tests marked ``gpu`` can run on the card (see the README); x64 stays off
there, as in the program's own runs.
"""

import os

ON_GPU = os.environ.get("SINGLE_ALGEBRA_TEST_GPU") == "1"

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import scipy.sparse as sp


@pytest.fixture
def gpu():
    """The GPU the ``gpu`` tests run on; they skip where JAX has none."""

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs an NVIDIA GPU (JAX's default device is {dev.platform}); "
            "run with SINGLE_ALGEBRA_TEST_GPU=1 on a machine with one"
        )
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_random_csr(n, p, density=0.1, seed=42, dtype=np.float64, fmt="csr"):
    rng = np.random.default_rng(seed)
    mat = sp.random(
        n, p, density=density, format=fmt, dtype=np.float64,
        random_state=rng, data_rvs=rng.random,
    )
    return mat.astype(dtype)


@pytest.fixture
def small_csr():
    return make_random_csr(50, 37, density=0.15, seed=1)


def cluster_counts(n, p, n_clusters=8, seed=0, density=0.1):
    """scRNA-like synthetic counts with a genuinely gapped spectrum.
    Keep in sync with ``benchmarks/_datagen.py`` (same recipe; the
    benchmarks measure exactly the structure these tests validate)."""

    rng = np.random.default_rng(seed)
    base = rng.gamma(2.0, 1.0, size=(n_clusters, p)) * (
        rng.random((n_clusters, p)) < 0.5
    )
    scale = np.geomspace(8, 1, n_clusters)[:, None]
    lam = base * scale * (density / max(base.mean(), 1e-9))
    labels = rng.integers(0, n_clusters, n)
    X = rng.poisson(lam[labels]).astype(np.float64)
    return sp.csr_matrix(X)
