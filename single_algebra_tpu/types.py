"""Core enums and dtype policy for single-algebra-tpu.

JAX rebuild of the type/trait foundation of SingleRust/single-algebra:

* ``Direction`` mirrors ``single_utilities::types::Direction`` (reference usage:
  ``src/sparse/csr.rs:17``, ``src/utils/mod.rs:4``).
* ``PowerIterationNormalizer`` mirrors ``single_svdlib::randomized::
  PowerIterationNormalizer`` re-exported at ``src/dimred/pca/mod.rs:41``.
* ``SVDMethod`` mirrors the enum at ``src/dimred/pca/mod.rs:49-68``
  (``Lanczos`` default, ``Random {n_oversamples, n_power_iterations,
  normalizer}``).
* The dtype policy replaces the reference's ``SvdFloat``/``FloatOpsTS``
  generic bounds (``src/dimred/pca/mod.rs:42``): f32 is the working
  dtype; f64 requires ``jax.config.update("jax_enable_x64", True)``.
"""

from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np


class Direction(enum.Enum):
    """Row/column axis selector (reference: single_utilities Direction)."""

    ROW = "row"
    COLUMN = "column"


class PowerIterationNormalizer(enum.Enum):
    """Stabilization applied between power iterations in randomized SVD.

    Mirrors single-svdlib's enum; the QR variant is the one exercised by the
    reference README example (reference README.md:63) and tests
    (src/dimred/pca/sparse/mod.rs:549).
    """

    QR = "qr"
    LU = "lu"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class SVDMethod:
    """SVD algorithm selection (reference: src/dimred/pca/mod.rs:49-68).

    Use the constructors :meth:`lanczos` and :meth:`random`. The default —
    matching ``SVDMethod::default()`` in the reference — is Lanczos.
    """

    kind: str = "lanczos"  # "lanczos" | "random"
    n_oversamples: int = 10
    n_power_iterations: int = 7
    normalizer: PowerIterationNormalizer = PowerIterationNormalizer.QR

    @classmethod
    def lanczos(cls) -> "SVDMethod":
        return cls(kind="lanczos")

    @classmethod
    def random(
        cls,
        n_oversamples: int = 10,
        n_power_iterations: int = 7,
        normalizer: PowerIterationNormalizer = PowerIterationNormalizer.QR,
    ) -> "SVDMethod":
        return cls(
            kind="random",
            n_oversamples=n_oversamples,
            n_power_iterations=n_power_iterations,
            normalizer=normalizer,
        )

    @property
    def is_random(self) -> bool:
        return self.kind == "random"


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------

#: All dots in the library run at this precision so f32 products run in
#: full f32 instead of a fast-but-lossy reduced-precision mode (bf16 or
#: TF32).
MATMUL_PRECISION = jax.lax.Precision.HIGHEST

_SUPPORTED_FLOATS = (np.float32, np.float64)


def canonical_float_dtype(dtype) -> np.dtype:
    """Validate and canonicalize a floating dtype (f32/f64 policy).

    The reference is generic over ``f32``/``f64`` (README.md:13). f32 is the
    working dtype; f64 requires x64 mode.
    """

    dt = np.dtype(dtype)
    if dt.type not in _SUPPORTED_FLOATS:
        raise TypeError(
            f"single-algebra-tpu supports float32/float64 values, got {dt}"
        )
    if dt == np.float64 and not jax.config.read("jax_enable_x64"):
        raise TypeError(
            "float64 requested but jax x64 mode is disabled; call "
            "jax.config.update('jax_enable_x64', True) first"
        )
    return dt


def index_dtype() -> np.dtype:
    return np.dtype(np.int32)


def matmul_dtype(dtype) -> jnp.dtype:
    """Accumulation dtype for a given storage dtype."""

    return jnp.dtype(dtype)
