"""The one place the program asks which backend it runs on.

Two backends are supported:

* ``gpu`` — the accelerator. The 'auto' engine ladder is on
  (dense -> gram -> tiled -> sparse, each by its own ``fits()`` check), and
  device memory budgets come from the device's ``memory_stats()``.
* ``cpu`` — tests and small runs. 'auto' keeps the ``sparse`` engine, and
  memory budgets fall back to fixed sizes, since the CPU reports none.

Any other backend is refused.
"""

from __future__ import annotations

import jax

__all__ = ["backend", "engine_ladder", "device_memory_limit"]

SUPPORTED = ("gpu", "cpu")


def backend() -> str:
    """``jax.default_backend()``, checked against :data:`SUPPORTED`."""

    name = jax.default_backend()
    if name not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX backend {name!r}: single_algebra_tpu runs on "
            f"{' or '.join(SUPPORTED)}"
        )
    return name


def engine_ladder() -> bool:
    """True where 'auto' may choose the dense, gram and tiled engines."""

    return backend() == "gpu"


def device_memory_limit() -> int | None:
    """Bytes the default device lets the program allocate, or ``None`` on
    the CPU, which reports no limit. A GPU that reports none is an error:
    the engine budgets would otherwise be guesses."""

    kind = backend()
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
    if limit:
        return int(limit)
    if kind == "cpu":
        return None
    raise RuntimeError(
        f"the {kind} device reports no memory limit (memory_stats() = "
        f"{stats!r}); cannot size the PCA engines"
    )
