"""Stage tracing: named profiler annotations + wall-clock stage timings.

The reference's observability is verbose printlns plus ``Instant`` stage
timings (``sparse_masked/mod.rs:257,288``; SURVEY.md §5). The
upgrade is ``jax.profiler`` trace annotations — stages show up named in
TensorBoard/XProf captures — plus the same wall-clock dict the printlns
provided.

Usage::

    from single_algebra_tpu.utils.tracing import stage, stage_timings

    with stage("densify"):
        op = DensifiedOperator.from_matrix(m)
    with stage("fit"):
        pca.fit(m)
    print(stage_timings())   # {'densify': 12.3, 'fit': 0.2}

    with profile_trace("/tmp/jax-trace"):   # full XProf capture
        pca.fit(m)
"""

from __future__ import annotations

import contextlib
import threading
import time

__all__ = ["stage", "stage_timings", "reset_stage_timings", "profile_trace"]

_local = threading.local()


def _timings() -> dict:
    if not hasattr(_local, "timings"):
        _local.timings = {}
    return _local.timings


@contextlib.contextmanager
def stage(name: str):
    """Context manager: profiler TraceAnnotation + wall-clock accumulation
    under ``name`` (per-thread)."""

    import jax.profiler

    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    _timings()[name] = _timings().get(name, 0.0) + (
        time.perf_counter() - t0
    )


def stage_timings() -> dict:
    """Accumulated wall-clock seconds per stage (this thread)."""

    return dict(_timings())


def reset_stage_timings() -> None:
    _timings().clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Full device trace capture around a block (view with XProf or
    TensorBoard's profile plugin)."""

    import jax.profiler

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
