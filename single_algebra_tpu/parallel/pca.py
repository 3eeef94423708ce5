"""Multi-device PCA: the north-star workload sharded over a mesh.

Composes the row-sharded operator with the jitted randomized-SVD engine.
The partitioning follows the scaling-book recipe for this problem class:
rows (cells) sharded over the mesh axis, all l-width sketch matrices and
p-width statistics replicated, collectives limited to one ``psum`` per
``A^T @ ...`` product and per column-stat pass.

Single-device meshes degenerate to the plain path, so this is also the
entry point ``__graft_entry__.dryrun_multichip`` exercises.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..linalg import MaskedOperator
from ..models.pca import _fit_graph
from ..sparse.matrix import SparseMatrix
from ..types import PowerIterationNormalizer, SVDMethod
from .sharded import (
    Mesh,
    ShardedDensified,
    ShardedSpMM,
    ShardedTiled,
    make_mesh,
)

__all__ = [
    "ShardedPCAResult",
    "choose_sharded_engine",
    "sharded_pca_fit_transform",
]


def choose_sharded_engine(m: SparseMatrix, mesh: Mesh) -> str:
    """Mesh analog of the single-chip 'auto' ladder: 'dense' when the
    bf16 densified payload fits the AGGREGATE device-memory budget, else 'tiled'
    when the stacked tiled payload fits, else 'sparse' (gather path).
    The Gram engine has its own entry point (``sharded_gram_pca``)."""

    from .. import platform
    from ..linalg.operators import DensifiedOperator
    from ..models.pca import _needs_lo

    # dense and tiled split f32 values into bf16 terms — mirror the
    # single-device ladder's backend and dtype gate
    if not platform.engine_ladder() or m.dtype != jnp.float32:
        return "sparse"
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    budget = DensifiedOperator.hbm_budget_bytes() * ndev
    # needs_lo=True doubles the byte requirement, so this single check
    # subsumes the hi-only one
    if DensifiedOperator.fits(
        m.shape, budget_bytes=budget, needs_lo=_needs_lo(m)
    ):
        return "dense"
    if ShardedTiled.payload_bytes(m, ndev) <= budget:
        return "tiled"
    return "sparse"


class ShardedPCAResult(NamedTuple):
    transformed: jnp.ndarray  # [n, k] row-sharded
    components: jnp.ndarray  # [k, p] replicated
    explained_variance: jnp.ndarray  # [k]
    mean: jnp.ndarray  # [p]
    total_variance: jnp.ndarray  # []


def sharded_pca_fit_transform(
    x,
    n_components: int = 50,
    mesh: Mesh | None = None,
    svd_method: SVDMethod | None = None,
    center: bool = True,
    seed: int = 42,
    engine: str = "sparse",
    mask=None,
    lanczos_steps: int | None = None,
    tolerance: float | None = 1e-6,
    lanczos_block: int | None = None,
) -> ShardedPCAResult:
    """Centered PCA of a row-sharded sparse matrix (both SVD methods).

    ``x`` may be a SparseMatrix (sharded here) or a prebuilt
    :class:`ShardedSpMM`/:class:`ShardedDensified`/:class:`ShardedTiled`.
    ``engine`` selects the per-slab compute: 'dense' (bf16 matmuls),
    'tiled' (densify-then-contract over row blocks), 'sparse' (gather
    path), or 'auto' (:func:`choose_sharded_engine`'s memory-budget
    ladder).
    Both ``SVDMethod``s run over the mesh: the randomized sketch and the
    Golub-Kahan recurrence are sequences of mv/rmv products, so the
    row-sharded operator (local SpMM + one ``psum`` per ``A^T@``) plugs
    into either engine unchanged; the Lanczos path keeps the reference
    semantic of operating on the RAW (uncentered) matrix.

    ``mask`` (optional boolean, length p) restricts features like
    ``MaskedSparsePCA``: the masked view is an int32 gather on the
    REPLICATED skinny operands, so it composes with row sharding without
    extra collectives. ``mean`` in the result stays FULL width (reference
    semantic, ``sparse_masked/mod.rs:279-289``); ``components`` is
    k x p_masked.
    """

    if svd_method is None:
        svd_method = SVDMethod.random(10, 7, PowerIterationNormalizer.QR)
    if isinstance(x, (ShardedSpMM, ShardedDensified, ShardedTiled)):
        op = x
    else:
        if not isinstance(x, SparseMatrix):
            x = SparseMatrix.from_scipy(x)
        mesh = mesh or make_mesh()
        if engine == "auto":
            engine = choose_sharded_engine(x, mesh)
        cls = {
            "dense": ShardedDensified,
            "tiled": ShardedTiled,
            "sparse": ShardedSpMM,
        }[engine]
        # slab building + placement is per-(matrix, mesh) work — cache it
        cache = getattr(x, "_operator_cache", None)
        key = (
            f"sharded:{engine}:{mesh.shape}:{tuple(d.id for d in mesh.devices.flat)}"
        )
        if cache is not None and key in cache:
            op = cache[key]
        else:
            op = cls.from_matrix(x, mesh)
            if cache is not None:
                cache[key] = op

    n, p = op.shape
    stats = op.col_stats()
    # scalar bookkeeping in numpy (each eager device op is its own dispatch)
    s_np = np.asarray(stats[0], dtype=np.float64)
    sq_np = np.asarray(stats[1], dtype=np.float64)
    dt = np.asarray(stats[0]).dtype
    mean_np = s_np / n

    idx_np = None
    fit_op = op
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        if mask.shape[0] != p:
            raise ValueError(
                "The mask vector length and the number of features (columns)"
                " have to be the same!"
            )
        idx_np = np.where(mask)[0]
        fit_op = MaskedOperator(op, jnp.asarray(idx_np.astype(np.int32)))

    if center:
        var_all = (sq_np - mean_np * s_np) / max(n - 1, 1)
        total_var = float(
            var_all.sum() if idx_np is None else var_all[idx_np].sum()
        )
    mean = (
        jnp.asarray(mean_np.astype(dt))
        if center
        else jnp.zeros((p,), dt)
    )
    fit_mean = mean if idx_np is None else jnp.asarray(
        (mean_np[idx_np] if center else np.zeros(len(idx_np))).astype(dt)
    )

    # one fused dispatch: SVD -> sign flip -> projection (shared with the
    # single-device PCA)
    s_dev, vt, T = _fit_graph(
        fit_op,
        fit_mean,
        seed,
        k=n_components,
        method=svd_method,
        center=center,
        steps=lanczos_steps,
        want_transform=True,
        tol=tolerance,
        lanczos_block=lanczos_block,
    )
    ev_np = np.asarray(s_dev, np.float64) ** 2 / max(n - 1, 1)
    if not center:
        total_var = float(ev_np.sum())
    return ShardedPCAResult(
        T, vt, jnp.asarray(ev_np.astype(dt)), mean, total_var
    )
