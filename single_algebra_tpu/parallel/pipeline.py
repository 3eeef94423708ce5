"""Mesh-sharded scRNA pipeline stages over the row-sharded operator.

The reference is single-process (SURVEY.md §2.3) so none of this has a
reference counterpart — it finishes the rebuild's one added layer: at
north-star scale (1M cells) the whole pipeline shards, not just the PCA.
Every stage is the same row-slab decomposition the sharded PCA engines
use: per-cell statistics are device-local reductions over the row-major
ELL slab (zero collectives), per-gene statistics are local reductions
over the transposed slab followed by ONE ``psum`` over the mesh axis,
and grouped (per-cluster) statistics are one-hot SpMM against the
slab-local transposed payload plus one ``psum`` — the same one-hot
group-by trick ``SparseMatrix._batch_spmm`` uses on one device.

Value updates (normalize / log1p / scaling) are functional payload maps:
:func:`mesh_map_stored` rewrites both resident layouts in one jitted
pass per layout, preserving shardings, and returns a NEW operator (the
mesh analog of ``SparseMatrix.map_stored``). Padding slots hold
``v = 0`` and must map to 0 — true for every stage here (``x * g``,
``log1p``, ``expm1``).

Single-device semantic anchors: ``qc.calculate_qc_metrics``,
``preprocess.normalize_total`` / ``scale``, ``feature_selection.
highly_variable_genes``, ``de.rank_genes_groups`` — the equality tests
in ``tests/test_mesh_pipeline.py`` pin mesh == single-device for each.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Mapping, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops.precise_math import expm1 as _pexpm1
from ..ops.precise_math import log1p as _plog1p
from ..ops.spmm import ell_spmm
from .sharded import ShardedSpMM

__all__ = [
    "mesh_map_stored",
    "mesh_row_stats",
    "mesh_sum_row_masked",
    "mesh_col_moments",
    "mesh_qc_metrics",
    "mesh_normalize_total",
    "mesh_log1p",
    "mesh_scale",
    "mesh_highly_variable_genes",
    "mesh_grouped_moments",
    "mesh_rank_genes_groups",
]


# ----------------------------------------------------------------------
# functional payload maps
# ----------------------------------------------------------------------


@partial(jax.jit, static_argnums=(1,))
def _map_payloads(op: ShardedSpMM, fn):
    """Apply ``fn(values, global_row_ids, global_col_ids)`` to both
    resident layouts under ``shard_map`` (shardings preserved). ``fn``
    is static: each distinct closure traces once (pipeline stages build
    a handful of lambdas per run — bounded)."""

    ax = op.axis_name
    rs = op.rows_per_shard

    def local(rd, ri, td, ti, tn):
        dev = jax.lax.axis_index(ax)
        # row-major slab: positions are global rows, ids are global cols
        gr = dev * rs + jax.lax.broadcasted_iota(jnp.int32, rd.shape, 0)
        rd2 = fn(rd, gr, ri)
        # transposed slab: ids are slab-LOCAL rows, positions global cols
        gr_t = dev * rs + ti[0]
        gc = jax.lax.broadcasted_iota(jnp.int32, td[0].shape, 0)
        td2 = fn(td[0], gr_t, gc)
        # re-mask the transposed padding slots (tr_nnz is resident, the
        # mask fuses into the map for free): a caller-supplied fn that
        # violates the fn(0) -> 0 contract would otherwise silently
        # corrupt padded gene slots feeding every psum
        rank = jax.lax.broadcasted_iota(jnp.int32, td[0].shape, 1)
        td2 = jnp.where(rank < tn[0][:, None], td2, 0)
        return rd2, td2[None]

    rd2, td2 = jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=(
            P(ax, None), P(ax, None), P(ax, None, None), P(ax, None, None),
            P(ax, None),
        ),
        out_specs=(P(ax, None), P(ax, None, None)),
    )(op.row_data, op.row_ids, op.tr_data, op.tr_ids, op.tr_nnz)
    return rd2, td2


def mesh_map_stored(op: ShardedSpMM, fn) -> ShardedSpMM:
    """New operator with ``fn(v, row, col)`` applied to stored values.

    ``fn`` must map 0 -> 0 for all (row, col) — padding slots carry
    explicit zeros in both layouts (same contract as the single-device
    ``map_stored``, which only ever touches stored entries). The
    transposed layout — the one feeding every per-gene ``psum`` — is
    re-masked via ``tr_nnz`` regardless, for free inside the fused map;
    the row-major layout has no per-row nnz on device, so set
    ``SINGLE_ALGEBRA_TPU_DEBUG=1`` to probe the contract with a zero
    input instead of silently corrupting padded rows (the probe is
    opt-in because ``fn`` may close over sharded device arrays,
    making an always-on probe cost accelerator round trips per call).
    """

    import os

    if os.environ.get("SINGLE_ALGEBRA_TPU_DEBUG"):
        _check_zero_preserving(fn, op.shape, op.row_data.dtype)
    rd2, td2 = _map_payloads(op, fn)
    return dataclasses.replace(op, row_data=rd2, tr_data=td2)


def _check_zero_preserving(fn, shape, dtype) -> None:
    """Probe ``fn`` with zero values at the index corners; raises when
    the result is non-zero (padding slots would be corrupted)."""

    n, p = shape
    v = jnp.zeros((4,), dtype)
    r = jnp.array([0, 0, n - 1, n - 1], jnp.int32)
    c = jnp.array([0, p - 1, 0, p - 1], jnp.int32)
    out = np.asarray(fn(v, r, c))
    if out.shape != (4,) or (out != 0).any():
        raise ValueError(
            "mesh_map_stored: fn must map zero values to zero "
            "(padding slots hold v=0); got fn(0, r, c) = "
            f"{out!r}. Non-zero-preserving maps would corrupt padded "
            "slots — densify or re-think the transform."
        )


def _mesh_log1p_fn(v, r, c):
    return _plog1p(v)


def mesh_log1p(op: ShardedSpMM) -> ShardedSpMM:
    """``ln(1 + x)`` on stored values (reference ``csr.rs:1070-1079``
    semantics: implicit zeros stay zero) — mesh edition."""

    return mesh_map_stored(op, _mesh_log1p_fn)


# ----------------------------------------------------------------------
# statistics
# ----------------------------------------------------------------------


@jax.jit
def _row_stats(op: ShardedSpMM):
    ax = op.axis_name

    def local(rd):
        s = jnp.sum(rd, axis=1)
        nz = jnp.sum((rd != 0).astype(jnp.int32), axis=1)
        return s, nz

    return jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=(P(ax, None),),
        out_specs=(P(ax), P(ax)),
    )(op.row_data)


def mesh_row_stats(op: ShardedSpMM) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(sum, nonzero-count) per cell — local row reductions, no
    collectives. Counts are of nonzero VALUES (padding slots are zero
    by construction; explicit stored zeros, which ``from_scipy`` never
    produces, would not be counted)."""

    s, nz = _row_stats(op)
    n = op.shape[0]
    return s[:n], nz[:n]


@jax.jit
def _sum_row_masked(op: ShardedSpMM, mask_f):
    ax = op.axis_name

    def local(rd, ri, mf):
        keep = jnp.take(mf, ri, axis=0, mode="clip")
        return jnp.sum(rd * keep, axis=1)

    return jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=(P(ax, None), P(ax, None), P()),
        out_specs=P(ax),
    )(op.row_data, op.row_ids, mask_f)


def mesh_sum_row_masked(op: ShardedSpMM, col_mask) -> jnp.ndarray:
    """Per-cell sums restricted to a boolean gene mask (QC's
    ``total_counts_<name>``) — one local gather-weighted reduction."""

    p = op.shape[1]
    col_mask = np.asarray(col_mask)
    if col_mask.dtype != bool or col_mask.shape != (p,):
        raise ValueError(f"col_mask must be a bool mask of length {p}")
    mask_f = jnp.asarray(col_mask.astype(op.row_data.dtype))
    return _sum_row_masked(op, mask_f)[: op.shape[0]]


@partial(jax.jit, static_argnames=("expm1",))
def _col_moments_graph(op: ShardedSpMM, *, expm1: bool):
    ax = op.axis_name

    def local(td):
        x = _pexpm1(td[0]) if expm1 else td[0]
        return jax.lax.psum(
            (jnp.sum(x, axis=1), jnp.sum(x * x, axis=1)), ax
        )

    return jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=(P(ax, None, None),),
        out_specs=(P(), P()),
    )(op.tr_data)


def mesh_col_moments(
    op: ShardedSpMM, *, expm1: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gene (mean, Bessel var over all n rows incl. implicit zeros)
    — the ``var_col`` statistic (reference ``csr.rs:641-657``); one
    psum. ``expm1=True`` de-logs stored values on the fly (the 'seurat'
    HVG flavor on log1p data; ``expm1(0) = 0`` keeps padding exact)."""

    s, sq = _col_moments_graph(op, expm1=expm1)
    n, p = op.shape
    s = np.asarray(s, np.float64)[:p]
    sq = np.asarray(sq, np.float64)[:p]
    mean = s / n
    var = (sq / n - mean * mean) * (n / max(n - 1.0, 1.0))
    return mean, np.maximum(var, 0.0)


# ----------------------------------------------------------------------
# pipeline stages
# ----------------------------------------------------------------------


def mesh_qc_metrics(
    op: ShardedSpMM,
    *,
    qc_vars: Optional[Mapping[str, np.ndarray]] = None,
    log1p: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Mesh edition of :func:`~single_algebra_tpu.qc.calculate_qc_metrics`
    (same obs/var keys): per-cell stats are local, per-gene stats one
    psum, per-``qc_vars`` masked sums one local pass each."""

    n, p = op.shape
    if n < 1 or p < 1:
        raise ValueError(f"Matrix has empty shape {op.shape}")

    obs: Dict[str, np.ndarray] = {}
    var: Dict[str, np.ndarray] = {}

    rsum, rnz = mesh_row_stats(op)
    obs["n_genes_by_counts"] = np.asarray(rnz)
    total = np.asarray(rsum, np.float64)
    obs["total_counts"] = total

    csum, _, ccnt = op.col_stats()
    var["n_cells_by_counts"] = np.asarray(ccnt)
    gtotal = np.asarray(csum, np.float64)
    var["total_counts"] = gtotal
    var["mean_counts"] = gtotal / n
    var["pct_dropout_by_counts"] = 100.0 * (
        1.0 - var["n_cells_by_counts"] / n
    )

    if log1p:
        obs["log1p_n_genes_by_counts"] = np.log1p(obs["n_genes_by_counts"])
        obs["log1p_total_counts"] = np.log1p(total)
        var["log1p_total_counts"] = np.log1p(gtotal)
        var["log1p_mean_counts"] = np.log1p(var["mean_counts"])

    denom = np.maximum(total, 1e-30)
    for name, mask in (qc_vars or {}).items():
        sub = np.asarray(mesh_sum_row_masked(op, mask), np.float64)
        obs[f"total_counts_{name}"] = sub
        obs[f"pct_counts_{name}"] = 100.0 * sub / denom
        if log1p:
            obs[f"log1p_total_counts_{name}"] = np.log1p(sub)

    return obs, var


def mesh_normalize_total(
    op: ShardedSpMM, *, target_sum: Optional[float] = None
) -> Tuple[ShardedSpMM, np.ndarray]:
    """Total-count normalize rows over the mesh (scanpy
    ``pp.normalize_total``; ``target_sum=None`` = median of per-cell
    counts). Zero-sum cells are left untouched (reference
    ``csr.rs:1021-1030`` zero-guard). Returns ``(op', size_factors)``."""

    sums = np.asarray(mesh_row_stats(op)[0], np.float64)
    if target_sum is None:
        pos = sums[sums > 0]
        target_sum = float(np.median(pos)) if pos.size else 1.0
    fac = np.where(sums > 0, target_sum / np.where(sums > 0, sums, 1.0), 1.0)
    rs = op.rows_per_shard
    ndev = op.tr_data.shape[0]
    fac_pad = np.zeros(ndev * rs, np.float64)
    fac_pad[: len(sums)] = fac
    fac_dev = jnp.asarray(fac_pad.astype(np.dtype(op.row_data.dtype)))
    out = mesh_map_stored(
        op, lambda v, r, c: v * jnp.take(fac_dev, r, axis=0, mode="clip")
    )
    return out, sums / target_sum


def mesh_scale(
    op: ShardedSpMM,
    *,
    zero_center: bool = False,
    max_value: Optional[float] = None,
) -> ShardedSpMM:
    """Unit-variance gene scaling over the mesh (scanpy ``pp.scale``
    with ``zero_center=False`` — the sparsity-preserving variant; the
    centered variant densifies [n, p], which at mesh scale is exactly
    what the PCA engines' implicit centering avoids, so it is refused
    here). Zero-variance genes are left unscaled; ``max_value`` upper-
    clips after scaling (scanpy semantics)."""

    if zero_center:
        raise ValueError(
            "zero_center=True densifies [n, p]; at mesh scale use the "
            "PCA engines' implicit centering instead (center=True)"
        )
    mean, var = mesh_col_moments(op)
    std = np.sqrt(np.maximum(var, 0.0))
    inv = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0)
    pp = op.tr_data.shape[1]
    inv_pad = np.zeros(pp, np.float64)
    inv_pad[: len(inv)] = inv
    inv_dev = jnp.asarray(inv_pad.astype(np.dtype(op.row_data.dtype)))

    def fn(v, r, c):
        new = v * jnp.take(inv_dev, c, axis=0, mode="clip")
        if max_value is not None:
            new = jnp.minimum(new, jnp.asarray(max_value, new.dtype))
        return new

    return mesh_map_stored(op, fn)


def mesh_highly_variable_genes(
    op: ShardedSpMM,
    *,
    n_top_genes: Optional[int] = None,
    flavor: str = "seurat",
    assume_logged: Optional[bool] = None,
    n_bins: int = 20,
    min_mean: float = 0.0125,
    max_mean: float = 3.0,
    min_disp: float = 0.5,
    max_disp: float = float("inf"),
):
    """HVG selection over the mesh: one psum for the column moments,
    then the shared p-length host selection
    (:func:`~single_algebra_tpu.feature_selection.
    highly_variable_genes_from_moments`). 'seurat' de-logs on the fly
    (``assume_logged`` defaults to True for 'seurat', False for
    'cell_ranger' — the single-device defaults)."""

    from ..feature_selection import highly_variable_genes_from_moments

    if flavor not in ("seurat", "cell_ranger"):
        raise ValueError(
            f"flavor {flavor!r} not supported on the mesh (seurat_v3 / "
            "pearson_residuals need per-entry passes — single-device only)"
        )
    if assume_logged is None:
        assume_logged = flavor == "seurat"
    mean, var = mesh_col_moments(op, expm1=bool(assume_logged))
    return highly_variable_genes_from_moments(
        mean, var,
        n_top_genes=n_top_genes, flavor=flavor, n_bins=n_bins,
        min_mean=min_mean, max_mean=max_mean,
        min_disp=min_disp, max_disp=max_disp,
    )


# ----------------------------------------------------------------------
# grouped (per-cluster) statistics + DE
# ----------------------------------------------------------------------


@partial(jax.jit, static_argnames=("kind",))
def _grouped_spmm(op: ShardedSpMM, onehot_sharded, *, kind: str):
    """[p-padded, G] one-hot grouped reduction: local ell SpMM on the
    transposed slab (ids are slab-local rows) + one psum."""

    ax = op.axis_name

    def local(td, ti, tn, oh):
        x = td[0]
        if kind == "sumsq":
            x = x * x
        elif kind == "count":
            x = (x != 0).astype(x.dtype)
        part = ell_spmm(x, ti[0], oh)  # [Pp, G]
        del tn
        return jax.lax.psum(part, ax)

    return jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=(
            P(ax, None, None), P(ax, None, None), P(ax, None), P(ax, None),
        ),
        out_specs=P(),
    )(op.tr_data, op.tr_ids, op.tr_nnz, onehot_sharded)


class _MeshDEView:
    """Duck-typed stand-in for ``SparseMatrix`` inside
    :func:`~single_algebra_tpu.de.rank_genes_groups`: supplies ``shape``,
    ``_batch_codes`` and the grouped one-hot SpMM — everything the
    t-test moment path touches."""

    def __init__(self, op: ShardedSpMM):
        self.op = op
        self.shape = op.shape

    def _batch_codes(self, batches: Sequence, expected: int, what: str):
        # same stable-unique encoding as SparseMatrix._batch_codes
        if len(batches) != expected:
            raise ValueError(
                f"Batch vector length ({len(batches)}) doesn't match "
                f"matrix {what} count ({expected})"
            )
        labels = list(dict.fromkeys(batches))
        code_of = {b: i for i, b in enumerate(labels)}
        codes = np.fromiter(
            (code_of[b] for b in batches), dtype=np.int32,
            count=len(batches),
        )
        return labels, codes

    def _batch_spmm(self, axis: str, codes: np.ndarray, transform: str):
        if axis != "col":
            raise ValueError(
                "mesh grouped stats support row-grouped column outputs "
                "only (axis='col')"
            )
        op = self.op
        n, p = op.shape
        nb = int(codes.max()) + 1 if len(codes) else 1
        rs = op.rows_per_shard
        ndev = op.tr_data.shape[0]
        oh = np.zeros((ndev * rs, nb), np.dtype(op.row_data.dtype))
        oh[np.arange(n), codes] = 1
        out = _grouped_spmm(op, jnp.asarray(oh), kind=transform)
        return out[:p]


def mesh_grouped_moments(op: ShardedSpMM, codes: np.ndarray, n_groups: int):
    """Per-group per-gene (size, mean, Bessel var incl. implicit zeros)
    over the mesh — mirrors ``de._full_moments``. Two grouped SpMM
    passes (sum, sumsq), each one psum."""

    view = _MeshDEView(op)
    sums = np.asarray(view._batch_spmm("col", codes, "sum"), np.float64)
    sumsq = np.asarray(view._batch_spmm("col", codes, "sumsq"), np.float64)
    sizes = np.bincount(codes, minlength=n_groups).astype(np.float64)
    safe = np.maximum(sizes, 1.0)[None, :]
    mean = sums / safe
    var = (sumsq - sums * mean) / np.maximum(sizes - 1.0, 1.0)[None, :]
    return sizes, mean, np.maximum(var, 0.0)


def mesh_rank_genes_groups(
    op: ShardedSpMM,
    labels: Sequence,
    *,
    method: str = "t-test",
    groups="all",
    reference: str = "rest",
    var_names: Optional[Sequence] = None,
    n_genes: Optional[int] = None,
    log1p_input: bool = True,
    pts: bool = False,
):
    """Mesh edition of :func:`~single_algebra_tpu.de.rank_genes_groups`
    for the grouped-moment methods ('t-test' /
    't-test_overestim_var'): moments come from one-hot SpMM over the
    mesh, the p-length Welch/BH assembly is shared host code. The
    rank-based and iterative methods (wilcoxon / logreg) need per-entry
    passes and stay single-device."""

    from ..de import rank_genes_groups

    if method not in ("t-test", "t-test_overestim_var"):
        raise ValueError(
            f"method {method!r} is not supported on the mesh (grouped-"
            "moment t-tests only; run wilcoxon/logreg single-device)"
        )
    return rank_genes_groups(
        _MeshDEView(op), labels,
        method=method, groups=groups, reference=reference,
        var_names=var_names, n_genes=n_genes, log1p_input=log1p_input,
        pts=pts,
    )
