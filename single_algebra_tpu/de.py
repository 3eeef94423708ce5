"""Differential expression: ``rank_genes_groups`` over device kernels.

The post-clustering step every scRNA pipeline runs (scanpy's
``tl.rank_genes_groups``), built accelerator-first on this library's primitives:

* **t-test / t-test_overestim_var** — per-group means and variances
  (zeros included) come from the grouped one-hot SpMM stats
  (``SparseMatrix._batch_spmm``): one matmul pass per moment for ALL
  groups, O(nnz * n_groups) total, no densify. The reference exposes
  the same grouped-moment machinery as its ``*_batch`` trait ops
  (``/root/reference/src/sparse/mod.rs:172-208``); this module is the
  consumer those ops exist for.
* **wilcoxon** — rank-sum z-scores with exact tie correction. Genes are
  processed in column blocks: each block is scatter-densified to
  ``[B, n]`` on device, tie-run bounds come from ONE key-value sort plus
  cumulative scans (scattered back through the carried slot index), and
  per-group rank sums reduce with one one-hot matmul. No
  [n, n] anything; peak memory is a few ``[B, n]`` f32 buffers.

Only p-length statistics reach the host; p-value transforms (Student-t /
normal survival functions, Benjamini-Hochberg) are p-length host work.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["rank_genes_groups", "DEResult", "marker_gene_overlap"]


@dataclasses.dataclass
class DEResult:
    """Per-group differential expression tables.

    Every field maps group name -> array of length ``n_genes_ranked``,
    sorted by decreasing score (scanpy's layout, minus the recarray).
    """

    names: Dict  # group -> gene names (or int indices)
    scores: Dict  # group -> test statistic (t or z)
    pvals: Dict
    pvals_adj: Dict
    logfoldchanges: Dict  # log2 fold change, scanpy semantics
    method: str
    reference: str
    pts: Optional[Dict] = None  # group -> fraction expressing (pts=True)
    pts_rest: Optional[Dict] = None

    def group(self, name) -> Dict[str, np.ndarray]:
        """One group's table as a dict of columns."""

        out = {
            "names": self.names[name],
            "scores": self.scores[name],
            "pvals": self.pvals[name],
            "pvals_adj": self.pvals_adj[name],
            "logfoldchanges": self.logfoldchanges[name],
        }
        if self.pts is not None:
            out["pts"] = self.pts[name]
            out["pts_rest"] = self.pts_rest[name]
        return out

    def filter(
        self,
        *,
        min_fold_change: float = 1.0,
        min_in_group_fraction: float = 0.25,
        max_out_group_fraction: float = 0.5,
    ) -> "DEResult":
        """Keep markers passing effect-size/expression cutoffs (scanpy
        ``tl.filter_rank_genes_groups``). Requires ``pts=True`` at rank
        time; rows failing any cutoff are dropped per group.
        ``min_fold_change`` is the RAW fold change (scanpy semantics:
        the stored log2 fold change must be >= log2(min_fold_change))."""

        if self.pts is None:
            raise ValueError(
                "filter() needs pts: rerun rank_genes_groups(pts=True)"
            )
        if min_fold_change <= 0:
            raise ValueError("min_fold_change must be positive")
        names, scores, pv, padj, lfc, pts, ptsr = (
            {}, {}, {}, {}, {}, {}, {},
        )
        for g in self.names:
            keep = (
                (self.logfoldchanges[g] >= np.log2(min_fold_change))
                & (self.pts[g] >= min_in_group_fraction)
                & (self.pts_rest[g] <= max_out_group_fraction)
            )
            names[g] = self.names[g][keep]
            scores[g] = self.scores[g][keep]
            pv[g] = self.pvals[g][keep]
            padj[g] = self.pvals_adj[g][keep]
            lfc[g] = self.logfoldchanges[g][keep]
            pts[g] = self.pts[g][keep]
            ptsr[g] = self.pts_rest[g][keep]
        return DEResult(
            names, scores, pv, padj, lfc, self.method, self.reference,
            pts, ptsr,
        )


def marker_gene_overlap(
    de: "DEResult",
    reference_markers: Dict,
    *,
    top_n: Optional[int] = 100,
    method: str = "overlap_count",
) -> Dict:
    """Score each DE group's top markers against known marker sets
    (scanpy ``tl.marker_gene_overlap``): cell-type annotation by marker
    agreement. ``reference_markers`` maps cell-type name -> iterable of
    gene names/ids. ``method``: 'overlap_count', 'overlap_coef'
    (|A∩B| / min(|A|, |B|)), or 'jaccard'. Returns
    ``{cell_type: {group: score}}`` (host arithmetic over the already
    ranked tables)."""

    if method not in ("overlap_count", "overlap_coef", "jaccard"):
        raise ValueError(f"unknown method {method!r}")
    if not reference_markers:
        raise ValueError("reference_markers is empty")
    out: Dict = {}
    groups = {
        g: set(
            np.asarray(v[:top_n] if top_n is not None else v).tolist()
        )
        for g, v in de.names.items()
    }
    for ct, markers in reference_markers.items():
        ref = set(np.asarray(list(markers)).tolist())
        if not ref:
            raise ValueError(f"marker set for {ct!r} is empty")
        row = {}
        for g, sel in groups.items():
            inter = len(sel & ref)
            if method == "overlap_count":
                row[g] = float(inter)
            elif method == "overlap_coef":
                row[g] = inter / max(min(len(sel), len(ref)), 1)
            else:
                row[g] = inter / max(len(sel | ref), 1)
        out[ct] = row
    return out


# ----------------------------------------------------------------------
# shared host helpers
# ----------------------------------------------------------------------


def _bh_adjust(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg FDR over one group's p-vector."""

    p = np.asarray(pvals, np.float64)
    m = p.size
    order = np.argsort(p)
    ranked = p[order] * m / np.arange(1, m + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(m, np.float64)
    out[order] = np.minimum(ranked, 1.0)
    return out


def _log2_fold_change(mean_g, mean_rest, expm1: bool) -> np.ndarray:
    """scanpy's logfoldchanges: log2((expm1(m1)+1e-9)/(expm1(m2)+1e-9)).

    ``expm1=False`` skips the de-logging for raw (non-log) input.
    """

    a, b = np.asarray(mean_g, np.float64), np.asarray(mean_rest, np.float64)
    if expm1:
        a, b = np.expm1(a), np.expm1(b)
    return np.log2((a + 1e-9) / (b + 1e-9))


def _full_moments(m, codes: np.ndarray, n_groups: int):
    """Per-group per-gene (size, mean, Bessel var) with zeros included.

    Three grouped SpMM passes (sum, sumsq, implicit count from sizes).
    Returns f64 host arrays [p, G].
    """

    sums = np.asarray(m._batch_spmm("col", codes, "sum"), np.float64)
    sumsq = np.asarray(m._batch_spmm("col", codes, "sumsq"), np.float64)
    sizes = np.bincount(codes, minlength=n_groups).astype(np.float64)
    safe = np.maximum(sizes, 1.0)[None, :]
    mean = sums / safe
    var = (sumsq - sums * mean) / np.maximum(sizes - 1.0, 1.0)[None, :]
    return sizes, mean, np.maximum(var, 0.0)


def _welch(m1, v1, n1, m2, v2, n2, overestim: bool):
    """Welch t statistic + two-sided p (t distribution, WS dof)."""

    from scipy import stats

    # t-test_overestim_var charges the rest's variance at the GROUP's
    # size — deliberately conservative for small groups (scanpy's
    # method of the same name).
    d1 = v1 / n1
    d2 = v2 / (n1 if overestim else n2)
    denom = np.sqrt(d1 + d2)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(denom > 0, (m1 - m2) / np.where(denom > 0, denom, 1.0), 0.0)
        dof_num = (d1 + d2) ** 2
        dof_den = d1 * d1 / max(n1 - 1.0, 1.0) + d2 * d2 / max(n2 - 1.0, 1.0)
        dof = np.where(dof_den > 0, dof_num / np.where(dof_den > 0, dof_den, 1.0), 1.0)
    pv = 2.0 * stats.t.sf(np.abs(t), np.maximum(dof, 1.0))
    return t, pv


# ----------------------------------------------------------------------
# wilcoxon device kernels
# ----------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_out",))
def _rank_block_sparse(ed, ei, nz, member, col_map, n1, n_member,
                       n_out: int):
    """Tie-averaged rank sums per (gene, group) for one gene block,
    computed on the STORED entries only.

    ``ed``/``ei``/``nz``: gene-major ELL block [B, W] + per-gene stored
    counts; ``member`` [n] bool; ``col_map`` [n] int32 output column per
    cell (``n_out`` = dropped); ``n1`` [n_out] member count per group;
    ``n_member`` scalar member count.

    The member zeros — implicit AND stored 0.0s — form one analytic tie
    group, so the sort runs over W = max stored-per-gene slots instead
    of n cells (the dense formulation sorted [B, n]: ~10-20x more sort
    work at scRNA sparsity, and it needed the densify pass first).
    Negative stored values rank below the zero group correctly.

    Returns (ranksum [B, n_out], tie_term [B]) with tie_term =
    sum over tie groups of t^3 - t among members.
    """

    B, W = ed.shape
    dt = ed.dtype
    w_iota = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    valid = w_iota < nz[:, None]
    mem_slot = valid & jnp.take(member, ei, axis=0, mode="clip")
    big = jnp.asarray(jnp.inf, dt)
    x = jnp.where(mem_slot, ed, big)

    # per-element tie-run bounds from ONE key-value sort + cumulative
    # scans, scattered back by the carried slot index. (A vmapped
    # searchsorted pair computes the same bounds but lowers to
    # binary-search gather loops, far slower than the one sort.)
    s, si = jax.lax.sort_key_val(x, w_iota, dimension=-1)
    jpos = w_iota  # [B, W] position index, reused
    newrun = jnp.concatenate(
        [jnp.ones((B, 1), bool), s[:, 1:] != s[:, :-1]], axis=1
    )
    left_sorted = jax.lax.cummax(
        jnp.where(newrun, jpos, 0), axis=1
    ).astype(dt)
    endrun = jnp.concatenate(
        [s[:, 1:] != s[:, :-1], jnp.ones((B, 1), bool)], axis=1
    )
    right_sorted = jnp.flip(
        jax.lax.cummin(
            jnp.flip(jnp.where(endrun, jpos + 1, W), axis=1), axis=1
        ),
        axis=1,
    ).astype(dt)
    b_iota = jax.lax.broadcasted_iota(jnp.int32, (B, W), 0)
    left_s = jnp.zeros((B, W), dt).at[b_iota, si].set(left_sorted)
    right_s = jnp.zeros((B, W), dt).at[b_iota, si].set(right_sorted)

    s_cnt = jnp.sum(mem_slot, axis=1)
    z_impl = (n_member - s_cnt).astype(dt)  # implicit member zeros
    left = left_s + z_impl[:, None] * (x > 0)
    right = right_s + z_impl[:, None] * (x >= 0)
    ranks = jnp.where(mem_slot, 0.5 * (left + right + 1.0), 0.0)

    # zero tie group (stored member 0.0s merge with the implicit zeros):
    # bounds are plain mask counts — x is +inf on non-member slots
    l0 = jnp.sum(x < 0, axis=1).astype(dt)
    r0 = jnp.sum(x <= 0, axis=1).astype(dt) + z_impl
    rank0 = 0.5 * (l0 + r0 + 1.0)
    t0 = r0 - l0

    t = right - left
    tie = jnp.sum(
        jnp.where(mem_slot, t * t - 1.0, 0.0), axis=1
    ) + z_impl * (t0 * t0 - 1.0)

    # per-(gene, group) sums via scatter-add (no [B, W, G] gather)
    b_iota = jax.lax.broadcasted_iota(jnp.int32, (B, W), 0)
    tgt = jnp.where(mem_slot, jnp.take(col_map, ei, axis=0, mode="clip"),
                    n_out)
    ranksum_stored = jnp.zeros((B, n_out), dt).at[b_iota, tgt].add(
        ranks, mode="drop"
    )
    cnt = jnp.zeros((B, n_out), dt).at[b_iota, tgt].add(
        jnp.where(mem_slot, 1.0, 0.0), mode="drop"
    )
    ranksum = ranksum_stored + rank0[:, None] * (n1[None, :] - cnt)
    return ranksum, tie


def _wilcoxon_scores(
    m,
    codes: np.ndarray,
    group_ids: Sequence[int],
    ref_id: Optional[int],
    n_groups: int,
    *,
    tie_correct: bool,
    block: Optional[int],
):
    """z-scores [p, len(group_ids)] for wilcoxon, blocked over genes."""

    from scipy import stats

    n, p = m.shape
    mc = m._layout_for("col")  # gene-major ELL
    W = mc.ell_data.shape[1]
    if block is None:
        # sort/search buffers are [B, W] now — budget ~2 GB over ~8 of
        # them; W is the max stored-per-gene count, not n
        block = int(
            max(16, min(4096, (2 * 1024**3) // (8 * 4 * max(W, 1))))
        )

    if ref_id is None:  # vs rest: one ranking over ALL cells
        col_of = np.full(n_groups, len(group_ids), np.int32)
        for j, g in enumerate(group_ids):
            col_of[g] = j
        plans = [(np.ones(n, bool), col_of[codes], list(range(len(group_ids))))]
    else:  # vs a reference group: one ranking per (group, ref) pair
        plans = []
        for j, g in enumerate(group_ids):
            mask = (codes == g) | (codes == ref_id)
            cmap = np.where(codes == g, 0, 1).astype(np.int32)
            plans.append((mask, cmap, [j]))

    z = np.zeros((p, len(group_ids)), np.float64)
    for mask, cmap, outcols in plans:
        mask_d = jnp.asarray(mask)
        cmap_d = jnp.asarray(cmap)
        n_sub = float(mask.sum())
        n1 = np.asarray(
            [float(((codes == group_ids[c]) & mask).sum()) for c in outcols]
        )
        n2 = n_sub - n1
        n1_d = jnp.asarray(n1, mc.ell_data.dtype)
        n_mem_d = jnp.asarray(n_sub, mc.ell_data.dtype)
        rsums = np.zeros((p, len(outcols)), np.float64)
        ties = np.zeros(p, np.float64)
        for j0 in range(0, p, block):
            j1 = min(j0 + block, p)
            rs, tt = _rank_block_sparse(
                mc.ell_data[j0:j1], mc.ell_ids[j0:j1], mc.row_nnz[j0:j1],
                mask_d, cmap_d, n1_d, n_mem_d, len(outcols),
            )
            rsums[j0:j1] = np.asarray(rs, np.float64)
            ties[j0:j1] = np.asarray(tt, np.float64)
        expected = n1[None, :] * (n_sub + 1.0) / 2.0
        base = n_sub + 1.0
        if tie_correct and n_sub > 1:
            base = base - ties[:, None] / (n_sub * (n_sub - 1.0))
        sd = np.sqrt(np.maximum(n1 * n2 / 12.0 * base, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            zz = np.where(sd > 0, (rsums - expected) / np.where(sd > 0, sd, 1.0), 0.0)
        z[:, outcols] = zz
    pv = 2.0 * stats.norm.sf(np.abs(z))
    return z, pv


# ----------------------------------------------------------------------
# logreg scores (scanpy's third method)
# ----------------------------------------------------------------------


def _logreg_scores(
    m, codes: np.ndarray, n_groups: int, *, lam: float, iters: int,
    lr: float, seed: int,
):
    """Multinomial logistic regression coefficients [p, G].

    Full-batch Nesterov gradient descent, one jitted lax.fori_loop:
    forward = sparse SpMM (X @ W), gradient = transposed SpMM
    (X^T (softmax - Y) / n) + ridge. scanpy's 'logreg' runs sklearn's
    LBFGS on CPU; here both hot products ride the device SpMM kernels.
    """

    import jax
    import jax.numpy as jnp

    n, p = m.shape
    Y = jnp.asarray(np.eye(n_groups, dtype=np.float32)[codes])  # [n, G]
    key = jax.random.PRNGKey(seed)
    W0 = 0.01 * jax.random.normal(key, (p, n_groups), jnp.float32)
    b0 = jnp.zeros((n_groups,), jnp.float32)

    mr = m._layout_for("row")
    mc = m._layout_for("col")

    from .ops.spmm import ell_spmm

    def forward(W, b):
        return ell_spmm(mr.ell_data, mr.ell_ids, W)[:n] + b[None, :]

    def grads(W, b):
        logits = forward(W, b)
        logits = logits - logits.max(axis=1, keepdims=True)
        P = jnp.exp(logits)
        P = P / P.sum(axis=1, keepdims=True)
        D = (P - Y) / n  # [n, G]
        gW = ell_spmm(mc.ell_data, mc.ell_ids, D)[:p] + lam * W
        return gW, D.sum(axis=0)

    def body(_, state):
        W, b, vW, vb = state
        gW, gb = grads(W + 0.9 * vW, b + 0.9 * vb)
        vW = 0.9 * vW - lr * gW
        vb = 0.9 * vb - lr * gb
        return W + vW, b + vb, vW, vb

    W, b, _, _ = jax.lax.fori_loop(
        0, iters, body, (W0, b0, jnp.zeros_like(W0), jnp.zeros_like(b0))
    )
    return np.asarray(W, np.float64)


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------


def rank_genes_groups(
    m,
    labels: Sequence,
    *,
    method: str = "t-test",
    groups: str | Sequence = "all",
    reference: str = "rest",
    var_names: Optional[Sequence] = None,
    n_genes: Optional[int] = None,
    log1p_input: bool = True,
    tie_correct: bool = True,
    pts: bool = False,
    block: Optional[int] = None,
) -> DEResult:
    """Rank genes characterizing each group (scanpy's surface).

    Parameters
    ----------
    m : SparseMatrix [cells, genes], typically log1p-normalized counts.
    labels : group label per cell (length n).
    method : 't-test' | 't-test_overestim_var' | 'wilcoxon' | 'logreg'
        ('logreg' = multinomial logistic-regression coefficients as
        scores, scanpy semantics: no p-values — pvals fields are NaN).
    groups : 'all' or a subset of label values to test.
    reference : 'rest' (default) or one label value to compare against.
    var_names : gene names (defaults to integer indices).
    n_genes : truncate each group's ranking (default: all genes).
    log1p_input : data is log1p-scale — logfoldchanges de-log via expm1
        (scanpy semantics). Set False for raw-scale input.
    tie_correct : apply the exact tie correction to the wilcoxon
        variance (scipy's default; scanpy defaults this OFF).
    pts : also report the fraction of expressing cells per group and
        in the rest (scanpy's pts/pts_rest; one grouped count SpMM) —
        required by :meth:`DEResult.filter`.
    block : genes per device dispatch in the wilcoxon rank kernel;
        ``None`` sizes it so the ~8 [block, W] f32 work buffers (W = max
        stored entries per gene — the rank kernel sorts stored entries
        only) stay within ~2 GB of device memory (min 16, max 4096).
    """

    if method not in (
        "t-test", "t-test_overestim_var", "wilcoxon", "logreg"
    ):
        raise ValueError(f"Unknown method {method!r}")
    n, p = m.shape
    names, codes = m._batch_codes(list(labels), n, "row")
    n_groups = len(names)
    if reference != "rest" and reference not in names:
        raise ValueError(f"reference {reference!r} is not a label value")
    if groups == "all":
        sel = [g for g in names if g != reference]
    else:
        missing = [g for g in groups if g not in names]
        if missing:
            raise ValueError(f"groups {missing!r} are not label values")
        sel = [g for g in groups if g != reference]
    if not sel:
        raise ValueError("No groups left to test against the reference")
    gid = {g: i for i, g in enumerate(names)}
    group_ids = [gid[g] for g in sel]
    ref_id = None if reference == "rest" else gid[reference]

    sizes, mean, var = _full_moments(m, codes, n_groups)
    tot_size = sizes.sum()
    tot_sum = mean * sizes[None, :]

    if var_names is None:
        var_names = np.arange(p)
    var_names = np.asarray(var_names)
    if var_names.shape[0] != p:
        raise ValueError(
            f"var_names length ({var_names.shape[0]}) != n_genes ({p})"
        )
    k = p if n_genes is None else min(int(n_genes), p)

    if method == "wilcoxon":
        scores, pvals = _wilcoxon_scores(
            m, codes, group_ids, ref_id, n_groups,
            tie_correct=tie_correct, block=block,
        )
    elif method == "logreg":
        if ref_id is None:
            W = _logreg_scores(
                m, codes, n_groups, lam=1e-4, iters=300, lr=1.0, seed=0
            )
            scores = W[:, group_ids]
        else:
            sub_mask = np.isin(codes, group_ids + [ref_id])
            msub = m.select_rows(sub_mask)
            sub_groups = group_ids + [ref_id]
            remap = {g: i for i, g in enumerate(sub_groups)}
            sub_codes = np.asarray(
                [remap[c] for c in codes[sub_mask]], np.int32
            )
            W = _logreg_scores(
                msub, sub_codes, len(sub_groups),
                lam=1e-4, iters=300, lr=1.0, seed=0,
            )
            scores = W[:, : len(group_ids)]
        pvals = np.full_like(scores, np.nan)

    out_names, out_scores, out_p, out_padj, out_lfc = {}, {}, {}, {}, {}
    out_pts, out_ptsr = ({}, {}) if pts else (None, None)
    if pts:
        gcnt = np.asarray(
            m._batch_spmm("col", codes, "count"), np.float64
        )  # [p, G]
        tot_cnt = gcnt.sum(axis=1)
    for j, g in enumerate(sel):
        i = gid[g]
        n1, m1, v1 = sizes[i], mean[:, i], var[:, i]
        if ref_id is None:
            n2 = tot_size - n1
            s2 = tot_sum.sum(axis=1) - tot_sum[:, i]
            m2 = s2 / max(n2, 1.0)
            # pooled rest variance from total sumsq - group sumsq
            ssq_tot = (var * np.maximum(sizes - 1.0, 1.0)[None, :]
                       + tot_sum * mean).sum(axis=1)
            ssq_g = v1 * max(n1 - 1.0, 1.0) + tot_sum[:, i] * m1
            v2 = np.maximum(
                (ssq_tot - ssq_g - s2 * m2) / max(n2 - 1.0, 1.0), 0.0
            )
        else:
            n2, m2, v2 = sizes[ref_id], mean[:, ref_id], var[:, ref_id]

        if method in ("wilcoxon", "logreg"):
            sc, pv = scores[:, j], pvals[:, j]
        else:
            sc, pv = _welch(
                m1, v1, n1, m2, v2, n2,
                overestim=(method == "t-test_overestim_var"),
            )
        padj = pv if np.isnan(pv).all() else _bh_adjust(pv)
        lfc = _log2_fold_change(m1, m2, expm1=log1p_input)
        order = np.argsort(-sc, kind="stable")[:k]
        out_names[g] = var_names[order]
        out_scores[g] = np.asarray(sc, np.float64)[order]
        out_p[g] = pv[order]
        out_padj[g] = padj[order]
        out_lfc[g] = lfc[order]
        if pts:
            frac_in = gcnt[:, i] / max(n1, 1.0)
            if ref_id is None:
                frac_out = (tot_cnt - gcnt[:, i]) / max(tot_size - n1, 1.0)
            else:
                frac_out = gcnt[:, ref_id] / max(sizes[ref_id], 1.0)
            out_pts[g] = frac_in[order]
            out_ptsr[g] = frac_out[order]

    return DEResult(
        names=out_names,
        scores=out_scores,
        pvals=out_p,
        pvals_adj=out_padj,
        logfoldchanges=out_lfc,
        method=method,
        reference=reference,
        pts=out_pts,
        pts_rest=out_ptsr,
    )
