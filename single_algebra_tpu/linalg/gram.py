"""Gram-matrix PCA engine: exact PCA in two data passes, row-bucketed.

A randomized-SVD fit makes ~32 sparse products; for tall-skinny matrices
(n >> p, p small enough that the p x p Gram matrix fits on the device)
the classic covariance method needs only two passes over the data:

1. **Densify-and-contract once**: row slabs of the column-tiled payload are
   expanded to dense ``D_s [p, S]`` tiles (``ops.tiled.tiled_ell_densify_t``,
   one XLA scatter) and immediately contracted ``G += D_s @ D_s^T`` on the
   tensor cores inside a ``lax.fori_loop``. The contraction runs in int8 or
   bf16 when the values allow it exactly (raw counts always do).
2. **Solve in p-space**: eigenvectors of the (optionally centered) Gram
   matrix are the right singular vectors of A; ``eig(G_c) = s^2``. Small
   Grams (p <= 4096) get an exact ``eigh``; larger ones the jitted
   randomized solve over a rank-1-centered operator.
3. **Project**: ``T = A V - 1 (mu^T V)`` with a second slab-densify pass
   (the dense slabs are never materialized in full).

**Row bucketing** (the padding killer): a single global layout pads every
(row, tile) group to the width of the heaviest row, so one dense row
multiplies the densify work of EVERY row. Here rows are sorted into
width classes (8, 16, 32, ... slots/tile) and each bucket gets its own
payload densified at its own width, so the densify cost tracks the
per-row structure instead of the global max. G is row-order invariant, so
bucketing is free there; products/projections gather through a stored
permutation (one [n, k] take).

The Gram matrix is computed once per matrix and cached, so repeated fits
(different k, masks, seeds) cost only the tiny p-space solve plus one
projection pass. A boolean feature mask is a SUBMATRIX of the cached G —
masked PCA at scale reuses the same two-pass machinery.

Semantic map to the reference: this is an exact implementation of the PCA
the reference computes approximately (randomized path,
``src/dimred/pca/sparse/mod.rs:170-179``); with ``center_svd=False`` it is
the truncated SVD of raw X (the reference's Lanczos-path semantics,
SURVEY.md §3.2).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import MATMUL_PRECISION, PowerIterationNormalizer
from .operators import DenseOperator
from .svd import randomized_svd, svd_flip

__all__ = [
    "GramPCAEngine",
    "gram_matrix",
    "gram_pca_graph",
    "gram_tier",
    "topk_psd_eigh",
    "solve_gram_topk",
]

# rows densified per Gram/projection step (large-n regime); untuned on
# the GPU
_SLAB = 8192


def _slab_for(n: int) -> int:
    """Row-slab granularity: full ``_SLAB`` at scale, 1024 for small inputs
    so per-bucket padding stays proportionate."""

    return _SLAB if n >= 65536 else 1024


def _width_class(w: int) -> int:
    """Bucket width: the next power-of-two multiple of 8 >= w."""

    c = 8
    while c < w:
        c *= 2
    return c


def width_classes_np(w: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_width_class` over an int array (a Python-level
    per-row loop is seconds of interpreted work at 10M rows). Exact
    integer doubling — no float-log edge cases at powers of two."""

    w = np.asarray(w, np.int64)
    out = np.full(w.shape, 8, np.int64)
    mask = out < w
    while mask.any():
        out[mask] <<= 1
        mask = out < w
    return out


def topk_psd_eigh(Gc: jnp.ndarray, k: int):
    """Exact top-k eigenpairs of a PSD matrix -> ``(s, vt)`` with
    ``s = sqrt(eig)`` and the V-based svd_flip sign convention. The robust
    choice for small Grams (pp <= ~4096): immune to flat spectra where
    subspace iteration stalls, and cheap at this size."""

    w, V = jnp.linalg.eigh(Gc)  # ascending
    s = jnp.sqrt(jnp.maximum(w[::-1][:k], 0.0))
    vt = V[:, ::-1][:, :k].T
    idx = jnp.argmax(jnp.abs(vt), axis=1)
    signs = jnp.sign(vt[jnp.arange(k), idx])
    signs = jnp.where(signs == 0, 1.0, signs).astype(vt.dtype)
    return s, vt * signs[:, None]


# Grams at or below this width get the exact eigh solve; above it, the
# jitted randomized solve over the rank-1-centered operator
EIGH_MAX_PP = 4096


def _solve_topk(
    Gs, mu, n, seed, *, k, center, oversamples=10, iters=6
):
    """Shared solve policy (traced): exact eigh for small Grams, the
    randomized solve over the rank-1-centered operator for large ones.
    Used by gram_pca_graph, the streaming PCA, and the sharded gram.

    ``oversamples``/``iters`` are treated as MINIMUMS on the large path:
    Rayleigh-Ritz eigenvalue error decays like (lam_{l+1}/lam_j)^(2q+1),
    so resolving the top k to the f32 floor (~1e-6) needs the sketch to
    extend well past k — a bare l = k+10 leaves ~1e-3-class leakage when
    eigengaps near rank k are modest. Each extra sketch column costs only
    one more column of products against the already-resident G, so the floor is
    cheap insurance."""

    n_f = jnp.asarray(n, jnp.float32)
    if Gs.shape[0] <= EIGH_MAX_PP:
        Gc = Gs - n_f * (mu[:, None] * mu[None, :]) if center else Gs
        return topk_psd_eigh(Gc, k)
    if center:
        # G_c = G - n mu mu^T as a rank-1 correction — never materialize
        # a second pp x pp array (at p=30k that copy alone is 3.8 GB)
        solve_op = _CenteredGram(Gs, mu, n_f)
    else:
        solve_op = DenseOperator(Gs)
    os_eff = max(oversamples, min(k + 14, max(Gs.shape[0] - k, 0)))
    it_eff = max(iters, 8)
    res = randomized_svd(
        solve_op, k, os_eff, it_eff,
        PowerIterationNormalizer.QR, seed=seed,
    )
    _, vt = svd_flip(res.u, res.vt, u_based_decision=False)
    s = jnp.sqrt(jnp.maximum(res.s, 0.0))
    return s, vt


@partial(jax.jit, static_argnames=("k", "center"))
def solve_gram_topk(G, mu, n, seed, *, k, center):
    """Jitted entry for the shared Gram solve (see :func:`_solve_topk`)."""

    return _solve_topk(G, mu, n, seed, k=k, center=center)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class _CenteredGram:
    """Symmetric operator ``G - c * mu mu^T`` (rank-1-centered Gram).

    ``mv`` deflates the operand against ``mu`` first: with
    ``beta = (mu^T B)/||mu||^2`` and ``Bp = B - mu beta``,

        Gc @ B = [G @ Bp - c mu (mu^T Bp)] + (Gc @ mu) beta

    where ``g_mu = Gc @ mu`` is computed once per solve (one extra
    matvec, cached on the operator's pytree leaves). Why: the direct
    form stores the f32 intermediate ``G @ B`` at the UNCENTERED scale —
    entries carry ``c mu_i (mu^T B)_k`` terms that the rank-1 correction
    then cancels, so every power iteration and the final sigma
    projection inherit ~``eps32 * |G@B|/|Gc@B|`` relative noise (a
    ~1e-6 solve plateau, see ``gram_matrix``'s f32-floor note). After deflation ``mu^T Bp ~ 0`` so ``G @ Bp`` is
    born at the centered scale; the only uncentered-scale rounding left
    is the one-time ``g_mu``, a single rank-1 direction whose error
    enters the spectrum via one projection instead of compounding per
    iteration.
    """

    G: jnp.ndarray
    mu: jnp.ndarray
    c: jnp.ndarray
    g_mu: jnp.ndarray | None = None  # cached Gc @ mu
    inv_mu2: jnp.ndarray | None = None  # 1 / max(||mu||^2, tiny)

    def __post_init__(self):
        if self.g_mu is None:
            mu2 = jnp.dot(self.mu, self.mu, precision=MATMUL_PRECISION)
            self.inv_mu2 = jnp.where(mu2 > 0, 1.0 / jnp.maximum(mu2, 1e-30), 0.0)
            self.g_mu = (
                jnp.dot(self.G, self.mu, precision=MATMUL_PRECISION)
                - self.c * self.mu * mu2
            )

    @property
    def shape(self):
        return self.G.shape

    def mv(self, B):
        beta = (
            jnp.dot(self.mu, B, precision=MATMUL_PRECISION) * self.inv_mu2
        )  # [k]
        Bp = B - self.mu[:, None] * beta[None, :]
        t = jnp.dot(self.mu, Bp, precision=MATMUL_PRECISION)  # ~0 residual
        return (
            jnp.dot(self.G, Bp, precision=MATMUL_PRECISION)
            - self.c * self.mu[:, None] * t[None, :]
            + self.g_mu[:, None] * beta[None, :]
        )

    rmv = mv  # symmetric

    def tree_flatten(self):
        return (self.G, self.mu, self.c, self.g_mu, self.inv_mu2), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GramPCAEngine:
    """Row-bucketed overflow-free tiled payloads + slab-densify machinery.

    ``bdata[c]``/``blocal[c]`` hold bucket c's transposed tiled payload
    ``[nt * wt_c, R_c]``; ``pos`` maps natural row -> bucketed position;
    ``gidx`` maps bucketed position -> natural row (n = padding sentinel).
    ``meta = (wt_max, ntiles, ct, exact, i8)`` (wt_max informational;
    ``i8`` = integer values in [-127, 127], gates the int8 Gram tier);
    ``bwidths`` the per-bucket (wt_c, R_c) pairs (static).
    """

    bdata: Tuple[jnp.ndarray, ...]
    blocal: Tuple[jnp.ndarray, ...]
    pos: jnp.ndarray  # [n] int32: natural row -> bucketed position
    gidx: jnp.ndarray  # [sum R_c] int32: bucketed position -> row (or n)
    shape: Tuple[int, int]
    meta: Tuple[int, int, int, bool, bool]
    bwidths: Tuple[Tuple[int, int], ...]

    COL_TILE = 256  # default; from_matrix picks adaptively (see below)
    COL_TILES = (256, 512, 1024)

    # -- capacity planning -------------------------------------------------

    @classmethod
    def _bucket_plan(cls, m, col_tile: int):
        """Host-side bucketing plan: list of (class_width, row_idx array)
        plus total payload bytes (values + ids + G + slab workspace).
        Cached per (matrix, col_tile): the O(nnz) width scan would
        otherwise repeat across fits()/choose_col_tile()/from_matrix()."""

        cache = getattr(m, "_gram_plan_cache", None)
        if cache is None:
            cache = m._gram_plan_cache = {}
        if col_tile in cache:
            return cache[col_tile]

        from ..sparse.convert import round_up, row_tile_widths

        src = m._layout_for("row")
        src._require_host_structure()
        n, p = m.shape
        slab = _slab_for(n)
        w_r = row_tile_widths(src._h_indptr, src._h_indices, n, col_tile)
        classes = width_classes_np(np.maximum(w_r, 1))
        ntiles = max(-(-p // col_tile), 1)
        pp = ntiles * col_tile
        plan, total = [], 0
        for c in np.unique(classes):
            rows = np.where(classes == c)[0]
            rc = round_up(len(rows), slab)
            plan.append((int(c), rows))
            total += ntiles * int(c) * rc * 8
        # G + two slab-dense workspace buffers; bf16-exact payloads
        # densify to bf16 (half the f32 workspace the old plan charged —
        # the overcount alone pushed the 1M x 30k north-star shape out of
        # budget and off this engine)
        try:
            if m.values_int8_exact():
                ws_item = 1  # int8 tier densifies to 1-byte slabs
            elif m.values_bf16_exact():
                ws_item = 2
            else:
                ws_item = 4
        except Exception:
            ws_item = 4
        total += pp * pp * 4 + pp * slab * ws_item * 2
        rb = _gram_block(pp)
        if rb is not None:
            # blocked symmetric path: the nb(nb+1)/2 independent pair
            # carries (~0.53 ppb^2 f32) coexist with the assembled G
            # during the scatter/mirror pass — in the rb-aligned case
            # too, which includes the flagship pp=30720=15*2048 shape
            ppb = -(-pp // rb) * rb
            nb = ppb // rb
            total += nb * (nb + 1) // 2 * rb * rb * 4
            if pp % rb:
                # plus the [ppb, ppb] assembly buffer: it coexists with
                # the [pp, pp] slice result (charged in the base term)
                # during the final slice (leaving it uncharged ran out
                # of memory at 1M x 30k, ct=512)
                total += ppb * ppb * 4
        cache[col_tile] = (plan, total, slab, ntiles)
        return cache[col_tile]

    @staticmethod
    def hbm_budget_bytes() -> int:
        """Usable device memory for the bucketed Gram plan. The plan
        already accounts for every large resident buffer (payload + G +
        the two slab workspaces), so only genuine XLA temporaries need
        headroom — a 0.8 fraction, unlike
        :meth:`DensifiedOperator.hbm_budget_bytes` whose 0.6 reserves the
        randomized solve's [n, k]-class sketch workspace on top of a
        payload-only estimate. The CPU reports no limit and gets a fixed
        12 GiB."""

        from .. import platform

        limit = platform.device_memory_limit()
        return 12 << 30 if limit is None else int(limit * 0.8)

    @classmethod
    def choose_col_tile(cls, m, budget_bytes: int | None = None):
        """Smallest column tile whose bucketed payload fits the device budget.
        Returns ``(col_tile, payload_bytes)`` — the cheapest candidate even
        when none fits, so callers decide via ``fits()``."""

        if budget_bytes is None:
            budget_bytes = cls.hbm_budget_bytes()
        best = None
        for ct in cls.COL_TILES:
            _, b, _, _ = cls._bucket_plan(m, ct)
            if best is None or b < best[1]:
                best = (ct, b)
            if b <= budget_bytes:
                return ct, b
        return best

    @classmethod
    def payload_bytes(cls, m) -> int:
        return cls.choose_col_tile(m)[1]

    @classmethod
    def fits(cls, m, budget_bytes: int | None = None) -> bool:
        n, p = m.shape
        if p > 40960:  # G itself would crowd out device memory
            return False
        if budget_bytes is None:
            budget_bytes = cls.hbm_budget_bytes()
        return cls.choose_col_tile(m, budget_bytes)[1] <= budget_bytes

    # -- construction ------------------------------------------------------

    @classmethod
    def from_matrix(cls, m) -> "GramPCAEngine":
        from ..sparse.convert import fill_class_payload, round_up

        n, p = m.shape
        ct, _ = cls.choose_col_tile(m)
        plan, _, slab, nt = cls._bucket_plan(m, ct)
        src = m._layout_for("row")
        src._require_host_structure()
        indptr, indices = src._h_indptr, src._h_indices
        vals = src._csr_data_host()
        exact = m.values_bf16_exact()

        bdata, blocal, bwidths = [], [], []
        pos = np.zeros(n, np.int64)
        gidx_parts = []
        offset = 0
        wt_max = 8
        for c, rows in plan:
            rc = round_up(len(rows), slab)
            td, tl = fill_class_payload(
                indptr, indices, vals, rows, p, ct, c, rc
            )
            bdata.append(jnp.asarray(td))
            blocal.append(jnp.asarray(tl))
            bwidths.append((c, rc))
            wt_max = max(wt_max, c)
            pos[rows] = offset + np.arange(len(rows))
            g = np.full(rc, n, np.int64)
            g[: len(rows)] = rows
            gidx_parts.append(g)
            offset += rc

        return cls(
            tuple(bdata),
            tuple(blocal),
            jnp.asarray(pos.astype(np.int32)),
            jnp.asarray(np.concatenate(gidx_parts).astype(np.int32)),
            (n, p),
            (wt_max, nt, ct, exact, m.values_int8_exact()),
            tuple(bwidths),
        )

    # -- slab machinery ----------------------------------------------------

    @property
    def n_padded(self) -> int:
        return sum(rc for _, rc in self.bwidths)

    @property
    def p_padded(self) -> int:
        return self.meta[1] * self.meta[2]

    def _densify(self, b: int, i, out_dtype):
        """Slab i of bucket b -> dense [Pp, slab]."""

        from ..ops.tiled import tiled_ell_densify_t

        nt, ct = self.meta[1], self.meta[2]
        wt, rc = self.bwidths[b]
        slab = _slab_for(self.shape[0])
        td = jax.lax.dynamic_slice(
            self.bdata[b], (0, i * slab), (self.bdata[b].shape[0], slab)
        )
        tl = jax.lax.dynamic_slice(
            self.blocal[b], (0, i * slab), (self.blocal[b].shape[0], slab)
        )
        return tiled_ell_densify_t(
            td, tl, wt=wt, ntiles=nt, col_tile=ct, out_dtype=out_dtype,
        )  # [Pp, slab]

    def _slab_dot(self, b: int, i, M, transposed: bool):
        """One slab product at full precision: ``D^T @ M`` ([slab, k],
        transposed=False) or ``D @ M_slab`` ([Pp, k], transposed=True)."""

        exact = self.meta[3]
        dims = (((0,), (0,)) if not transposed else ((1,), (0,)))
        if exact:
            from .operators import OPERAND_TERMS, bf16_terms

            D = self._densify(b, i, jnp.bfloat16)
            # 3-term operand split (2-term's ~2^-17 dropped residual is a
            # first-order sigma error — see DensifiedOperator._precise);
            # the barriers inside bf16_terms keep the simplifier from
            # folding f32->bf16->f32 to identity, which would zero the
            # residual terms
            dot = lambda v: jax.lax.dot_general(
                D, v,
                dimension_numbers=(dims, ((), ())),
                preferred_element_type=jnp.float32,
            )
            out = None
            for t in bf16_terms(M, OPERAND_TERMS):
                d = dot(t)
                out = d if out is None else out + d
            return out
        D = self._densify(b, i, jnp.float32)
        return jax.lax.dot_general(
            D, M,
            dimension_numbers=(dims, ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def _project_bucketed(self, Bp: jnp.ndarray) -> jnp.ndarray:
        """``A_perm @ B`` in bucketed row order -> [sum R_c, k] f32."""

        slab = _slab_for(self.shape[0])
        k = Bp.shape[1]
        outs = []
        for b, (_, rc) in enumerate(self.bwidths):
            def body(i, T, b=b):
                Ts = self._slab_dot(b, i, Bp, transposed=False)
                return jax.lax.dynamic_update_slice(T, Ts, (i * slab, 0))

            T0 = jnp.zeros((rc, k), jnp.float32)
            outs.append(jax.lax.fori_loop(0, rc // slab, body, T0))
        return jnp.concatenate(outs, axis=0)

    def mv(self, B):
        """A @ B via slab densify passes ([p, k] -> [n, k])."""

        Bp = jnp.pad(
            B.astype(jnp.float32), ((0, self.p_padded - B.shape[0]), (0, 0))
        )
        out = self._project_bucketed(Bp)
        return jnp.take(out, self.pos, axis=0).astype(B.dtype)

    def rmv(self, C):
        """A^T @ C via slab densify passes ([n, k] -> [p, k])."""

        slab = _slab_for(self.shape[0])
        k = C.shape[1]
        # route C rows into bucketed positions (padding slots read a zero
        # row appended at index n)
        Cx = jnp.concatenate(
            [C.astype(jnp.float32), jnp.zeros((1, k), jnp.float32)], axis=0
        )
        Cb = jnp.take(Cx, self.gidx, axis=0)  # [sum R_c, k]
        acc = jnp.zeros((self.p_padded, k), jnp.float32)
        offset = 0
        for b, (_, rc) in enumerate(self.bwidths):
            Cc = jax.lax.dynamic_slice(Cb, (offset, 0), (rc, k))

            def body(i, a, b=b, Cc=Cc):
                Cs = jax.lax.dynamic_slice(Cc, (i * slab, 0), (slab, k))
                return a + self._slab_dot(b, i, Cs, transposed=True)

            acc = jax.lax.fori_loop(0, rc // slab, body, acc)
            offset += rc
        return acc[: self.shape[1]].astype(C.dtype)

    def tree_flatten(self):
        return (self.bdata, self.blocal, self.pos, self.gidx), (
            self.shape, self.meta, self.bwidths,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    # -- cached Gram -------------------------------------------------------

    def gram_cached(self) -> jnp.ndarray:
        g = getattr(self, "_gram_cache", None)
        if g is None:
            g = gram_matrix(self)
            self._gram_cache = g
        return g


def _gram_block(pp: int) -> int | None:
    """Row-block size for the symmetric-half contraction, or ``None`` for
    one full dot (the 2x flop saving is noise below ~4k width, and the
    blocked graph costs ~nb^2/2 extra ops to compile). The slab is padded
    up to a block multiple — zero rows contribute exact zeros to G.

    2048 was chosen on a 16 GB accelerator and is untuned on the GPU: a
    larger block does ~(ppb^2 + ppb*rb)/2 flops against fewer operand
    re-reads, a smaller one raises the pair count and the carries'
    bookkeeping."""

    return 2048 if pp > 4096 else None


def gram_tier(eng: GramPCAEngine) -> str:
    """The contraction tier :func:`gram_matrix` uses: ``'int8'``,
    ``'bf16'`` or ``'f32'``.

    int8: integer values in [-127, 127] (raw counts, the dominant scRNA
    case) make int8 x int8 -> int32 slab products EXACT (slab <= 8192
    terms x 127^2 < 2^31) at half the densified-slab traffic of bf16."""

    exact, i8 = eng.meta[3], eng.meta[4]
    if exact and i8 and _slab_for(eng.shape[0]) * 127 ** 2 < 2 ** 31:
        return "int8"
    return "bf16" if exact else "f32"


@partial(jax.jit, static_argnames=("sym", "rb"))
def gram_matrix(
    eng: GramPCAEngine, *, sym: bool = True, rb: int | None = None
) -> jnp.ndarray:
    """``A^T A`` as ``[Pp, Pp]`` f32 — slab densify + tensor-core
    contraction.

    Row-order invariant, so bucketing needs no permutation here. Three
    value tiers, chosen by what the stored values support (gates in
    ``SparseMatrix.values_int8_exact`` / ``values_bf16_exact``):

    - **int8** (integers in [-127, 127] — raw counts, the dominant scRNA
      case): slabs densify to 1-byte tiles and contract int8 x int8 ->
      int32 with EXACT per-slab products (slab <= 8192 terms x 127^2 <
      2^31); the int32 partial is cast to f32 (rounding partials above
      2^24) and folds into the f32 cross-slab carry, the same accumulation
      class as bf16.
    - **bf16** (bf16-exact values, e.g. counts <= 256): native-bf16
      contraction, exact products.
    - **f32** (general values): f32 slabs, HIGHEST-precision contraction
      (full f32, no TF32; still one data pass overall).

    **Symmetric-half contraction** (``sym=True``, the default for wide
    Grams): ``D @ D^T`` is symmetric, so only the lower-triangular block
    pairs are computed — ``G[r, c] += D_r @ D_c^T`` for r >= c with
    2048-row blocks — and the strict-lower blocks are mirrored once at
    the end. nb(nb+1)/2 of nb^2 block products ≈ 0.53x the flops of the
    naive full dot at pp = 30,720; the pass is flops-bound (the densify
    moves ~pp * slab bytes per slab against ~pp^2 * slab flops), so the
    saving is real wall time.

    f32 floor note: cross-slab accumulation drifts ~eps*sqrt(n_slabs) and
    the randomized large-Gram solve itself plateaus near ~1e-6 relative
    on eigenvalues. Kahan-compensating the accumulation would need three
    [pp, pp] buffers live and cannot push the combined error below the
    solve's own f32 floor; sub-1e-6 at wide shapes needs the f64 path
    (x64 mode).
    """

    exact = eng.meta[3]
    i8 = gram_tier(eng) == "int8"
    pp = eng.p_padded
    slab = _slab_for(eng.shape[0])

    def slab_dense(b, i):
        if i8:
            return eng._densify(b, i, jnp.int8)
        if exact:
            return eng._densify(b, i, jnp.bfloat16)
        return eng._densify(b, i, jnp.float32)

    def _self_dot(D):
        if i8:
            return jax.lax.dot_general(
                D, D,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            ).astype(jnp.float32)
        if exact:
            return jax.lax.dot_general(
                D, D,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        return jax.lax.dot_general(
            D, D,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def full_dot(D, acc):
        return acc + _self_dot(D)

    if rb is None:
        rb = _gram_block(pp) if sym else None
    elif not sym:
        rb = None
    if rb is None:
        G = jnp.zeros((pp, pp), jnp.float32)
        for b, (_, rc) in enumerate(eng.bwidths):
            def body(i, G, b=b):
                return full_dot(slab_dense(b, i), G)

            G = jax.lax.fori_loop(0, rc // slab, body, G)
        return G

    ppb = -(-pp // rb) * rb
    nb = ppb // rb
    prec = None if exact else jax.lax.Precision.HIGHEST
    pairs = [(r, c) for r in range(nb) for c in range(r + 1)]

    def _pair_dot(a, b):
        if i8:
            return jax.lax.dot_general(
                a, b,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            ).astype(jnp.float32)
        return jax.lax.dot_general(
            a, b,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=prec,
        )

    # each lower-triangular block pair accumulates in its OWN carry: with
    # a single [pp, pp] carry the per-pair dynamic_update_slice chain
    # serializes all nb(nb+1)/2 dots through one buffer; with independent
    # carries each dot fuses with its own add. The pair carries total
    # ~0.53 pp^2 f32 — LESS than one padded G
    S = tuple(
        jnp.zeros((rb, rb), jnp.float32) for _ in range(len(pairs))
    )
    for b, (_, rc) in enumerate(eng.bwidths):
        def body(i, S, b=b):
            D = slab_dense(b, i)
            if ppb != pp:
                D = jnp.pad(D, ((0, ppb - pp), (0, 0)))
            blocks = [
                jax.lax.dynamic_slice(D, (r * rb, 0), (rb, slab))
                for r in range(nb)
            ]
            out = []
            for idx, (r, c) in enumerate(pairs):
                out.append(S[idx] + _pair_dot(blocks[r], blocks[c]))
            return tuple(out)

        S = jax.lax.fori_loop(0, rc // slab, body, S)

    # assemble: scatter the pair blocks into G and mirror the strict-lower
    # ones — one pass of block-sized copies (a whole-G tril/transpose
    # would need two more [pp, pp] buffers)
    G = jnp.zeros((ppb, ppb), jnp.float32)
    for idx, (r, c) in enumerate(pairs):
        G = jax.lax.dynamic_update_slice(G, S[idx], (r * rb, c * rb))
        if r != c:
            G = jax.lax.dynamic_update_slice(G, S[idx].T, (c * rb, r * rb))
    return G[:pp, :pp] if ppb != pp else G


@partial(
    jax.jit,
    static_argnames=(
        "k",
        "center_svd",
        "center_T",
        "want_transform",
        "solver_oversamples",
        "solver_iters",
    ),
)
def gram_pca_graph(
    eng: GramPCAEngine,
    G: jnp.ndarray,
    mean: jnp.ndarray,  # [p] (zeros when uncentered)
    seed,
    *,
    k: int,
    center_svd: bool,
    center_T: bool,
    want_transform: bool,
    solver_oversamples: int = 10,
    solver_iters: int = 6,
    mask_idx: jnp.ndarray | None = None,
):
    """(s, vt, T) from the cached Gram matrix — one fused device dispatch.

    ``center_svd`` handles the rank-1 mean term (true PCA); ``center_T``
    centers the projection (the reference applies it even on the
    uncentered Lanczos path, SURVEY.md §3.2). ``mask_idx`` restricts
    features to a subset: the masked Gram is a submatrix.
    """

    n, p = eng.shape
    pp = G.shape[0]

    if mask_idx is not None:
        Gs = jnp.take(
            jnp.take(G, mask_idx, axis=0), mask_idx, axis=1
        )
        mu = jnp.take(
            jnp.pad(mean.astype(jnp.float32), (0, pp - mean.shape[0])),
            mask_idx,
        )
        p_out = mask_idx.shape[0]
    else:
        Gs = G
        mu = jnp.pad(mean.astype(jnp.float32), (0, pp - mean.shape[0]))
        p_out = p

    s, vt = _solve_topk(
        Gs, mu, n, seed, k=k, center=center_svd,
        oversamples=solver_oversamples, iters=solver_iters,
    )
    if mask_idx is None:
        vt_out = vt[:, :p_out]
    else:
        vt_out = vt

    T = None
    if want_transform:
        # scatter V back to padded full width for the slab projection
        if mask_idx is not None:
            Vp = jnp.zeros((pp, k), jnp.float32).at[mask_idx].set(vt.T)
        else:
            Vp = jnp.pad(vt.T, ((0, pp - vt.shape[1]), (0, 0)))

        # _slab_dot contracts orthonormal V as a bf16 hi+lo pair on exact
        # payloads (two bf16 passes, f32 accumulation) so no first-order
        # rounding enters the scores
        T = jnp.take(eng._project_bucketed(Vp), eng.pos, axis=0)
        if center_T:
            # mu and vt share the solve width (masked or padded-full)
            corr = jnp.dot(mu, vt.T, precision=MATMUL_PRECISION)  # [k]
            T = T - corr[None, :]
    return s, vt_out, T
