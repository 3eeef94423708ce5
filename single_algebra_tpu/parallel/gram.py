"""Row-sharded Gram-PCA engine: exact two-pass PCA over a device mesh.

The single-chip :class:`~single_algebra_tpu.linalg.gram.GramPCAEngine` does
exact PCA in two data passes (slab densify -> ``G += D D^T`` on the tensor cores,
p-space solve, one projection pass). Sharding it follows the same recipe as
the other engines: each device holds a contiguous row block's column-tiled
payload; the Gram accumulation is embarrassingly local with a single
``psum`` at the end (G is p x p — tiny next to the data); the solve runs
replicated; the projection is purely local (output row-sharded).

Collective cost per fit: ONE psum of ``[pp, pp]`` floats — independent of
n. This is the minimum-communication schedule for tall-skinny PCA (the
p-width statistics are the only cross-slab coupling).

**Row bucketing** (mirrors the single-chip engine): a uniform payload pads
every (row, tile) group to the width of the globally heaviest row, so one
dense row multiplies the densify work of EVERY row (2-5x padded work on
power-law scRNA profiles). Here each
device's rows are sorted into the GLOBAL width classes (8, 16, 32, ...
slots/tile) and every class gets its own ``[ndev, nt*c, Rc]`` stacked
payload (Rc = max per-device class population, slab-rounded) — shapes stay
uniform across devices, so the whole engine remains plain ``shard_map``
over stacked arrays. Natural row order is restored inside the local
projection body with one per-device gather (``pos_local``), so bucketing
adds NO collectives.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.tiled import tiled_ell_densify_t
from ..sparse import convert as _cv
from ..sparse.matrix import SparseMatrix

__all__ = ["ShardedGram", "sharded_gram_pca"]


def _local_gram(td, tl, *, wt, nt, ct, slab, exact, i8=False):
    """G contribution of one device's payload [nt*wt, Rs] (sum over its
    Rs/slab sub-slabs)."""

    rs = td.shape[1]
    pp = nt * ct

    def densify(i, out_dtype):
        tds = jax.lax.dynamic_slice(td, (0, i * slab), (td.shape[0], slab))
        tls = jax.lax.dynamic_slice(tl, (0, i * slab), (tl.shape[0], slab))
        return tiled_ell_densify_t(
            tds, tls, wt=wt, ntiles=nt, col_tile=ct, out_dtype=out_dtype,
        )

    def body(i, G):
        # int8 tier: exact int8 x int8 -> int32 slab products (slab <=
        # 8192 terms x 127^2 < 2^31), int32 partial folded into the f32
        # carry — see linalg/gram.py
        if i8 and exact and slab * 127 ** 2 < 2 ** 31:
            D = densify(i, jnp.int8)
            return G + jax.lax.dot_general(
                D, D, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            ).astype(jnp.float32)
        if exact:
            D = densify(i, jnp.bfloat16)
            return G + jax.lax.dot_general(
                D, D, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        D = densify(i, jnp.float32)
        return G + jax.lax.dot_general(
            D, D, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    # the carry starts from slab 0 (not zeros), so it has the payload's
    # sharding type inside the shard_map body
    G0 = body(0, jnp.zeros((), jnp.float32))
    return jax.lax.fori_loop(1, rs // slab, body, G0)


def _local_project(td, tl, Vp, *, wt, nt, ct, slab):
    """[Rs, k] local projection ``D^T V`` of one device-class payload
    (bucketed row order; centering applied by the caller after the
    natural-order gather)."""

    rs = td.shape[1]
    k = Vp.shape[1]

    def block(i):
        tds = jax.lax.dynamic_slice(td, (0, i * slab), (td.shape[0], slab))
        tls = jax.lax.dynamic_slice(tl, (0, i * slab), (tl.shape[0], slab))
        D = tiled_ell_densify_t(
            tds, tls, wt=wt, ntiles=nt, col_tile=ct, out_dtype=jnp.float32,
        )
        return jax.lax.dot_general(
            D, Vp, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [slab, k]

    # stacked slab outputs rather than a zero-initialised loop carry
    return jax.lax.map(block, jnp.arange(rs // slab)).reshape(rs, k)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedGram:
    """Row-sharded, row-bucketed tiled payloads + the Gram machinery.

    ``bdata[c]``/``blocal[c]`` hold width-class c's stacked payload
    ``[ndev, nt * wc, Rc]`` (device-sharded on axis 0); ``pos_local``
    ``[ndev, rs]`` maps each device's natural local row index to its
    bucketed position in the concatenated per-class projection output
    (padding slots point at the appended zero row). ``bwidths`` is the
    static per-class ``(wc, Rc, slab_c)`` list; ``meta = (nt, ct, exact,
    i8)`` (``i8``: integer values in [-127, 127] — the int8 Gram
    tier, see ``linalg/gram.py``).
    """

    bdata: Tuple[jnp.ndarray, ...]
    blocal: Tuple[jnp.ndarray, ...]
    pos_local: jnp.ndarray  # [ndev, rs] int32
    shape: Tuple[int, int]
    meta: Tuple[int, int, bool, bool]  # nt, ct, exact, i8
    bwidths: Tuple[Tuple[int, int, int], ...]  # per class: (wc, Rc, slab_c)
    mesh: Mesh
    axis_name: str

    @classmethod
    def from_matrix(
        cls,
        m: SparseMatrix,
        mesh: Mesh,
        axis_name: str = "rows",
        col_tile: int | None = None,
        slab: int | None = None,
    ) -> "ShardedGram":
        from ..linalg.gram import GramPCAEngine

        if m.format != "csr":
            m = m.transpose()
        m._require_host_structure()
        n, p = m.shape
        ndev = mesh.shape[axis_name]
        rs = -(-n // ndev)  # natural rows per device (contiguous blocks)

        if slab is not None and slab < 1:
            raise ValueError(f"slab={slab} must be a positive row count")

        def _slab_for_rows(cap: int) -> int:
            """Sub-slab granularity for a row population: full 8192 at
            scale, small otherwise so a near-empty width class doesn't pay
            a whole slab of padding."""

            if slab is not None:
                return slab
            if cap >= 8192:
                return 8192
            s = max(_cv.round_up(max(cap, 1), 128), 128)
            if s > 1024:
                s = min(_cv.round_up(s, 1024), 8192)
            return s

        if col_tile is None:
            from ..linalg.operators import DensifiedOperator

            # per-device budget: the payload splits ndev ways
            budget = DensifiedOperator.hbm_budget_bytes() * ndev
            col_tile, _ = GramPCAEngine.choose_col_tile(m, budget)
        ct = col_tile
        nt = max(-(-p // ct), 1)

        indptr, indices = m._h_indptr, m._h_indices
        data = m._csr_data_host()
        exact = m.values_bf16_exact()
        i8 = m.values_int8_exact()

        # global width classes: reuse the bucket plan choose_col_tile just
        # computed and cached for this (matrix, col_tile) — re-running the
        # O(nnz) width scan here doubled the dominant host build cost
        plan, _, _, nt_plan = GramPCAEngine._bucket_plan(m, ct)
        assert nt_plan == nt
        classes = np.empty(n, np.int64)
        for c, rows_c in plan:
            classes[rows_c] = c
        class_list = [int(c) for c, _ in plan]

        # per (device, class) natural-row lists + class capacities
        dev_rows = []  # [ndev][class] -> natural row indices
        caps = {c: 0 for c in class_list}
        for d in range(ndev):
            r0, r1 = d * rs, min((d + 1) * rs, n)
            cd = classes[r0:r1]
            per = {}
            for c in class_list:
                rows_c = np.where(cd == c)[0] + r0
                per[c] = rows_c
                caps[c] = max(caps[c], len(rows_c))
            dev_rows.append(per)
        bwidths = tuple(
            (
                c,
                _cv.round_up(max(caps[c], 1), _slab_for_rows(caps[c])),
                _slab_for_rows(caps[c]),
            )
            for c in class_list
        )

        # class payload fill + the natural->bucketed local position map
        bdata_np = [
            np.zeros((ndev, nt * c, rc), np.float32) for c, rc, _ in bwidths
        ]
        blocal_np = [
            np.zeros((ndev, nt * c, rc), np.int32) for c, rc, _ in bwidths
        ]
        r_tot = sum(rc for _, rc, _ in bwidths)
        pos_local = np.full((ndev, rs), r_tot, np.int64)  # pad -> zero row
        for d in range(ndev):
            offset = 0
            for b, (c, rc, _) in enumerate(bwidths):
                rows = dev_rows[d][c]
                if len(rows):
                    _cv.fill_class_payload(
                        indptr, indices, data, rows, p, ct, c, rc,
                        out_td=bdata_np[b][d], out_tl=blocal_np[b][d],
                    )
                    pos_local[d, rows - d * rs] = offset + np.arange(
                        len(rows)
                    )
                offset += rc

        sh = NamedSharding(mesh, P(axis_name, None, None))
        sh2 = NamedSharding(mesh, P(axis_name, None))
        return cls(
            tuple(jax.device_put(a, sh) for a in bdata_np),
            tuple(jax.device_put(a, sh) for a in blocal_np),
            jax.device_put(pos_local.astype(np.int32), sh2),
            (n, p),
            (nt, ct, exact, i8),
            bwidths,
            mesh,
            axis_name,
        )

    # -- capacity accounting ---------------------------------------------

    @property
    def payload_bytes(self) -> int:
        """Device-resident payload bytes (values f32 + local ids i32) —
        tracks per-row structure via the width classes."""

        return sum(a.size * 4 for a in self.bdata) + sum(
            a.size * 4 for a in self.blocal
        )

    @property
    def unbucketed_payload_bytes(self) -> int:
        """What a single global-width payload would cost (every device
        slab padded to the max class width)."""

        ndev = self.bdata[0].shape[0]
        nt = self.meta[0]
        wt_max = max(c for c, _, _ in self.bwidths)
        slab_max = max(s for _, _, s in self.bwidths)
        n = self.shape[0]
        rs = _cv.round_up(-(-n // ndev), slab_max)
        return 2 * ndev * nt * wt_max * rs * 4

    # -- device passes ---------------------------------------------------

    @jax.jit
    def gram(self) -> jnp.ndarray:
        """Replicated ``A^T A`` [pp, pp] — local per-class accumulation +
        one psum."""

        nt, ct, exact, i8 = self.meta
        ax = self.axis_name
        bwidths = self.bwidths

        def local(bdata, blocal):
            pp = nt * ct
            G = jnp.zeros((pp, pp), jnp.float32)
            for b, (c, _, slab_c) in enumerate(bwidths):
                G = G + _local_gram(
                    bdata[b][0], blocal[b][0],
                    wt=c, nt=nt, ct=ct, slab=slab_c, exact=exact, i8=i8,
                )
            return jax.lax.psum(G, ax)

        spec = tuple(P(ax, None, None) for _ in bwidths)
        return jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(spec, spec),
            out_specs=P(),
        )(self.bdata, self.blocal)

    def gram_cached(self) -> jnp.ndarray:
        g = getattr(self, "_gram_cache", None)
        if g is None:
            g = self.gram()
            self._gram_cache = g
        return g

    @partial(jax.jit, static_argnames=())
    def project(self, Vp: jnp.ndarray, corr: jnp.ndarray) -> jnp.ndarray:
        """Row-sharded scores ``(A - 1 mu^T) V`` -> [n, k] in NATURAL row
        order; no collectives (Vp [pp, k] / corr [k] replicated; the
        bucketed->natural reorder is a per-device local gather)."""

        nt, ct = self.meta[0], self.meta[1]
        ax = self.axis_name
        bwidths = self.bwidths

        def local(bdata, blocal, pos, Vp, corr):
            k = Vp.shape[1]
            parts = [
                _local_project(
                    bdata[b][0], blocal[b][0], Vp,
                    wt=c, nt=nt, ct=ct, slab=slab_c,
                )
                for b, (c, _, slab_c) in enumerate(bwidths)
            ]
            Tb = jnp.concatenate(
                parts + [jnp.zeros((1, k), jnp.float32)], axis=0
            )
            return jnp.take(Tb, pos[0], axis=0) - corr[None, :]

        spec = tuple(P(ax, None, None) for _ in bwidths)
        T = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(spec, spec, P(ax, None), P(), P()),
            out_specs=P(ax, None),
        )(self.bdata, self.blocal, self.pos_local, Vp, corr)
        return T[: self.shape[0]]

    def tree_flatten(self):
        return (self.bdata, self.blocal, self.pos_local), (
            self.shape, self.meta, self.bwidths, self.mesh, self.axis_name,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def sharded_gram_pca(
    m: SparseMatrix,
    mesh: Mesh,
    n_components: int = 50,
    center: bool = True,
    seed: int = 42,
    mask=None,
    axis_name: str = "rows",
):
    """Exact two-pass PCA over the mesh. Returns the same tuple fields as
    ``sharded_pca_fit_transform`` (transformed row-sharded, components,
    explained_variance, mean, total_variance)."""

    from ..linalg.gram import solve_gram_topk

    cache = getattr(m, "_operator_cache", None)
    key = f"sharded:gram:{mesh.shape}:{tuple(d.id for d in mesh.devices.flat)}"
    if cache is not None and key in cache:
        op = cache[key]
    else:
        op = ShardedGram.from_matrix(m, mesh, axis_name=axis_name)
        if cache is not None:
            cache[key] = op

    n, p = op.shape
    pp = op.meta[0] * op.meta[1]
    k = n_components

    # host f64 column moments (exact, one numpy pass, cached on the matrix)
    from ..models.pca import _host_col_stats

    s64, sq64 = _host_col_stats(m)
    mean64 = s64 / n
    mean = jnp.asarray(mean64.astype(np.float32))

    G = op.gram_cached()

    idx_np = None
    if mask is not None:
        mask = np.asarray(mask, bool)
        if mask.shape[0] != p:
            raise ValueError(
                "The mask vector length and the number of features (columns)"
                " have to be the same!"
            )
        idx_np = np.where(mask)[0]
        idx = jnp.asarray(idx_np.astype(np.int32))
        Gs = jnp.take(jnp.take(G, idx, axis=0), idx, axis=1)
        mu_solve = jnp.take(
            jnp.pad(mean, (0, pp - p)), idx
        )
    else:
        Gs = G
        mu_solve = jnp.pad(mean, (0, pp - p))

    s_dev, vt = solve_gram_topk(
        Gs, mu_solve, jnp.asarray(n), seed, k=k, center=center
    )

    # scatter V to padded full width for the local projections
    if idx_np is not None:
        Vp = jnp.zeros((pp, k), jnp.float32).at[
            jnp.asarray(idx_np.astype(np.int32))
        ].set(vt.T)
        comps = vt
    else:
        Vp = jnp.pad(vt.T, ((0, pp - vt.shape[1]), (0, 0)))
        comps = vt[:, :p]
    from ..types import MATMUL_PRECISION

    corr = (
        jnp.dot(mu_solve, vt.T, precision=MATMUL_PRECISION)
        if center
        else jnp.zeros((k,), jnp.float32)
    )
    T = op.project(Vp, corr)

    ev64 = np.asarray(s_dev, np.float64) ** 2 / max(n - 1, 1)
    if center:
        var_all = (sq64 - mean64 * s64) / max(n - 1, 1)
        total_var = float(
            var_all.sum() if idx_np is None else var_all[idx_np].sum()
        )
    else:
        total_var = float(ev64.sum())

    from .pca import ShardedPCAResult

    return ShardedPCAResult(
        T, comps, jnp.asarray(ev64.astype(np.float32)), mean,
        total_var,
    )
