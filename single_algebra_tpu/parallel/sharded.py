"""Row-sharded sparse operator over a device mesh.

The reference's entire parallelism story is Rayon threads in one process
(SURVEY.md §2.3 — no distributed backend exists). Here the scaling
axis is the cell/sample (row) dimension sharded across a
``jax.sharding.Mesh``: each device holds a contiguous row slab of the matrix
in TWO layouts —

* the slab's row-major ELL  -> ``A @ B`` is embarrassingly local
  (B replicated, output row-sharded; zero collectives), and
* the slab's **transposed** ELL (column-major with slab-local row ids)
  -> ``A^T @ C = sum_slabs A_slab^T @ C_slab`` is one local SpMM followed by
  a single ``psum`` across the devices.

Column statistics ride the same transposed layout (local width-reductions +
``psum``), replacing the reference's ``_chunk`` streaming accumulators
(``src/sparse/mod.rs:44-50``) with device-parallel slabs.

Everything is expressed with ``shard_map`` inside ``jit`` so the collective
schedule is explicit and the operator plugs unchanged into the jitted SVD
engines (``randomized_svd(ShardedSpMM(...), ...)``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.spmm import ell_spmm
from ..ops.tiled import tiled_ell_rmv_t, tiled_ell_spmm_t
from ..sparse import convert as _cv
from ..sparse.matrix import SparseMatrix

__all__ = ["ShardedSpMM", "ShardedTiled", "make_mesh"]


def make_mesh(n_devices: int | None = None, axis_name: str = "rows") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedSpMM:
    """Row-sharded sparse operator (mv/rmv/shape protocol).

    Build with :meth:`from_matrix`; arrays are placed with NamedShardings so
    XLA never moves slab data between devices.
    """

    row_data: jnp.ndarray  # [ndev * Rs, Wr]   sharded P(axis, None)
    row_ids: jnp.ndarray  # [ndev * Rs, Wr]
    tr_data: jnp.ndarray  # [ndev, Pp, Wt]    sharded P(axis, None, None)
    tr_ids: jnp.ndarray  # [ndev, Pp, Wt]    slab-LOCAL row indices
    tr_nnz: jnp.ndarray  # [ndev, Pp]
    shape: Tuple[int, int]
    rows_per_shard: int
    mesh: Mesh
    axis_name: str

    # -- construction ---------------------------------------------------

    @classmethod
    def from_matrix(
        cls,
        m: SparseMatrix,
        mesh: Mesh,
        axis_name: str = "rows",
    ) -> "ShardedSpMM":
        if m.format != "csr":
            m = m.transpose()  # row-major view of the same logical matrix
        m._require_host_structure()
        n, p = m.shape
        ndev = mesh.shape[axis_name]
        rs = _cv.round_up(-(-n // ndev), 8)
        pp = _cv.pad_rows(p)

        indptr = m._h_indptr
        indices = m._h_indices
        data = m._csr_data_host()

        # per-slab layouts, padded to common widths across slabs
        slab_row, slab_tr = [], []
        wr = wt = 1
        for d in range(ndev):
            # clamp BOTH bounds: rounding rs up to 8 can push d*rs past
            # n for trailing devices (empty slabs fall through n_rows==0)
            r0, r1 = min(d * rs, n), min((d + 1) * rs, n)
            lo, hi = int(indptr[r0]), int(indptr[r1])
            s_indptr = indptr[r0 : r1 + 1] - lo if r1 > r0 else np.zeros(1, np.int64)
            s_idx = indices[lo:hi]
            s_dat = data[lo:hi]
            n_rows = max(r1 - r0, 0)
            wr = max(wr, int(np.diff(s_indptr).max()) if n_rows else 1)
            t_indptr, t_indices, t_data = _cv.csr_transpose_numpy(
                s_indptr, s_idx, s_dat, n_rows, p
            )
            wt = max(wt, int(np.diff(t_indptr).max()) if len(t_indices) else 1)
            slab_row.append((s_indptr, s_idx, s_dat, n_rows))
            slab_tr.append((t_indptr, t_indices, t_data))

        wr = _cv.pad_width(wr)
        wt = _cv.pad_width(wt)

        row_data = np.zeros((ndev * rs, wr), data.dtype)
        row_ids = np.zeros((ndev * rs, wr), np.int32)
        tr_data = np.zeros((ndev, pp, wt), data.dtype)
        tr_ids = np.zeros((ndev, pp, wt), np.int32)
        tr_nnz = np.zeros((ndev, pp), np.int32)
        for d in range(ndev):
            s_indptr, s_idx, s_dat, n_rows = slab_row[d]
            if n_rows:
                ed, ei, _ = _cv.csr_to_ell_numpy(
                    s_indptr, s_idx, s_dat, n_rows, width=wr, rows_padded=rs
                )
                row_data[d * rs : (d + 1) * rs] = ed
                row_ids[d * rs : (d + 1) * rs] = ei
            t_indptr, t_indices, t_dat = slab_tr[d]
            ed, ei, en = _cv.csr_to_ell_numpy(
                t_indptr, t_indices, t_dat, p, width=wt, rows_padded=pp
            )
            tr_data[d], tr_ids[d], tr_nnz[d] = ed, ei, en

        row_sh = NamedSharding(mesh, P(axis_name, None))
        tr_sh = NamedSharding(mesh, P(axis_name, None, None))
        tr2_sh = NamedSharding(mesh, P(axis_name, None))
        return cls(
            jax.device_put(row_data, row_sh),
            jax.device_put(row_ids, row_sh),
            jax.device_put(tr_data, tr_sh),
            jax.device_put(tr_ids, tr_sh),
            jax.device_put(tr_nnz, tr2_sh),
            (n, p),
            rs,
            mesh,
            axis_name,
        )

    # -- operator protocol ---------------------------------------------

    @property
    def n_padded(self) -> int:
        return self.row_data.shape[0]

    def mv(self, B: jnp.ndarray) -> jnp.ndarray:
        """A @ B -> [n, k] row-sharded; no collectives."""

        ax = self.axis_name

        def local(rd, ri, Bf):
            return ell_spmm(rd, ri, Bf)

        out = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(ax, None), P(ax, None), P()),
            out_specs=P(ax, None),
        )(self.row_data, self.row_ids, B)
        return out[: self.shape[0]]

    def rmv(self, C: jnp.ndarray) -> jnp.ndarray:
        """A^T @ C -> [p, k] replicated; one psum over the mesh axis."""

        ax = self.axis_name
        Cp = jnp.zeros((self.n_padded, C.shape[1]), C.dtype)
        Cp = jax.lax.dynamic_update_slice(Cp, C.astype(Cp.dtype), (0, 0))

        def local(td, ti, Cl):
            part = ell_spmm(td[0], ti[0], Cl)  # [Pp, k]
            return jax.lax.psum(part, ax)

        out = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(ax, None, None), P(ax, None, None), P(ax, None)),
            out_specs=P(),
        )(self.tr_data, self.tr_ids, Cp)
        return out[: self.shape[1]]

    @jax.jit
    def col_stats(self) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(sum, sum_sq, nnz_count) per column — local width-reductions on
        the transposed slabs + one psum. Jitted: an eager shard_map
        retraces on every call."""

        ax = self.axis_name

        def local(td, ti, tn):
            s = jnp.sum(td[0], axis=1)
            sq = jnp.sum(td[0] * td[0], axis=1)
            cnt = tn[0].astype(jnp.int32)
            return jax.lax.psum((s, sq, cnt), ax)

        s, sq, cnt = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(ax, None, None), P(ax, None, None), P(ax, None)),
            out_specs=(P(), P(), P()),
        )(self.tr_data, self.tr_ids, self.tr_nnz)
        p = self.shape[1]
        return s[:p], sq[:p], cnt[:p]

    # -- pytree ---------------------------------------------------------

    def tree_flatten(self):
        children = (
            self.row_data,
            self.row_ids,
            self.tr_data,
            self.tr_ids,
            self.tr_nnz,
        )
        aux = (self.shape, self.rows_per_shard, self.mesh, self.axis_name)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedTiled:
    """Row-sharded sparse operator over the tiled-ELL products.

    The sharded twin of ``TiledSparseOperator``: :class:`ShardedSpMM`
    drives each slab through the gather path (``ell_spmm``); here each
    device holds its row slab's TRANSPOSED column-tiled payload (the
    single-orientation layout of ``TiledSparseOperator``): ``A @ B``
    densifies row blocks and contracts them locally (no collectives),
    ``A^T @ C`` contracts the SAME payload on its row axis plus one
    ``psum``. Rare heavy-row overflow entries ride narrow plain ELL side
    arrays through the gather path (~1% of nnz).

    Payload shapes must be uniform across devices for ``shard_map``, so
    every slab is converted with the GLOBAL width plan (quantile main
    width + global max overflow width) — see ``force_wt``/``force_ov_w``
    in ``convert.csr_to_tiled_ell_split_numpy``.

    Precision scheme mirrors :class:`~..linalg.operators.TiledSparseOperator`:
    f32 payloads are stored bf16 hi (+ bf16 lo residual unless bf16-exact);
    ``mv``/``rmv`` are compensated products (payload hi+lo against the
    hi/lo-split operand stacked on the k axis), ``mv_fast``/``rmv_fast``
    contract hi-only in one native-bf16 pass per slab (the randomized
    power-iteration path). Overflow side arrays stay f32 and add exactly.
    """

    tdata: jnp.ndarray  # [ndev, nt * wt, Rsp]  bf16 hi (f32) / f64 values
    tdata_lo: jnp.ndarray | None  # bf16 residual, None when exact/f64
    tlocal: jnp.ndarray  # [ndev, nt * wt, Rsp]  int32 local col ids
    ov_data: jnp.ndarray  # [ndev, Rsp, ovw]   overflow, global col ids (mv)
    ov_ids: jnp.ndarray
    ovt_data: jnp.ndarray  # [ndev, Pp, ovtw]  overflow, slab-local rows (rmv)
    ovt_ids: jnp.ndarray
    shape: Tuple[int, int]
    rows_per_shard: int  # Rsp (padded to a block_rows multiple)
    meta: Tuple[int, int, int, int, int, int]  # wt, nt, ct, br, ovw, ovtw
    mesh: Mesh
    axis_name: str
    # host f64-accumulated column stats, cast to the matrix dtype
    # (sum, sum_sq, count); plain attribute — NOT a pytree child, set by
    # from_matrix and absent after tree_unflatten inside jit
    col_stats_host: tuple | None = None

    @classmethod
    def from_matrix(
        cls,
        m: SparseMatrix,
        mesh: Mesh,
        axis_name: str = "rows",
        col_tile: int | None = None,
    ) -> "ShardedTiled":
        from ..linalg.operators import TiledSparseOperator, _coo_to_csr_arrays

        if m.format != "csr":
            m = m.transpose()
        m._require_host_structure()
        n, p = m.shape
        ndev = mesh.shape[axis_name]
        rs = -(-n // ndev)
        # rows padded like the single-device payload
        if rs >= 1024:
            br = 1024
            rsp = _cv.round_up(rs, 1024)
        else:
            rsp = max(_cv.round_up(rs, 128), 128)
            br = rsp
        ct = col_tile or TiledSparseOperator.COL_TILE
        nt = max(-(-p // ct), 1)
        pp = _cv.pad_rows(p)

        indptr = m._h_indptr
        indices = m._h_indices
        data = m._csr_data_host()

        # GLOBAL width plan: quantile main width and max overflow width are
        # per-row properties, so the whole-matrix scan gives every slab's
        # uniform shape in one O(nnz) pass
        wt, nt_g, ovw, _ = _cv.tiled_split_widths(
            indptr, indices, n, p, col_tile=ct
        )
        assert nt_g == nt

        tdata = np.zeros((ndev, nt * wt, rsp), data.dtype)
        tlocal = np.zeros((ndev, nt * wt, rsp), np.int32)
        ov_data = np.zeros((ndev, rsp, ovw), data.dtype)
        ov_ids = np.zeros((ndev, rsp, ovw), np.int32)
        slabs_t = []  # per-slab transposed-overflow CSR (row axis = columns)
        ovtw = 0
        for d in range(ndev):
            r0, r1 = min(d * rs, n), min((d + 1) * rs, n)
            lo, hi = int(indptr[r0]), int(indptr[r1])
            s_ip = (
                indptr[r0 : r1 + 1] - lo if r1 > r0 else np.zeros(1, np.int64)
            )
            td, tl, _, _, ovd, ovi, _ = _cv.csr_to_tiled_ell_split_numpy(
                s_ip,
                indices[lo:hi],
                data[lo:hi],
                r1 - r0,
                p,
                col_tile=ct,
                rows_padded_to=rsp,
                force_wt=wt,
                force_ov_w=ovw,
            )
            tdata[d], tlocal[d] = td, tl
            if ovw:
                ov_data[d], ov_ids[d] = ovd, ovi
                r_idx, w_idx = np.nonzero(ovd)
                t_ip, t_ix, t_dt = _coo_to_csr_arrays(
                    ovi[r_idx, w_idx], r_idx, ovd[r_idx, w_idx], p, rsp
                )
                slabs_t.append((t_ip, t_ix, t_dt))
                if len(t_ix):
                    ovtw = max(ovtw, int(np.diff(t_ip).max()))

        ovtw = _cv.round_up(ovtw, 8) if ovtw else 0
        ovt_data = np.zeros((ndev, pp, ovtw), data.dtype)
        ovt_ids = np.zeros((ndev, pp, ovtw), np.int32)
        if ovtw:
            for d, (t_ip, t_ix, t_dt) in enumerate(slabs_t):
                ed, ei, _ = _cv.csr_to_ell_numpy(
                    t_ip, t_ix, t_dt, p, width=ovtw, rows_padded=pp
                )
                ovt_data[d], ovt_ids[d] = ed, ei

        # exact host column moments (f64 accumulate), cast to matrix dtype
        d64 = data.astype(np.float64)
        s = np.bincount(indices, weights=d64, minlength=p)[:p]
        sq = np.bincount(indices, weights=d64 * d64, minlength=p)[:p]
        cnt = np.bincount(indices, minlength=p)[:p]
        dt = np.dtype(data.dtype)

        tdata, tdata_lo = TiledSparseOperator._split_payload(tdata, wt)

        sh3 = NamedSharding(mesh, P(axis_name, None, None))
        return cls(
            jax.device_put(tdata, sh3),
            None if tdata_lo is None else jax.device_put(tdata_lo, sh3),
            jax.device_put(tlocal, sh3),
            jax.device_put(ov_data, sh3),
            jax.device_put(ov_ids, sh3),
            jax.device_put(ovt_data, sh3),
            jax.device_put(ovt_ids, sh3),
            (n, p),
            rsp,
            (wt, nt, ct, br, ovw, ovtw),
            mesh,
            axis_name,
            col_stats_host=(
                jnp.asarray(s.astype(dt)),
                jnp.asarray(sq.astype(dt)),
                jnp.asarray(cnt.astype(np.int32)),
            ),
        )

    # -- operator protocol ---------------------------------------------

    @property
    def ndev(self) -> int:
        return self.tdata.shape[0]

    @property
    def rows_natural(self) -> int:
        """Natural (unpadded) rows per device slab."""

        return -(-self.shape[0] // self.ndev)

    def _kp(self, k: int) -> int:
        return max(-(-k // 8) * 8, 8)

    @property
    def _bf16(self) -> bool:
        return self.tdata.dtype == jnp.bfloat16

    def _payloads(self):
        """(payload, spec) pairs the shard_map bodies iterate — hi, then
        lo when the residual exists."""

        return (
            [self.tdata]
            if self.tdata_lo is None
            else [self.tdata, self.tdata_lo]
        )

    def _mv_impl(self, B: jnp.ndarray, fast: bool) -> jnp.ndarray:
        wt, nt, ct, _, ovw, _ = self.meta
        ax = self.axis_name
        rs = self.rows_natural
        k = B.shape[1]
        kp = self._kp(k)
        bf16 = self._bf16
        dt = self.tdata.dtype
        if not bf16:
            Bt = jnp.zeros((kp, nt * ct), dt)
            Bt = jax.lax.dynamic_update_slice(Bt, B.T.astype(dt), (0, 0))
        elif fast:
            Bt = jnp.zeros((kp, nt * ct), jnp.bfloat16)
            Bt = jax.lax.dynamic_update_slice(
                Bt, B.T.astype(jnp.bfloat16), (0, 0)
            )
        else:
            # bf16 operand terms stacked on the k axis: the compensated
            # product rides the SAME product call (cost linear in kp)
            from ..linalg.operators import TiledSparseOperator

            Bt, _ = TiledSparseOperator._stack_split(B, nt * ct)
        payloads = [self.tdata] if (fast or not bf16) else self._payloads()

        def local(tl, ovd, ovi, Btf, Bf, *tds):
            from ..linalg.operators import TiledSparseOperator as _T

            acc = None
            for td in tds:
                out = tiled_ell_spmm_t(
                    td[0], tl[0], Btf, wt=wt, ntiles=nt, col_tile=ct,
                )
                part = out[:k] if (fast or not bf16) else (
                    _T._unstack_sum(out, kp, k, axis=0)
                )
                acc = part if acc is None else acc + part
            res = acc.T  # [Rsp, k]
            if ovw > 0:  # static: baked in at trace time
                res = res + ell_spmm(ovd[0], ovi[0], Bf)
            return res[:rs]

        sh = P(ax, None, None)
        out = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(sh, sh, sh, P(), P()) + (sh,) * len(payloads),
            out_specs=P(ax, None),
        )(
            self.tlocal, self.ov_data, self.ov_ids, Bt,
            B.astype(jnp.float32 if bf16 else dt), *payloads,
        )
        # operator-native dtype, not B's: the f32 probe in randomized_svd
        # infers the operator's precision from this result
        return out[: self.shape[0]]

    def mv(self, B: jnp.ndarray) -> jnp.ndarray:
        """A @ B -> [n, k] row-sharded; no collectives; f32-class accuracy
        (compensated bf16 on f32 payloads).

        Each device's payload covers natural rows [d*rs, (d+1)*rs) padded
        to Rsp; the local body drops the padding so the stitched output is
        contiguous in natural row order.
        """

        return self._mv_impl(B, fast=False)

    def mv_fast(self, B: jnp.ndarray) -> jnp.ndarray:
        """A @ B with the hi payload only — one bf16 pass per slab."""

        return self._mv_impl(B, fast=self._bf16)

    def _rmv_impl(self, C: jnp.ndarray, fast: bool) -> jnp.ndarray:
        from ..linalg.operators import TiledSparseOperator

        wt, nt, ct, _, _, ovtw = self.meta
        ax = self.axis_name
        rs = self.rows_natural
        rsp = self.rows_per_shard
        p = self.shape[1]
        k = C.shape[1]
        kp = self._kp(k)
        bf16 = self._bf16
        dt = self.tdata.dtype
        cdt = jnp.float32 if bf16 else dt
        Cp = jnp.zeros((self.ndev * rs, kp), cdt)
        Cp = jax.lax.dynamic_update_slice(Cp, C.astype(cdt), (0, 0))
        payloads = [self.tdata] if (fast or not bf16) else self._payloads()
        split = bf16 and not fast

        def local(tl, ovtd, ovti, Cl, *tds):
            # natural rows -> the slab's padded row coordinates
            Clp = jnp.pad(Cl, ((0, rsp - rs), (0, 0)))
            if not bf16:
                Ct = Clp.T
            elif fast:
                Ct = Clp.T.astype(jnp.bfloat16)
            else:
                Ct, _ = TiledSparseOperator._stack_split(Clp, rsp)
            acc = None
            for td in tds:
                out = tiled_ell_rmv_t(
                    td[0], tl[0], Ct, wt=wt, ntiles=nt, col_tile=ct,
                )
                part = out[:p, :k] if not split else (
                    TiledSparseOperator._unstack_sum(
                        out[:p], kp, k, axis=1
                    )
                )
                acc = part if acc is None else acc + part
            if ovtw > 0:
                acc = acc + ell_spmm(ovtd[0], ovti[0], Clp[:, :k])[:p]
            return jax.lax.psum(acc, ax)

        sh = P(ax, None, None)
        out = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(sh, sh, sh, P(ax, None)) + (sh,) * len(payloads),
            out_specs=P(),
        )(self.tlocal, self.ovt_data, self.ovt_ids, Cp, *payloads)
        return out

    def rmv(self, C: jnp.ndarray) -> jnp.ndarray:
        """A^T @ C -> [p, k] replicated; one psum over the mesh axis;
        f32-class accuracy (compensated bf16 on f32 payloads)."""

        return self._rmv_impl(C, fast=False)

    def rmv_fast(self, C: jnp.ndarray) -> jnp.ndarray:
        """A^T @ C with the hi payload only — one bf16 pass per slab."""

        return self._rmv_impl(C, fast=self._bf16)

    def col_stats(self) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(sum, sum_sq, nnz_count) per column — exact host moments
        computed at construction (f64 accumulate, cast to matrix dtype)."""

        if self.col_stats_host is None:
            raise RuntimeError(
                "col_stats is available only on the constructed operator "
                "(host moments are not pytree children)"
            )
        return self.col_stats_host

    # -- capacity planning ----------------------------------------------

    @classmethod
    def payload_bytes(cls, m: SparseMatrix, ndev: int) -> int:
        """Device payload estimate for the stacked sharded layout (values
        f32 + ids i32 for main level and both overflow orientations)."""

        from ..linalg.operators import TiledSparseOperator

        src = m._layout_for("row")
        src._require_host_structure()
        n, p = m.shape
        ct = TiledSparseOperator.COL_TILE
        wt, nt, ovw, _ = _cv.tiled_split_widths(
            src._h_indptr, src._h_indices, n, p, col_tile=ct
        )
        rs = -(-n // ndev)
        rsp = _cv.round_up(rs, 1024) if rs >= 1024 else max(
            _cv.round_up(rs, 128), 128
        )
        pp = _cv.pad_rows(p)
        main = ndev * nt * wt * rsp * 8
        over = ndev * rsp * ovw * 8
        if ovw:
            # rmv-side width: whole-matrix per-column overflow max (upper
            # bound on the per-slab ovtw every device pads to)
            ovtw = _cv.tiled_overflow_col_width(
                src._h_indptr, src._h_indices, n, p, ct, wt
            )
            over += ndev * pp * _cv.round_up(max(ovtw, 1), 8) * 8
        return main + over

    def tree_flatten(self):
        children = [
            self.tdata, self.tlocal,
            self.ov_data, self.ov_ids,
            self.ovt_data, self.ovt_ids,
        ]
        if self.tdata_lo is not None:
            children.append(self.tdata_lo)
        aux = (
            self.shape, self.rows_per_shard, self.meta,
            self.mesh, self.axis_name, self.tdata_lo is not None,
        )
        return tuple(children), aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, rsp, meta, mesh, axis_name, has_lo = aux
        lo = children[6] if has_lo else None
        return cls(
            children[0], lo, *children[1:6], shape, rsp, meta, mesh,
            axis_name,
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedDensified:
    """Row-sharded dense-bf16 engine: the north-star configuration.

    A 1M x 30k matrix is ~60 GB as bf16 — more than one device's budget
    but ~15 GB per device on a 4-device mesh. Each device holds a row slab
    of the densified matrix (hi, and lo when the data is not bf16-exact);
    ``A @ B`` is a local matmul (B replicated), ``A^T @ C`` is a local
    matmul plus one ``psum``. Collective layout follows the scaling-book
    recipe: shard the big axis, replicate the skinny sketch operands.
    """

    hi: jnp.ndarray  # [Np, p] bf16, sharded P(axis, None)
    lo: jnp.ndarray | None
    shape: Tuple[int, int]
    mesh: Mesh
    axis_name: str

    @classmethod
    def from_matrix(
        cls, m: SparseMatrix, mesh: Mesh, axis_name: str = "rows"
    ) -> "ShardedDensified":
        from ..linalg.operators import DensifiedOperator

        # host densify (native C++); rows are padded and sharded straight
        # from HOST memory — the full dense array must never be staged on
        # one device (the north-star 1M x 30k is ~60 GB bf16, past one
        # device's budget but fine in host RAM)
        hi_np, lo_np = DensifiedOperator.densify_host(m)
        n, p = m.shape
        ndev = mesh.shape[axis_name]
        rs = _cv.round_up(-(-n // ndev), 8)
        pad = ndev * rs - n
        sh = NamedSharding(mesh, P(axis_name, None))

        def place(arr):
            if arr is None:
                return None
            a = np.pad(arr, ((0, pad), (0, 0))) if pad else arr
            return jax.device_put(a, sh)

        return cls(place(hi_np), place(lo_np), (n, p), mesh, axis_name)

    def _dots(self, x, B, dims):
        return jax.lax.dot_general(
            x,
            B.astype(jnp.bfloat16),
            dimension_numbers=(dims, ((), ())),
            preferred_element_type=jnp.float32,
        )

    def mv(self, B):
        ax = self.axis_name

        def local(hi, Bf):
            return self._dots(hi, Bf, ((1,), (0,)))

        out = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(ax, None), P()),
            out_specs=P(ax, None),
        )(self.hi, B)
        return out[: self.shape[0]].astype(B.dtype)

    def rmv(self, C):
        ax = self.axis_name
        Np = self.hi.shape[0]
        Cp = jnp.zeros((Np, C.shape[1]), C.dtype)
        Cp = jax.lax.dynamic_update_slice(Cp, C, (0, 0))

        def local(hi, Cl):
            part = self._dots(hi, Cl, ((0,), (0,)))
            return jax.lax.psum(part, ax)

        out = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(ax, None), P(ax, None)),
            out_specs=P(),
        )(self.hi, Cp)
        return out.astype(C.dtype)

    def _precise(self, B, dims, mv_like):
        from ..linalg.operators import OPERAND_TERMS, bf16_terms

        ax = self.axis_name
        parts = [self.hi] + ([self.lo] if self.lo is not None else [])
        # 3-term operand split: the 2-term version's ~2^-17 dropped
        # residual floors explained variance near ~1.5e-5 on this engine
        # (see DensifiedOperator._precise)
        b_terms = tuple(bf16_terms(B, OPERAND_TERMS))

        def local(*args):
            mats = args[: len(parts)]
            bts = args[len(parts) :]
            acc = None
            for a in mats:
                term = None
                for bt in bts:
                    d = self._dots(a, bt, dims)
                    term = d if term is None else term + d
                acc = term if acc is None else acc + term
            if not mv_like:
                acc = jax.lax.psum(acc, ax)
            return acc

        if mv_like:
            in_specs = tuple([P(ax, None)] * len(parts)) + (
                P(),
            ) * len(b_terms)
            out = jax.shard_map(
                local, mesh=self.mesh, in_specs=in_specs,
                out_specs=P(ax, None),
            )(*parts, *b_terms)
            return out[: self.shape[0]].astype(B.dtype)
        in_specs = tuple([P(ax, None)] * len(parts)) + (
            P(ax, None),
        ) * len(b_terms)
        out = jax.shard_map(
            local, mesh=self.mesh, in_specs=in_specs, out_specs=P()
        )(*parts, *b_terms)
        return out.astype(B.dtype)

    def mv_precise(self, B):
        return self._precise(B, ((1,), (0,)), True)

    def rmv_precise(self, C):
        Np = self.hi.shape[0]
        Cp = jnp.zeros((Np, C.shape[1]), C.dtype)
        Cp = jax.lax.dynamic_update_slice(Cp, C, (0, 0))
        return self._precise(Cp, ((0,), (0,)), False)

    @jax.jit
    def col_stats(self):
        ax = self.axis_name
        parts = [self.hi] + ([self.lo] if self.lo is not None else [])

        def local(*mats):
            x = mats[0].astype(jnp.float32)
            for a in mats[1:]:
                x = x + a.astype(jnp.float32)
            return jax.lax.psum(
                (jnp.sum(x, axis=0), jnp.sum(x * x, axis=0)), ax
            )

        in_specs = tuple([P(ax, None)] * len(parts))
        s, sq = jax.shard_map(
            local, mesh=self.mesh, in_specs=in_specs, out_specs=(P(), P())
        )(*parts)
        return s, sq

    def tree_flatten(self):
        if self.lo is None:
            return (self.hi,), (self.shape, self.mesh, self.axis_name, False)
        return (self.hi, self.lo), (
            self.shape, self.mesh, self.axis_name, True,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, mesh, axis_name, has_lo = aux
        if has_lo:
            return cls(children[0], children[1], shape, mesh, axis_name)
        return cls(children[0], None, shape, mesh, axis_name)
