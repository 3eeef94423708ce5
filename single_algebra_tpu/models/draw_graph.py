"""Force-directed graph layout (ForceAtlas2) — scanpy ``tl.draw_graph``.

The CPU ecosystem runs ForceAtlas2 (Jacomy et al. 2014) through Gephi/fa2
with Barnes-Hut repulsion — a pointer tree XLA cannot express. Like the
large-n t-SNE mode (``models/tsne.py``), the device formulation computes the
n-body repulsion EXACTLY in [block, n] matmul/elementwise tiles (O(n^2) flops,
O(block * n) memory — no tree-approximation error), the edge attraction as
a flat edge list + sorted ``segment_sum`` (degree-robust under graph
hubness), and the whole optimization — including ForceAtlas2's adaptive
global speed/swinging controller — inside ``lax.fori_loop``, dispatched in
epoch chunks so no single device execution is unboundedly long.

Force model (fa2 reference semantics):

- mass ``m_i = 1 + degree_i``,
- repulsion  ``F = scaling * m_i m_j / d^2 * (y_i - y_j)``,
- attraction ``F = w^delta * (y_j - y_i)`` (optionally ``/ m_i`` with
  ``outbound_attraction_distribution``; ``lin_log`` applies
  ``log(1 + d) / d``),
- gravity    ``g m_i`` toward the origin (``strong_gravity``: ``g m_i d``),
- adaptive speed: global swinging/traction controller with per-node
  displacement factor ``speed / (1 + sqrt(speed * swinging_i))``.

The reference library has no graph-layout component at all; this extends
the rebuilt surface the same way UMAP does (SURVEY.md §2.2 'bhtsne' row is
the nearest analog).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..types import MATMUL_PRECISION

__all__ = ["draw_graph"]


def _edge_list(a, n: int):
    """Symmetric CSR -> padded flat edge list (src sorted for segment_sum)."""

    e = int(a.nnz)
    ep = max(-(-e // 4096) * 4096, 4096)
    # pad src with n-1 (not 0): attraction declares indices_are_sorted=True
    src = np.full(ep, n - 1, np.int32)
    dst = np.zeros(ep, np.int32)
    val = np.zeros(ep, np.float32)
    src[:e] = np.repeat(
        np.arange(n, dtype=np.int32), np.diff(a.indptr).astype(np.int64)
    )
    dst[:e] = a.indices.astype(np.int32)
    val[:e] = a.data
    return src, dst, val


def partition_edges_by_slab(src, dst, val, e_real: int, ndev: int, rs: int):
    """Split a src-SORTED flat edge list into per-device slabs of equal
    padded length ([ndev, Es] arrays). Filler edges sit at each slab's
    LAST row (keeps local src sorted) with val 0 (inert). Shared by the
    mesh modes of draw_graph and t-SNE."""

    bounds = np.searchsorted(src[:e_real], np.arange(ndev + 1) * rs)
    es_max = max(int(np.diff(bounds).max()), 1)
    es_pad = -(-es_max // 1024) * 1024
    e_src = np.empty((ndev, es_pad), np.int32)
    e_dst = np.zeros((ndev, es_pad), np.int32)
    e_val = np.zeros((ndev, es_pad), val.dtype)
    for dvc in range(ndev):
        lo, hi = int(bounds[dvc]), int(bounds[dvc + 1])
        e_src[dvc] = (dvc + 1) * rs - 1
        e_src[dvc, : hi - lo] = src[lo:hi]
        e_dst[dvc, : hi - lo] = dst[lo:hi]
        e_val[dvc, : hi - lo] = val[lo:hi]
    return e_src, e_dst, e_val


def _forces(y, mass, e_src, e_dst, e_val, *, scaling, gravity,
            strong_gravity: bool, lin_log: bool, outbound: bool,
            block: int):
    """Total ForceAtlas2 force field [n, dim] for positions ``y``."""

    n, dim = y.shape
    dt = y.dtype

    # -- attraction over stored edges (w already carries the delta power)
    diff = jnp.take(y, e_dst, axis=0) - jnp.take(y, e_src, axis=0)  # [E,dim]
    w = e_val
    if lin_log:
        d = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 1e-18))
        w = w * jnp.log1p(d) / d
    if outbound:
        # fa2: divide by the source mass AND compensate globally by the
        # mean mass (outboundAttCompensation), keeping the overall
        # attraction scale comparable to the non-distributed mode
        w = w * jnp.mean(mass) / jnp.take(mass, e_src, axis=0)
    attr = jax.ops.segment_sum(
        w[:, None] * diff, e_src, num_segments=n, indices_are_sorted=True
    )

    # -- exact blocked repulsion: F_i = scaling m_i sum_j m_j (y_i-y_j)/d2
    nb = -(-n // block)
    npad = nb * block
    yp = jnp.pad(y, ((0, npad - n), (0, 0)))
    mp = jnp.pad(mass, (0, npad - n))  # padded mass 0 -> inert
    sq = jnp.sum(yp * yp, axis=1)
    cols = jnp.arange(npad)

    def body(b, rep):
        yb = jax.lax.dynamic_slice(yp, (b * block, 0), (block, dim))
        sb = jax.lax.dynamic_slice(sq, (b * block,), (block,))
        d2 = jnp.maximum(
            sb[:, None]
            + sq[None, :]
            - 2.0
            * jax.lax.dot_general(
                yb, yp,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=dt,
                # HIGHEST is load-bearing: the default bf16 passes leave
                # O(1e-3 * |y|^2) error in d2, and 1/max(d2, eps) turns
                # that into ~1e9x repulsion spikes on whole tiles of
                # nearby points (observed as radius -> NaN;
                # the t-SNE tile survives bf16 only because its kernel
                # 1/(1+d2) is bounded)
                precision=MATMUL_PRECISION,
            ),
            1e-9,
        )
        r = b * block + jnp.arange(block)
        wgt = jnp.where(r[:, None] != cols[None, :], mp[None, :] / d2, 0.0)
        repb = jnp.sum(wgt, axis=1, keepdims=True) * yb - jnp.dot(
            wgt, yp, precision=MATMUL_PRECISION
        )
        return jax.lax.dynamic_update_slice(rep, repb, (b * block, 0))

    rep = jax.lax.fori_loop(
        0, nb, body, jnp.zeros((npad, dim), dt)
    )[:n]
    rep = scaling * mass[:, None] * rep

    # -- gravity toward the origin (fa2's apply_gravity: the strong
    # branch carries the scalingRatio coefficient, the lin branch does not)
    if strong_gravity:
        grav = -scaling * gravity * mass[:, None] * y
    else:
        dist = jnp.sqrt(jnp.maximum(jnp.sum(y * y, axis=1), 1e-18))
        grav = -gravity * mass[:, None] * y / dist[:, None]

    return attr + rep + grav


def _forces_slab(y, mass_pad, y_sl, m_sl, r0, e_src, e_dst, e_val, *,
                 scaling, gravity, strong_gravity: bool, lin_log: bool,
                 outbound: bool, block: int, mean_mass):
    """ForceAtlas2 forces for one row slab [rs, dim] against the full
    (replicated) position array ``y`` [npad, dim] — the per-device body
    of the mesh mode. ``e_*`` are the slab's own edges (src in the slab,
    GLOBAL ids); ``r0`` the slab's first global row."""

    rs, dim = y_sl.shape
    dt = y.dtype

    diff = jnp.take(y, e_dst, axis=0) - jnp.take(y, e_src, axis=0)
    w = e_val
    if lin_log:
        d = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 1e-18))
        w = w * jnp.log1p(d) / d
    if outbound:
        # padded slab rows carry mass 0 — their filler edges have w == 0,
        # so clamp the divisor to keep 0/0 out of the segment_sum
        w = w * mean_mass / jnp.maximum(
            jnp.take(mass_pad, e_src, axis=0), 1.0
        )
    attr = jax.ops.segment_sum(
        w[:, None] * diff, e_src - r0, num_segments=rs,
        indices_are_sorted=True,
    )

    sq = jnp.sum(y * y, axis=1)
    sq_sl = jnp.sum(y_sl * y_sl, axis=1)
    cols = jnp.arange(y.shape[0])
    nb = rs // block

    def body(b, rep):
        yb = jax.lax.dynamic_slice(y_sl, (b * block, 0), (block, dim))
        sb = jax.lax.dynamic_slice(sq_sl, (b * block,), (block,))
        d2 = jnp.maximum(
            sb[:, None]
            + sq[None, :]
            - 2.0
            * jax.lax.dot_general(
                yb, y,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=dt,
                precision=MATMUL_PRECISION,  # see _forces: 1/d2 vs bf16
            ),
            1e-9,
        )
        r = r0 + b * block + jnp.arange(block)
        wgt = jnp.where(
            r[:, None] != cols[None, :], mass_pad[None, :] / d2, 0.0
        )
        repb = jnp.sum(wgt, axis=1, keepdims=True) * yb - jnp.dot(
            wgt, y, precision=MATMUL_PRECISION
        )
        return jax.lax.dynamic_update_slice(rep, repb, (b * block, 0))

    rep = jax.lax.fori_loop(0, nb, body, jnp.zeros((rs, dim), dt))
    rep = scaling * m_sl[:, None] * rep

    if strong_gravity:
        grav = -scaling * gravity * m_sl[:, None] * y_sl
    else:
        dist = jnp.sqrt(jnp.maximum(sq_sl, 1e-18))
        grav = -gravity * m_sl[:, None] * y_sl / dist[:, None]

    return attr + rep + grav


@partial(
    jax.jit,
    static_argnames=(
        "strong_gravity", "lin_log", "outbound", "block", "rs", "n_real",
        "mesh", "axis_name",
    ),
)
def _fa2_chunk_mesh(
    state, mass_pad, mass_sh, e_src, e_dst, e_val, i0, i1,
    scaling, gravity, jitter_tolerance,
    strong_gravity, lin_log, outbound, block, rs, n_real, mesh,
    axis_name="rows",
):
    """Mesh-sharded FA2 iterations [i0, i1): each device owns a row slab
    (repulsion = its [block, npad] tiles, attraction = its src-local
    edges), the controller totals ride one psum, and positions are
    re-replicated with an all_gather per iteration (y is [npad, dim] —
    tiny next to the O(n^2 / ndev) repulsion each device just did)."""

    from jax.sharding import PartitionSpec as P

    ax = axis_name
    mean_mass = jnp.sum(mass_pad) / float(n_real)

    def run(mass_sl, es, ed, ev, y0, f0, sp0, ef0):
        d = jax.lax.axis_index(ax)
        r0 = d * rs
        mass_sl, es, ed, ev = mass_sl[0], es[0], ed[0], ev[0]

        def body(i, carry):
            y, f_prev, speed, speed_eff = carry
            # r0 is an int32 axis_index product; keep index dtypes uniform
            # under x64 mode
            z = jnp.zeros((), r0.dtype)
            y_sl = jax.lax.dynamic_slice(y, (r0, z), (rs, y.shape[1]))
            f_sl = _forces_slab(
                y, mass_pad, y_sl, mass_sl, r0, es, ed, ev,
                scaling=scaling, gravity=gravity,
                strong_gravity=strong_gravity, lin_log=lin_log,
                outbound=outbound, block=block, mean_mass=mean_mass,
            )
            fp_sl = jax.lax.dynamic_slice(
                f_prev, (r0, z), (rs, y.shape[1])
            )
            swing_i = jnp.sqrt(jnp.sum((f_sl - fp_sl) ** 2, axis=1))
            tract_i = 0.5 * jnp.sqrt(jnp.sum((f_sl + fp_sl) ** 2, axis=1))
            swinging = jnp.maximum(
                jax.lax.psum(jnp.sum(mass_sl * swing_i), ax), 1e-12
            )
            traction = jnp.maximum(
                jax.lax.psum(jnp.sum(mass_sl * tract_i), ax), 1e-12
            )
            est_jt = 0.05 * jnp.sqrt(jnp.asarray(float(n_real), y.dtype))
            jt = jitter_tolerance * jnp.clip(
                est_jt * traction / float(n_real) ** 2,
                jnp.sqrt(est_jt), 10.0,
            )
            speed_eff = jnp.where(
                swinging / traction > 2.0,
                jnp.maximum(speed_eff * 0.5, 0.05),
                speed_eff,
            )
            jt = jnp.where(swinging / traction > 2.0,
                           jnp.maximum(jt, jitter_tolerance), jt)
            target = jt * speed_eff * traction / swinging
            speed_eff = jnp.where(
                swinging > jt * traction,
                jnp.maximum(speed_eff * 0.7, 0.05),
                jnp.where(speed < 1000.0, speed_eff * 1.3, speed_eff),
            )
            speed_eff = jnp.minimum(speed_eff, 1.0)
            speed = speed + jnp.minimum(target - speed, 0.5 * speed)
            factor = speed / (1.0 + jnp.sqrt(speed * swing_i))
            disp = f_sl * factor[:, None]
            rms = jnp.sqrt(jnp.sum(y * y) / float(n_real)) + 1.0
            dnorm = jnp.sqrt(
                jnp.sum(disp * disp, axis=1, keepdims=True)
            )
            disp = disp * jnp.minimum(
                1.0, (0.5 * rms) / jnp.maximum(dnorm, 1e-12)
            )
            y_new = jax.lax.all_gather(y_sl + disp, ax).reshape(y.shape)
            f_new = jax.lax.all_gather(f_sl, ax).reshape(y.shape)
            return y_new, f_new, speed, speed_eff

        return jax.lax.fori_loop(i0, i1, body, (y0, f0, sp0, ef0))

    return jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(
            P(ax, None), P(ax, None), P(ax, None), P(ax, None),
            P(), P(), P(), P(),
        ),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )(mass_sh, e_src, e_dst, e_val, *state)


@partial(
    jax.jit,
    static_argnames=(
        "strong_gravity", "lin_log", "outbound", "block",
    ),
)
def _fa2_chunk(
    state, mass, e_src, e_dst, e_val, i0, i1,
    scaling, gravity, jitter_tolerance,
    strong_gravity, lin_log, outbound, block,
):
    """Iterations [i0, i1) of the FA2 descent — one device dispatch.

    Bounds are traced so a single compiled program serves every chunk and
    any total iteration count (the t-SNE knn-mode dispatch pattern)."""

    n = state[0].shape[0]
    force = partial(
        _forces,
        e_src=e_src, e_dst=e_dst, e_val=e_val,
        scaling=scaling, gravity=gravity,
        strong_gravity=strong_gravity, lin_log=lin_log,
        outbound=outbound, block=block,
    )

    def body(_, carry):
        y, f_prev, speed, speed_eff = carry
        f = force(y, mass)
        # fa2's global adaptive-speed controller: the TOTALS are
        # mass-weighted, the per-node displacement factor uses the RAW
        # per-node swinging (fa2 adjustSpeedAndApplyForces)
        swing_i = jnp.sqrt(jnp.sum((f - f_prev) ** 2, axis=1))
        tract_i = 0.5 * jnp.sqrt(jnp.sum((f + f_prev) ** 2, axis=1))
        swinging = jnp.maximum(jnp.sum(mass * swing_i), 1e-12)
        traction = jnp.maximum(jnp.sum(mass * tract_i), 1e-12)
        est_jt = 0.05 * jnp.sqrt(jnp.asarray(float(n), y.dtype))
        jt = jitter_tolerance * jnp.clip(
            est_jt * traction / float(n) ** 2, jnp.sqrt(est_jt), 10.0
        )
        speed_eff = jnp.where(
            swinging / traction > 2.0,
            jnp.maximum(speed_eff * 0.5, 0.05),
            speed_eff,
        )
        jt = jnp.where(swinging / traction > 2.0,
                       jnp.maximum(jt, jitter_tolerance), jt)
        target = jt * speed_eff * traction / swinging
        speed_eff = jnp.where(
            swinging > jt * traction,
            jnp.maximum(speed_eff * 0.7, 0.05),
            jnp.where(speed < 1000.0, speed_eff * 1.3, speed_eff),
        )
        # deviation from fa2: cap efficiency at its initial value. fa2's
        # 1.3x growth branch can compound unbounded (observed 400x on
        # fuzzy kNN graphs once forces align with gravity and swinging
        # stays tiny), launching nodes to 1e8 radii in the first chunk.
        speed_eff = jnp.minimum(speed_eff, 1.0)
        speed = speed + jnp.minimum(target - speed, 0.5 * speed)
        factor = speed / (1.0 + jnp.sqrt(speed * swing_i))
        # second stabilizer: bound any single displacement to a fraction
        # of the current RMS radius — one bad step cannot eject a node
        disp = f * factor[:, None]
        rms = jnp.sqrt(jnp.mean(jnp.sum(y * y, axis=1))) + 1.0
        dnorm = jnp.sqrt(jnp.sum(disp * disp, axis=1, keepdims=True))
        lim = 0.5 * rms
        disp = disp * jnp.minimum(1.0, lim / jnp.maximum(dnorm, 1e-12))
        y = y + disp
        return y, f, speed, speed_eff

    return jax.lax.fori_loop(i0, i1, body, state)


def draw_graph(
    adjacency,
    *,
    n_iter: int = 500,
    dim: int = 2,
    init=None,
    seed: int = 0,
    scaling: float = 2.0,
    gravity: float = 1.0,
    strong_gravity: bool = False,
    lin_log: bool = False,
    edge_weight_influence: float = 1.0,
    outbound_attraction_distribution: bool = False,
    jitter_tolerance: float = 1.0,
    repulsion_block: int = 2048,
    dispatch_chunk: int = 100,
    mesh=None,
) -> np.ndarray:
    """ForceAtlas2 layout of a (cell-cell) graph -> positions [n, dim].

    ``adjacency`` is a symmetric non-negative scipy sparse matrix or
    SparseMatrix — typically :func:`neighbors.connectivities` output, the
    same graph ``cluster.leiden`` consumes (scanpy's
    ``pp.neighbors -> tl.draw_graph`` chain). ``init`` seeds positions
    (e.g. PAGA coarse positions indexed by cluster, or a prior layout);
    default is a seeded random disc. Returns a host numpy array.

    ``mesh``: a ``jax.sharding.Mesh`` shards the O(n^2) repulsion and the
    edge attraction over row slabs (one psum for the speed controller +
    one [n, dim] all_gather per iteration — negligible next to the
    per-device [block, n] tiles).
    """

    from ..cluster import _as_sym_csr

    a = _as_sym_csr(adjacency)
    n = a.shape[0]
    if n < 2:
        raise ValueError("graph needs at least 2 nodes")
    if n_iter < 1:
        raise ValueError(f"n_iter={n_iter} must be >= 1")
    if dim < 1:
        raise ValueError(f"dim={dim} must be >= 1")

    deg = np.asarray(a.getnnz(axis=1), np.float32)
    mass = jnp.asarray(1.0 + deg)
    if edge_weight_influence == 0.0:
        w = np.ones_like(a.data)
    elif edge_weight_influence == 1.0:
        w = a.data
    else:
        w = np.power(a.data, edge_weight_influence)
    src, dst, val = _edge_list(
        a.__class__((w, a.indices, a.indptr), shape=a.shape), n
    )

    if init is not None:
        y0 = np.asarray(init, np.float32)
        if y0.shape != (n, dim):
            raise ValueError(
                f"init shape {y0.shape} != ({n}, {dim})"
            )
        y0 = jnp.asarray(y0)
    else:
        key = jax.random.PRNGKey(seed)
        y0 = jax.random.normal(key, (n, dim), jnp.float32) * float(
            np.sqrt(n)
        )

    c = max(int(dispatch_chunk), 1)
    scal = jnp.asarray(scaling, jnp.float32)
    grav = jnp.asarray(gravity, jnp.float32)
    jt = jnp.asarray(jitter_tolerance, jnp.float32)

    if mesh is not None:
        ax = mesh.axis_names[0]
        ndev = mesh.shape[ax]
        rs = max(-(-n // ndev), 8)
        block = min(repulsion_block, max(rs // 8 // 8 * 8, 8))
        rs = -(-rs // block) * block  # slab = whole blocks
        npad = ndev * rs
        e_src, e_dst, e_val = partition_edges_by_slab(
            src, dst, val.astype(np.float32), int(a.nnz), ndev, rs
        )
        mass_pad = jnp.pad(mass, (0, npad - n))
        mass_sh = mass_pad.reshape(ndev, rs)
        y0p = jnp.pad(y0, ((0, npad - n), (0, 0)))
        state = (
            y0p,
            jnp.zeros_like(y0p),
            jnp.asarray(1.0, jnp.float32),
            jnp.asarray(1.0, jnp.float32),
        )
        eargs = (
            jnp.asarray(e_src), jnp.asarray(e_dst), jnp.asarray(e_val),
        )
        for i0 in range(0, n_iter, c):
            state = _fa2_chunk_mesh(
                state, mass_pad, mass_sh, *eargs,
                jnp.int32(i0), jnp.int32(min(i0 + c, n_iter)),
                scal, grav, jt,
                strong_gravity, lin_log,
                outbound_attraction_distribution, block, rs, n, mesh, ax,
            )
        return np.asarray(state[0][:n])

    block = min(repulsion_block, max(-(-n // 8) // 128 * 128, 128))
    state = (
        y0,
        jnp.zeros_like(y0),
        jnp.asarray(1.0, jnp.float32),
        jnp.asarray(1.0, jnp.float32),
    )
    args = (
        mass, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(val),
    )
    for i0 in range(0, n_iter, c):
        state = _fa2_chunk(
            state, *args,
            jnp.int32(i0), jnp.int32(min(i0 + c, n_iter)),
            scal, grav, jt,
            strong_gravity, lin_log,
            outbound_attraction_distribution, block,
        )
    return np.asarray(state[0])
