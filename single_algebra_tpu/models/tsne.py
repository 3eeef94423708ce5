"""t-SNE — exact and large-n modes as single jitted XLA programs.

The reference wraps the external ``bhtsne`` crate's Barnes-Hut tree code
behind ``TSNEConfig`` / ``run_f32`` / ``run_f64``
(``src/dimred/tsne/mod.rs:7-66``, marked WIP at ``tsne/mod.rs:1-2``).
Barnes-Hut trees are a CPU pointer structure with data-dependent control
flow — the opposite of what XLA wants. Two accelerator-idiomatic modes instead:

- ``exact`` (n up to ~16k): the n x n distance/affinity matrices are plain
  matmul/elementwise work, every epoch is two matmuls plus elementwise math, and the
  whole optimization runs inside ``lax.fori_loop`` with zero host
  round-trips. Corresponds to theta=0.
- ``knn`` (large n — the Barnes-Hut regime): the input-space affinity P is
  restricted to each point's k nearest neighbors (k = 3 * perplexity, the
  standard Barnes-Hut sparsification) and symmetrized into a padded ELL
  payload; the attraction term is a [n, w, dim] gather-free-form pass, and
  the repulsion term is computed EXACTLY in [block, n] matmul/elementwise tiles
  (O(n^2) flops, O(block * n) memory). Unlike Barnes-Hut, the repulsive
  forces carry no tree-approximation error — the O(n^2) pass that a CPU
  must approximate away is exactly the dense arithmetic an accelerator is built
  for. ``theta`` remains accepted for config parity and does not change
  the computation.

Standard t-SNE recipe (van der Maaten & Hinton): per-point perplexity
calibration by bisection on sigma, symmetrized P, early exaggeration,
momentum gradient descent on the student-t Q.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..types import MATMUL_PRECISION

__all__ = ["TSNEConfig", "run", "run_f32", "run_f64"]


@dataclasses.dataclass(frozen=True)
class TSNEConfig:
    """Mirror of the reference config (``tsne/mod.rs:7-13``)."""

    output_dim: int = 2
    perplexity: float = 30.0
    epochs: int = 1000
    theta: float = 0.5  # parity field; neither mode approximates

    # device-side knobs (defaults follow the standard reference implementation)
    learning_rate: float = 200.0
    early_exaggeration: float = 12.0
    exaggeration_epochs: int = 250
    initial_momentum: float = 0.5
    final_momentum: float = 0.8
    seed: int = 42

    # mode ladder: 'auto' picks 'exact' while the [n, n] affinity fits
    # comfortably (n <= exact_max_n), else 'knn' (sparse attraction +
    # blocked exact repulsion — the large-n mode)
    mode: str = "auto"
    knn_k: int | None = None  # default 3 * perplexity (BH convention)
    exact_max_n: int = 16384
    repulsion_block: int = 2048
    dispatch_chunk: int = 50  # knn-mode epochs per device dispatch


def _sq_dists(x):
    g = jnp.dot(x, x.T, precision=MATMUL_PRECISION)
    sq = jnp.diag(g)
    d = sq[:, None] + sq[None, :] - 2.0 * g
    return jnp.maximum(d, 0.0)


def _calibrate_p(d2, perplexity, iters=50):
    """Per-point bisection on beta = 1/(2 sigma^2) to hit log(perplexity)."""

    n = d2.shape[0]
    target = jnp.log(perplexity)
    eye = jnp.eye(n, dtype=bool)
    d2m = jnp.where(eye, jnp.inf, d2)

    def entropy_probs(beta):
        logits = -d2m * beta[:, None]
        logits = logits - jnp.max(
            jnp.where(eye, -jnp.inf, logits), axis=1, keepdims=True
        )
        w = jnp.where(eye, 0.0, jnp.exp(logits))
        sw = jnp.sum(w, axis=1, keepdims=True)
        p = w / jnp.maximum(sw, 1e-30)
        h = -jnp.sum(jnp.where(p > 0, p * jnp.log(p), 0.0), axis=1)
        return h, p

    def body(_, carry):
        beta, lo, hi = carry
        h, _ = entropy_probs(beta)
        too_high = h > target  # entropy too high -> increase beta
        lo = jnp.where(too_high, beta, lo)
        hi = jnp.where(too_high, hi, beta)
        beta = jnp.where(
            jnp.isinf(hi), beta * 2.0, (lo + hi) / 2.0
        )
        return beta, lo, hi

    beta0 = jnp.ones((n,), d2.dtype)
    lo0 = jnp.zeros((n,), d2.dtype)
    hi0 = jnp.full((n,), jnp.inf, d2.dtype)
    beta, _, _ = jax.lax.fori_loop(0, iters, body, (beta0, lo0, hi0))
    _, p = entropy_probs(beta)
    return p


def _descent_body(grad_fn, config: TSNEConfig, dt):
    """One-epoch update (early-exaggeration momentum descent with
    per-parameter gains — the standard optimizer), shared by the exact and
    knn modes; ``i`` is the ABSOLUTE epoch index."""

    def body(i, carry):
        y, vel, gains = carry
        exag = jnp.where(
            i < config.exaggeration_epochs,
            jnp.asarray(config.early_exaggeration, dt),
            jnp.asarray(1.0, dt),
        )
        momentum = jnp.where(
            i < config.exaggeration_epochs,
            jnp.asarray(config.initial_momentum, dt),
            jnp.asarray(config.final_momentum, dt),
        )
        g = grad_fn(y, exag)
        same_sign = (g > 0) == (vel > 0)
        gains = jnp.clip(
            jnp.where(same_sign, gains * 0.8, gains + 0.2), 0.01, None
        )
        vel = momentum * vel - config.learning_rate * gains * g
        y = y + vel
        y = y - jnp.mean(y, axis=0, keepdims=True)
        return y, vel, gains

    return body


def _descent(grad_fn, y0, config: TSNEConfig):
    body = _descent_body(grad_fn, config, y0.dtype)
    y, _, _ = jax.lax.fori_loop(
        0,
        config.epochs,
        body,
        (y0, jnp.zeros_like(y0), jnp.ones_like(y0)),
    )
    return y


@partial(jax.jit, static_argnames=("config",))
def _tsne_jit(x, config: TSNEConfig):
    n = x.shape[0]
    dt = x.dtype

    d2 = _sq_dists(x)
    p_cond = _calibrate_p(d2, jnp.asarray(config.perplexity, dt))
    p = (p_cond + p_cond.T) / (2.0 * n)
    p = jnp.maximum(p, 1e-12)

    key = jax.random.PRNGKey(config.seed)
    y0 = 1e-4 * jax.random.normal(key, (n, config.output_dim), dt)

    eye = jnp.eye(n, dtype=bool)

    def grad(y, exaggeration):
        d2y = _sq_dists(y)
        num = 1.0 / (1.0 + d2y)  # student-t kernel
        num = jnp.where(eye, 0.0, num)
        q = num / jnp.maximum(jnp.sum(num), 1e-12)
        q = jnp.maximum(q, 1e-12)
        pq = (exaggeration * p - q) * num  # [n, n]
        # dY_i = 4 sum_j pq_ij (y_i - y_j)
        row = jnp.sum(pq, axis=1, keepdims=True) * y
        mix = jnp.dot(pq, y, precision=MATMUL_PRECISION)
        return 4.0 * (row - mix)

    return _descent(grad, y0, config)


# -- large-n ('knn') mode ------------------------------------------------


@jax.jit
def _calibrate_p_knn(d2, perplexity, iters=50):
    """Per-point bisection on beta over the k NEAREST-NEIGHBOR squared
    distances only (rows of ``d2`` [n, k], self excluded) — the Barnes-Hut
    sparsification of the input affinities. Rows sum to 1."""

    target = jnp.log(perplexity)

    def entropy_probs(beta):
        logits = -d2 * beta[:, None]
        logits = logits - jnp.max(logits, axis=1, keepdims=True)
        w = jnp.exp(logits)
        p = w / jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1e-30)
        h = -jnp.sum(jnp.where(p > 0, p * jnp.log(p), 0.0), axis=1)
        return h, p

    def body(_, carry):
        beta, lo, hi = carry
        h, _ = entropy_probs(beta)
        too_high = h > target
        lo = jnp.where(too_high, beta, lo)
        hi = jnp.where(too_high, hi, beta)
        beta = jnp.where(jnp.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
        return beta, lo, hi

    n = d2.shape[0]
    beta0 = jnp.ones((n,), d2.dtype)
    lo0 = jnp.zeros((n,), d2.dtype)
    hi0 = jnp.full((n,), jnp.inf, d2.dtype)
    beta, _, _ = jax.lax.fori_loop(0, iters, body, (beta0, lo0, hi0))
    _, p = entropy_probs(beta)
    return p


def _symmetrize_knn(p_cond, idx, n):
    """Host-side setup: symmetrize the kNN conditional affinities into a
    FLAT edge list ``(src [E], dst [E], val [E])`` (CSR row order, so src
    is sorted) with ``P_sym[i, j] = (P[i|j] + P[j|i]) / (2n)``.

    A flat list, not a padded per-row layout: high-dimensional kNN graphs
    have hub points whose symmetrized in-degree is 10-100x the median (the
    classic hubness effect), so padding every row to the max width
    multiplies the payload; edges + sorted ``segment_sum`` cost O(E)
    regardless of the degree distribution. The edge count is padded to a
    multiple of 4096 (val=0 edges are inert) to keep recompiles bounded."""

    import numpy as _np
    import scipy.sparse as _sp

    k = idx.shape[1]
    rows = _np.repeat(_np.arange(n, dtype=_np.int64), k)
    P = _sp.coo_matrix(
        (_np.asarray(p_cond, _np.float64).ravel(),
         (rows, _np.asarray(idx, _np.int64).ravel())),
        shape=(n, n),
    ).tocsr()
    S = ((P + P.T) / (2.0 * n)).tocsr()
    S.sum_duplicates()
    e = int(S.nnz)
    ep = max(-(-e // 4096) * 4096, 4096)
    # pad src with n-1 (NOT 0): the attraction segment_sum declares
    # indices_are_sorted=True, and trailing zeros after CSR row order
    # would break the monotonicity contract (val=0 keeps padding inert)
    src = _np.full(ep, n - 1, _np.int32)
    dst = _np.zeros(ep, _np.int32)
    val = _np.zeros(ep, _np.float64)
    lens = _np.diff(S.indptr)
    src[:e] = _np.repeat(_np.arange(n, dtype=_np.int32), lens)
    dst[:e] = S.indices.astype(_np.int32)
    val[:e] = S.data
    return src, dst, val


def _knn_grad(y, e_src, e_dst, e_val, exag, *, block: int):
    """Exact-gradient t-SNE step for sparse P: edge-list attraction via a
    sorted ``segment_sum`` + BLOCKED exact repulsion ([block, n] tiles;
    O(n^2) flops, O(block * n) memory — the arithmetic Barnes-Hut
    approximates)."""

    n, dim = y.shape
    dt = y.dtype

    # attraction: sum_j p_ij num_ij (y_i - y_j) over stored edges
    diff = jnp.take(y, e_src, axis=0) - jnp.take(y, e_dst, axis=0)  # [E,dim]
    numa = 1.0 / (1.0 + jnp.sum(diff * diff, axis=-1))  # [E]
    attr = jax.ops.segment_sum(
        (e_val * numa)[:, None] * diff,
        e_src,
        num_segments=n,
        indices_are_sorted=True,
    )  # [n, dim]; padded edges carry val == 0

    # repulsion: rep_i = (1/Z) sum_j num_ij^2 (y_i - y_j), Z = sum num
    nb = -(-n // block)
    npad = nb * block
    yp = jnp.pad(y, ((0, npad - n), (0, 0)))
    sq = jnp.sum(yp * yp, axis=1)
    col_valid = jnp.arange(npad) < n

    def body(b, acc):
        rep, z = acc
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
            ),
            0.0,
        )
        num = 1.0 / (1.0 + d2)
        r = b * block + jnp.arange(block)
        mask = (
            (r[:, None] != jnp.arange(npad)[None, :])
            & col_valid[None, :]
            & (r < n)[:, None]
        )
        num = jnp.where(mask, num, 0.0)
        z = z + jnp.sum(num)
        num2 = num * num
        repb = jnp.sum(num2, axis=1, keepdims=True) * yb - jnp.dot(
            num2, yp, precision=MATMUL_PRECISION
        )
        rep = jax.lax.dynamic_update_slice(rep, repb, (b * block, 0))
        return rep, z

    rep0 = jnp.zeros((npad, dim), dt)
    rep, z = jax.lax.fori_loop(0, nb, body, (rep0, jnp.asarray(0.0, dt)))
    rep = rep[:n] / jnp.maximum(z, 1e-12)
    return 4.0 * (exag * attr - rep)


def _knn_grad_slab(y, y_sl, r0, e_src, e_dst, e_val, exag, *, block: int,
                   n_real: int, axis_name: str):
    """One device's share of the exact knn-mode gradient: attraction over
    its src-local edges + repulsion of its row slab against the full
    (replicated) y, with the student-t normalizer Z psum-reduced."""

    rs, dim = y_sl.shape
    dt = y.dtype
    npad = y.shape[0]

    diff = jnp.take(y, e_src, axis=0) - jnp.take(y, e_dst, axis=0)
    numa = 1.0 / (1.0 + jnp.sum(diff * diff, axis=-1))
    attr = jax.ops.segment_sum(
        (e_val * numa)[:, None] * diff,
        e_src - r0,
        num_segments=rs,
        indices_are_sorted=True,
    )

    sq = jnp.sum(y * y, axis=1)
    sq_sl = jnp.sum(y_sl * y_sl, axis=1)
    col_valid = jnp.arange(npad) < n_real
    nb = rs // block

    def body(b, acc):
        rep, z = acc
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
            ),
            0.0,
        )
        num = 1.0 / (1.0 + d2)
        r = r0 + b * block + jnp.arange(block)
        mask = (
            (r[:, None] != jnp.arange(npad)[None, :])
            & col_valid[None, :]
            & (r < n_real)[:, None]
        )
        num = jnp.where(mask, num, 0.0)
        z = z + jnp.sum(num)
        num2 = num * num
        repb = jnp.sum(num2, axis=1, keepdims=True) * yb - jnp.dot(
            num2, y, precision=MATMUL_PRECISION
        )
        rep = jax.lax.dynamic_update_slice(rep, repb, (b * block, 0))
        return rep, z

    rep0 = jnp.zeros((rs, dim), dt)
    rep, z_local = jax.lax.fori_loop(
        0, nb, body, (rep0, jnp.asarray(0.0, dt))
    )
    z = jnp.maximum(jax.lax.psum(z_local, axis_name), 1e-12)
    return 4.0 * (exag * attr - rep / z)


@partial(
    jax.jit,
    static_argnames=("config", "block", "rs", "n_real", "mesh", "axis_name"),
)
def _knn_epoch_chunk_mesh(
    state, e_src, e_dst, e_val, i0, i1, config: TSNEConfig,
    block: int, rs: int, n_real: int, mesh, axis_name: str = "rows",
):
    """Mesh-sharded epochs [i0, i1): y replicated (re-gathered each
    epoch), velocity/gains row-sharded, repulsion tiles and edge
    attraction local to each device, Z and nothing else crossing devices."""

    from jax.sharding import PartitionSpec as P

    ax = axis_name
    dt = state[0].dtype

    def run(es, ed, ev, y0, vel_sh, gains_sh):
        d = jax.lax.axis_index(ax)
        r0 = d * rs
        es, ed, ev = es[0], ed[0], ev[0]
        vel0, gains0 = vel_sh[0], gains_sh[0]
        z = jnp.zeros((), r0.dtype)

        def body(i, carry):
            y, vel, gains = carry
            exag = jnp.where(
                i < config.exaggeration_epochs,
                jnp.asarray(config.early_exaggeration, dt),
                jnp.asarray(1.0, dt),
            )
            momentum = jnp.where(
                i < config.exaggeration_epochs,
                jnp.asarray(config.initial_momentum, dt),
                jnp.asarray(config.final_momentum, dt),
            )
            y_sl = jax.lax.dynamic_slice(y, (r0, z), (rs, y.shape[1]))
            g = _knn_grad_slab(
                y, y_sl, r0, es, ed, ev, exag,
                block=block, n_real=n_real, axis_name=ax,
            )
            same_sign = (g > 0) == (vel > 0)
            gains = jnp.clip(
                jnp.where(same_sign, gains * 0.8, gains + 0.2), 0.01, None
            )
            vel = momentum * vel - config.learning_rate * gains * g
            y_sl = y_sl + vel
            # centering needs the global mean over REAL rows
            mean = jax.lax.psum(
                jnp.sum(
                    jnp.where(
                        (r0 + jnp.arange(rs) < n_real)[:, None], y_sl, 0.0
                    ),
                    axis=0,
                ),
                ax,
            ) / float(n_real)
            y_sl = jnp.where(
                (r0 + jnp.arange(rs) < n_real)[:, None], y_sl - mean, 0.0
            )
            y_new = jax.lax.all_gather(y_sl, ax).reshape(y.shape)
            return y_new, vel, gains

        y, vel, gains = jax.lax.fori_loop(i0, i1, body, (y0, vel0, gains0))
        return y, vel[None], gains[None]

    return jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(
            P(ax, None), P(ax, None), P(ax, None),
            P(), P(ax, None, None), P(ax, None, None),
        ),
        out_specs=(P(), P(ax, None, None), P(ax, None, None)),
        check_vma=False,
    )(e_src, e_dst, e_val, *state)


@partial(jax.jit, static_argnames=("config",))
def _knn_epoch_chunk(state, e_src, e_dst, e_val, i0, i1, config: TSNEConfig):
    """Run epochs [i0, i1) of the knn-mode descent — ONE device dispatch.

    The epoch bounds are DYNAMIC (traced), so one compiled program serves
    every chunk and every total epoch count; the host loop in
    :func:`_run_knn` carries ``state`` across chunks. Chunking (rather
    than one fori_loop over all epochs) bounds single-execution device
    time: a 500-epoch single execution at n ~ 10^5 runs for a long time
    in one launch and recompiles whenever ``epochs`` changes."""

    n = state[0].shape[0]
    block = min(config.repulsion_block, max(-(-n // 8) // 128 * 128, 128))
    grad = partial(
        _knn_grad, e_src=e_src, e_dst=e_dst, e_val=e_val, block=block
    )
    body = _descent_body(
        lambda y, exag: grad(y, exag=exag), config, state[0].dtype
    )
    return jax.lax.fori_loop(i0, i1, body, state)


def _run_knn(x, config: TSNEConfig, mesh=None) -> jnp.ndarray:
    from .umap import _knn_graph

    n = x.shape[0]
    k = config.knn_k or int(min(n - 1, round(3 * config.perplexity)))
    if k < config.perplexity:
        raise ValueError(
            f"knn_k={k} < perplexity={config.perplexity}: the entropy "
            "target is unreachable over so few neighbors"
        )
    import numpy as _np

    d, idx = _knn_graph(
        jnp.asarray(x, jnp.float32), k=k, block=min(2048, max(8, n))
    )
    p_cond = _calibrate_p_knn(
        jnp.asarray(d, x.dtype) ** 2, jnp.asarray(config.perplexity, x.dtype)
    )
    src, dst, val = _symmetrize_knn(_np.asarray(p_cond), _np.asarray(idx), n)
    src, dst = jnp.asarray(src), jnp.asarray(dst)
    val = jnp.asarray(val, x.dtype)

    dt = val.dtype
    key = jax.random.PRNGKey(config.seed)
    y0 = 1e-4 * jax.random.normal(key, (n, config.output_dim), dt)
    # the chunk program does not read config.epochs — normalize it out of
    # the static key so changing the total never recompiles
    chunk_cfg = dataclasses.replace(config, epochs=0)
    c = max(int(config.dispatch_chunk), 1)

    if mesh is not None:
        from .draw_graph import partition_edges_by_slab

        ax = mesh.axis_names[0]
        ndev = mesh.shape[ax]
        rs = max(-(-n // ndev), 8)
        block = min(config.repulsion_block, max(rs // 8 // 8 * 8, 8))
        rs = -(-rs // block) * block
        npad = ndev * rs
        es, ed, ev = partition_edges_by_slab(
            _np.asarray(src), _np.asarray(dst),
            _np.asarray(val), len(_np.asarray(src)), ndev, rs,
        )
        dimo = config.output_dim
        state = (
            jnp.pad(y0, ((0, npad - n), (0, 0))),
            jnp.zeros((ndev, rs, dimo), dt),
            jnp.ones((ndev, rs, dimo), dt),
        )
        for i0 in range(0, config.epochs, c):
            state = _knn_epoch_chunk_mesh(
                state, jnp.asarray(es), jnp.asarray(ed),
                jnp.asarray(ev, dt),
                jnp.int32(i0), jnp.int32(min(i0 + c, config.epochs)),
                chunk_cfg, block, rs, n, mesh, ax,
            )
        return state[0][:n]

    state = (
        y0,
        jnp.zeros((n, config.output_dim), dt),
        jnp.ones((n, config.output_dim), dt),
    )
    for i0 in range(0, config.epochs, c):
        state = _knn_epoch_chunk(
            state, src, dst, val,
            jnp.int32(i0), jnp.int32(min(i0 + c, config.epochs)),
            chunk_cfg,
        )
    return state[0]


def run(x, config: TSNEConfig | None = None, *, mesh=None) -> jnp.ndarray:
    """Embed rows of ``x`` [n, d] into ``config.output_dim`` dimensions.

    ``config.mode``: 'exact' (n x n affinities), 'knn' (sparse attraction
    + blocked exact repulsion — the large-n mode), or 'auto' (exact while
    ``n <= config.exact_max_n``).

    ``mesh``: a ``jax.sharding.Mesh`` shards the knn-mode layout over row
    slabs (repulsion tiles + src-local attraction per device, Z psum'd,
    one [n, dim] all_gather per epoch) — forces 'knn' mode."""

    if config is None:
        config = TSNEConfig()
    x = jnp.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"expected [n, d] input, got shape {x.shape}")
    if x.shape[0] <= config.perplexity * 3:
        raise ValueError(
            f"perplexity {config.perplexity} too large for n={x.shape[0]}"
        )
    mode = config.mode
    if mode == "auto":
        mode = "exact" if x.shape[0] <= config.exact_max_n else "knn"
    if mesh is not None:
        mode = "knn"  # the sharded layout is the knn-mode formulation
    if mode == "exact":
        return _tsne_jit(x, config)
    if mode != "knn":
        raise ValueError(f"unknown t-SNE mode {config.mode!r}")
    return _run_knn(x, config, mesh=mesh)


def run_f32(x, config: TSNEConfig | None = None) -> jnp.ndarray:
    """Reference-parity alias (``tsne/mod.rs:15``)."""

    return run(jnp.asarray(x, jnp.float32), config)


def run_f64(x, config: TSNEConfig | None = None) -> jnp.ndarray:
    """Reference-parity alias (``tsne/mod.rs:41``); needs x64 mode."""

    return run(jnp.asarray(x, jnp.float64), config)
