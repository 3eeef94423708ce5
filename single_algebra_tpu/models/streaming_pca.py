"""Out-of-core streaming PCA: exact Gram-accumulation over row slabs.

The reference streams matrices larger than RAM through the caller-managed
``_chunk`` accumulation variants (``src/sparse/mod.rs:44-50``,
``csr.rs:124-151``): the caller owns the loop, the library owns the
per-chunk accumulation. This is the equivalent for PCA beyond device
memory: only one row slab plus the p x p Gram matrix ever live on the
device, so ``n`` is unbounded.

Per caller-supplied CSR chunk (any row count), internally re-slabbed to
fixed 8192-row device slabs:

1. host: slab -> column-tiled payload (C++ converter), ~2x-nnz bytes;
2. device (one fused donated dispatch): slab densify
   (``tiled_ell_densify_t``) -> ``G += D D^T`` on the tensor cores, plus
   per-slab column sums / squared sums;
3. host: f64 accumulation of the per-slab moment vectors (f32 on-device
   sums would drift over thousands of slabs).

``finalize()`` solves the top-k eigenpairs of the (optionally rank-1
centered) Gram with the jitted randomized SVD — exact PCA, same math as
:class:`~single_algebra_tpu.linalg.gram.GramPCAEngine`. ``transform``
streams slabs through the same payload machinery.

Statistics byproducts are free: after ``partial_fit`` passes,
``col_sums()`` / ``col_var()`` expose the accumulated moments — the
streaming analog of ``sum_col_chunk`` / ``var_col_chunk``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..linalg.gram import solve_gram_topk
from ..ops.tiled import tiled_ell_densify_t

__all__ = ["StreamingSparsePCA"]

_SLAB = 8192


def _prefetch(gen, depth: int = 2):
    """Run a payload-building generator on a worker thread, staying up to
    ``depth`` items ahead of the consumer.

    The slab payload build (native converter + padding copies) and the
    host->device transfer + dispatch are both seconds-scale at flagship
    shapes, and on the main thread they serialize: build slab i+1 only
    starts after slab i's ``device_put`` returns. The converter is a
    ctypes call (GIL released) and the transfer lives in the JAX runtime
    (GIL released), so one worker thread genuinely overlaps them —
    wall ~ max(build, transfer) instead of build + transfer per slab.
    The bounded queue is the backpressure: at most
    ``depth`` built payloads (+1 in the consumer's hands) exist at once.
    """

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: list = []
    stop = threading.Event()

    def run():
        try:
            for item in gen:
                # bounded put that re-checks the stop flag: if the
                # consumer abandons the generator mid-stream, a plain
                # q.put would block forever and pin up to `depth` built
                # super-slab payloads (hundreds of MB at mesh scale) for
                # the life of the process
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer thread
            err.append(e)
        finally:
            # the end marker waits for room like any item: dropping a
            # queued payload to make room would lose a slab the consumer
            # has not read. Only an abandoned consumer (stop set) lets
            # stale items go
            while True:
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass

    threading.Thread(target=run, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # consumer closed or raised: release the producer and drop any
        # queued payloads so their memory is reclaimable immediately
        stop.set()
        try:
            gen.close()
        except Exception:
            pass
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _bf16_exact(data: np.ndarray) -> bool:
    """bf16-round-trip exactness of a value slab (native early-exit pass;
    numpy fallback)."""

    from ..native import build as _native

    v = np.ascontiguousarray(data, np.float32)
    lib = _native.get_lib()
    if lib is not None:
        return bool(lib.f32_bf16_exact(v, len(v)))
    import ml_dtypes

    return not np.any(v - v.astype(ml_dtypes.bfloat16).astype(np.float32))


def _slab_payload(indptr, indices, data, n_rows, p, col_tile, exact=False):
    """Host-side: one 8192-row slab -> overflow-free tiled payload with
    wt rounded up to a multiple of 8 (few distinct widths -> few compiled
    accumulate variants).

    The returned arrays are in WIRE format: local ids as int16 (within-
    tile ids < col_tile <= 1024) and, when ``exact``, values as bf16 —
    the streaming path re-transfers the payload every pass (out-of-core
    contract), so the narrow dtypes cut the host-to-device bytes ~55%.
    The device graphs densify the narrow payload directly."""

    import ml_dtypes

    from ..sparse.convert import csr_to_tiled_ell_split_numpy

    td, tl, wt, nt, _, _, ovw = csr_to_tiled_ell_split_numpy(
        indptr, indices, data, n_rows, p,
        col_tile=col_tile, rows_padded_to=_SLAB, quantile=1.0,
    )
    assert ovw == 0
    if exact:
        td = td.astype(ml_dtypes.bfloat16)
    return td, tl.astype(np.int16), wt, nt


@partial(
    jax.jit,
    static_argnames=("wt", "ntiles", "ct", "exact"),
    donate_argnums=(0,),
)
def _accum_graph(G, td, tl, *, wt, ntiles, ct, exact):
    """One fused slab step: densify -> G += D D^T, return per-slab column
    moment vectors (f32; accumulated in f64 on the host)."""

    if exact:
        D = tiled_ell_densify_t(
            td, tl, wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=jnp.bfloat16,
        )
        G = G + jax.lax.dot_general(
            D, D, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        x = D.astype(jnp.float32)
    else:
        D = tiled_ell_densify_t(
            td, tl, wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=jnp.float32,
        )
        G = G + jax.lax.dot_general(
            D, D, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        x = D
    return G, jnp.sum(x, axis=1), jnp.sum(x * x, axis=1)


@partial(jax.jit, static_argnames=("wt", "ntiles", "ct"))
def _project_graph(td, tl, Vp, corr, *, wt, ntiles, ct):
    """One slab projection: ``D^T V - 1 corr^T`` ([SLAB, k])."""

    D = tiled_ell_densify_t(
        td, tl, wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=jnp.float32,
    )
    T = jax.lax.dot_general(
        D, Vp, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return T - corr[None, :]


@partial(
    jax.jit,
    static_argnames=("wt", "ntiles", "ct", "exact", "mesh", "ax"),
    donate_argnums=(0,),
)
def _accum_graph_mesh(G, td, tl, *, wt, ntiles, ct, exact, mesh, ax):
    """Sharded super-slab step: each device densifies its own sub-slab and
    contributes to the replicated Gram through one psum. td/tl are
    ``[ndev, nt*wt, SLAB]`` sharded on the leading axis."""

    from jax.sharding import PartitionSpec as P

    def local(G, td, tl):
        D = tiled_ell_densify_t(
            td[0], tl[0], wt=wt, ntiles=ntiles, col_tile=ct,
            out_dtype=jnp.bfloat16 if exact else jnp.float32,
        )
        if exact:
            Gp = jax.lax.dot_general(
                D, D, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        else:
            Gp = jax.lax.dot_general(
                D, D, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        x = D.astype(jnp.float32)
        Gp, s, sq = jax.lax.psum(
            (Gp, jnp.sum(x, axis=1), jnp.sum(x * x, axis=1)), ax
        )
        return G + Gp, s, sq

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(ax, None, None), P(ax, None, None)),
        out_specs=(P(), P(), P()),
    )(G, td, tl)


@partial(
    jax.jit, static_argnames=("wt", "ntiles", "ct", "mesh", "ax")
)
def _project_graph_mesh(td, tl, Vp, corr, *, wt, ntiles, ct, mesh, ax):
    """Sharded super-slab projection -> [ndev * SLAB, k] row-sharded."""

    from jax.sharding import PartitionSpec as P

    def local(td, tl, Vp, corr):
        D = tiled_ell_densify_t(
            td[0], tl[0], wt=wt, ntiles=ntiles, col_tile=ct,
            out_dtype=jnp.float32,
        )
        T = jax.lax.dot_general(
            D, Vp, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return T - corr[None, :]

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(ax, None, None), P(ax, None, None), P(), P()),
        out_specs=P(ax, None),
    )(td, tl, Vp, corr)


class StreamingSparsePCA:
    """Exact out-of-core PCA over row-slab streams of a CSR matrix.

    Usage::

        pca = StreamingSparsePCA(n_components=50, n_features=30000)
        for chunk in chunks:          # scipy.sparse CSR row slabs
            pca.partial_fit(chunk)
        pca.finalize()
        for chunk in chunks:
            scores = pca.transform(chunk)

    Matches :class:`SparsePCA` state fields (``components_``,
    ``explained_variance_``, ``mean_``) and the builder defaults for the
    solver. ``center=True`` gives true PCA; ``center=False`` the
    truncated SVD of raw X (the reference's Lanczos-path semantics).
    """

    def __init__(
        self,
        n_components: int = 50,
        n_features: int | None = None,
        center: bool = True,
        random_seed: int = 42,
        col_tile: int = 256,
        mesh=None,
        axis_name: str = "rows",
        fold_every: int | None = None,
        payload_cache: dict | None = None,
    ):
        if n_features is None:
            raise ValueError("n_features (matrix width) is required")
        if n_features > 40960:
            raise ValueError(
                "streaming Gram PCA needs the p x p Gram on device; "
                f"p={n_features} > 40960"
            )
        if not 8 <= col_tile <= 32767:
            # wire-format local ids are int16 (see _slab_payload)
            raise ValueError(f"col_tile={col_tile} out of range [8, 32767]")
        self.n_components = n_components
        self.n_features = n_features
        self.center = center
        self.random_seed = random_seed
        self.ct = col_tile
        # optional device mesh: each partial_fit super-slab (ndev * 8192
        # rows) is row-sharded, densified device-locally, and reduced into
        # the replicated Gram with one psum — out-of-core AND multi-chip
        self.mesh = mesh
        self.axis_name = axis_name
        self.ntiles = max(-(-n_features // col_tile), 1)
        pp = self.ntiles * col_tile
        self._G = jnp.zeros((pp, pp), jnp.float32)
        self._sums = np.zeros(pp, np.float64)
        self._sumsq = np.zeros(pp, np.float64)
        self._n = 0
        # f32 accumulation of G over an unbounded slab count drifts like
        # eps * sqrt(n_slabs); every `fold_every` slabs the device G is
        # folded into a host f64 accumulator (mirroring the column-moment
        # handling), bounding the drift to one fold group. The fold costs
        # a [pp, pp] device->host pull, so large Grams fold less often.
        if fold_every is None:
            fold_every = 256 if pp <= 8192 else 2048
        self.fold_every = fold_every
        self._G64: Optional[np.ndarray] = None
        self._slabs_since_fold = 0
        # pipeline window: per-slab moment pulls are deferred behind a
        # small deque so the host builds slab i+2's payload while the
        # device still chews on slab i (the pull is the only sync point);
        # every reader of the moments drains first
        self._pending: list = []
        self._pipeline_depth = 2
        # optional caller-owned device-payload cache: partial_fit(chunk,
        # key=...) stores the built (sharded) slab payloads under the
        # key; a later partial_fit with the same key skips the host
        # build AND the wire transfer entirely (the repeated-fit /
        # seed-sweep path — same contract as the sharded engines'
        # operator cache). The caller promises key -> content stability
        # and pays the aggregate device-memory residency (~wire_mb per
        # pass).
        self._payload_cache = payload_cache
        self.components_: Optional[jnp.ndarray] = None
        self.explained_variance_: Optional[jnp.ndarray] = None
        self.mean_: Optional[jnp.ndarray] = None
        self.total_variance_: Optional[float] = None

    def _drain_moments(self, keep: int = 0) -> None:
        """Pull queued per-slab moment vectors into the host f64
        accumulators, leaving at most ``keep`` dispatches in flight."""

        while len(self._pending) > keep:
            s, sq = self._pending.pop(0)
            self._sums += np.asarray(s, np.float64)
            self._sumsq += np.asarray(sq, np.float64)

    def _fold_gram(self) -> None:
        """Fold the device f32 Gram into the host f64 accumulator and
        reset the device accumulator."""

        if self._slabs_since_fold == 0:
            return
        if self._G64 is None:
            self._G64 = np.zeros(self._G.shape, np.float64)
        self._G64 += np.asarray(self._G, np.float64)
        self._G = jnp.zeros(self._G64.shape, jnp.float32)
        self._slabs_since_fold = 0

    def _count_slabs(self, k: int) -> None:
        self._slabs_since_fold += k
        if self._slabs_since_fold >= self.fold_every:
            self._fold_gram()

    def _invalidate_solve(self) -> None:
        """New data after finalize(): the Gram is additive, so keep
        accumulating and just drop the stale solve (true online PCA)."""

        if self.components_ is not None:
            self.components_ = None
            self.explained_variance_ = None
            self.mean_ = None
            self.total_variance_ = None

    # -- accumulation ----------------------------------------------------

    def _iter_slabs(self, chunk):
        """Yield (indptr, indices, data, n_rows) 8192-row sub-slabs of a
        scipy CSR (or SparseMatrix) chunk."""

        from ..sparse.matrix import SparseMatrix

        if isinstance(chunk, SparseMatrix):
            chunk = chunk.to_scipy().tocsr()
        chunk = chunk.tocsr()
        if chunk.shape[1] != self.n_features:
            raise ValueError(
                f"chunk width {chunk.shape[1]} != n_features "
                f"{self.n_features}"
            )
        n = chunk.shape[0]
        for r0 in range(0, n, _SLAB):
            r1 = min(r0 + _SLAB, n)
            sl = chunk[r0:r1]
            yield (
                sl.indptr.astype(np.int64),
                sl.indices.astype(np.int32),
                sl.data.astype(np.float32),
                r1 - r0,
            )

    def _iter_super_slabs(self, chunk):
        """Mesh mode: yield ``(td [ndev, nt*wt, SLAB], tl, wt, ntiles,
        n_rows, exact, n_real_slabs)`` stacked per-device payloads
        (common wt, zero-padded trailing sub-slabs; ``n_real_slabs`` =
        non-padding sub-slabs in the group, for fold accounting)."""

        ndev = self.mesh.shape[self.axis_name]
        slabs = list(self._iter_slabs(chunk))
        for g0 in range(0, len(slabs), ndev):
            group = slabs[g0 : g0 + ndev]
            # exactness decided for the whole group FIRST: the stacked
            # wire payload needs one dtype across devices
            exact = all(_bf16_exact(data) for _, _, data, _ in group)
            parts, wt = [], 8
            n_rows = 0
            for indptr, indices, data, nr in group:
                td, tl, wt_d, nt = _slab_payload(
                    indptr, indices, data, nr, self.n_features, self.ct,
                    exact=exact,
                )
                parts.append((td, tl, wt_d, nt))
                wt = max(wt, wt_d)
                n_rows += nr
            nt = parts[0][3]
            std = np.zeros((ndev, nt * wt, _SLAB), parts[0][0].dtype)
            stl = np.zeros((ndev, nt * wt, _SLAB), np.int16)
            for d, (td, tl, wt_d, _) in enumerate(parts):
                std[d] = np.pad(
                    td.reshape(nt, wt_d, _SLAB),
                    ((0, 0), (0, wt - wt_d), (0, 0)),
                ).reshape(nt * wt, _SLAB)
                stl[d] = np.pad(
                    tl.reshape(nt, wt_d, _SLAB),
                    ((0, 0), (0, wt - wt_d), (0, 0)),
                ).reshape(nt * wt, _SLAB)
            yield std, stl, wt, nt, n_rows, bool(exact), len(group)

    def _accum_entry(self, td_dev, tl_dev, wt, nt, n_rows, exact, n_real):
        """Accumulate one device-resident slab payload into G/moments."""

        if self.mesh is not None:
            self._G, s, sq = _accum_graph_mesh(
                self._G, td_dev, tl_dev,
                wt=wt, ntiles=nt, ct=self.ct, exact=exact,
                mesh=self.mesh, ax=self.axis_name,
            )
        else:
            self._G, s, sq = _accum_graph(
                self._G, td_dev, tl_dev,
                wt=wt, ntiles=nt, ct=self.ct, exact=exact,
            )
        self._pending.append((s, sq))
        self._n += n_rows
        # count REAL sub-slabs, not any zero-padded group width —
        # padding slabs add no f32 rounding, and overcounting fires the
        # [pp, pp] fold pull up to ndev-fold too often
        self._count_slabs(n_real)
        self._drain_moments(self._pipeline_depth)

    def partial_fit(self, chunk, *, key=None) -> "StreamingSparsePCA":
        """Accumulate one CSR row chunk (any row count) into the Gram and
        the column moments. Legal after ``finalize()`` too: the Gram is
        additive, so new data simply invalidates the solved state — call
        ``finalize()`` again for components over everything seen so far.

        ``key`` (with a ``payload_cache`` dict passed at construction)
        caches the built device payloads under ``(mode, key)``: repeated
        passes over unchanged chunks skip the host build and the wire
        transfer — the repeated-fit/seed-sweep path."""

        self._invalidate_solve()
        cache = self._payload_cache
        ck = ("mesh" if self.mesh is not None else "1dev", key, self.ct)
        if cache is not None and key is not None and ck in cache:
            for entry in cache[ck]:
                self._accum_entry(*entry)
            return self
        store = [] if (cache is not None and key is not None) else None

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            sh = NamedSharding(self.mesh, P(self.axis_name, None, None))
            for (
                std, stl, wt, nt, n_rows, exact, n_real
            ) in _prefetch(self._iter_super_slabs(chunk)):
                entry = (
                    jax.device_put(std, sh), jax.device_put(stl, sh),
                    wt, nt, n_rows, exact, n_real,
                )
                if store is not None:
                    store.append(entry)
                self._accum_entry(*entry)
        else:

            def built():
                for indptr, indices, data, n_rows in self._iter_slabs(chunk):
                    exact = _bf16_exact(data)
                    td, tl, wt, nt = _slab_payload(
                        indptr, indices, data, n_rows, self.n_features,
                        self.ct, exact=exact,
                    )
                    yield td, tl, wt, nt, n_rows, exact

            # deferred host f64 moment accumulation: draining to a
            # depth-2 window keeps the device ~2 slabs ahead of the host
            # payload build (bounded in-flight transfers as backpressure)
            for td, tl, wt, nt, n_rows, exact in _prefetch(built()):
                entry = (
                    jnp.asarray(td), jnp.asarray(tl),
                    wt, nt, n_rows, exact, 1,
                )
                if store is not None:
                    store.append(entry)
                self._accum_entry(*entry)
        if store is not None:
            cache[ck] = store
        return self

    # -- solve -------------------------------------------------------------

    def refit(self, n_components: int | None = None) -> "StreamingSparsePCA":
        """Re-solve from the accumulated Gram at a (possibly different)
        component count — costs only the tiny p-space solve, no pass over
        the data."""

        if n_components is not None:
            self.n_components = n_components
        self.components_ = None
        return self.finalize()

    def finalize(self) -> "StreamingSparsePCA":
        if self._n < 2:
            raise RuntimeError("need at least 2 accumulated rows")
        self._drain_moments(0)
        p, pp = self.n_features, self._G.shape[0]
        mean64 = self._sums / self._n
        self.mean_ = jnp.asarray(mean64[:p].astype(np.float32))
        mu_p = jnp.asarray(mean64.astype(np.float32))
        if self._G64 is not None:
            # drain the open fold group, solve on the f64-accumulated Gram
            # (rounded once to f32 — eps relative, slab-count independent)
            self._fold_gram()
            G_solve = jnp.asarray(self._G64.astype(np.float32))
        else:
            G_solve = self._G
        s, vt = solve_gram_topk(
            G_solve, mu_p, jnp.asarray(self._n), self.random_seed,
            k=self.n_components, center=self.center,
        )
        s_np = np.asarray(s, np.float64)
        self.components_ = vt[:, :p]
        self.explained_variance_ = jnp.asarray(
            (s_np**2 / (self._n - 1)).astype(np.float32)
        )
        if self.center:
            self.total_variance_ = float(
                np.sum(
                    (self._sumsq - mean64 * self._sums) / (self._n - 1)
                )
            )
        else:
            self.total_variance_ = float((s_np**2).sum() / (self._n - 1))
        return self

    # -- inference ---------------------------------------------------------

    def inverse_transform(self, T) -> np.ndarray:
        """Back-project scores: ``T @ components_`` (+ ``mean_`` when
        centered) — sklearn semantics, matching :class:`SparsePCA`."""

        if self.components_ is None:
            raise RuntimeError("Must be fitted before transform!")
        R = jnp.asarray(T, jnp.float32) @ self.components_
        if self.center:
            R = R + self.mean_
        return np.asarray(R)

    def transform(self, chunk) -> np.ndarray:
        """Project one CSR row chunk -> host scores [chunk_rows, k]."""

        if self.components_ is None:
            raise RuntimeError("Must be fitted before transform!")
        pp = self._G.shape[0]
        k = self.n_components
        Vp = jnp.pad(
            self.components_.T.astype(jnp.float32),
            ((0, pp - self.n_features), (0, 0)),
        )
        if self.center:
            from ..types import MATMUL_PRECISION

            corr = jnp.dot(
                self.mean_, self.components_.T,
                precision=MATMUL_PRECISION,
            )
        else:
            corr = jnp.zeros((k,), jnp.float32)
        # keep a small window of in-flight slab projections: the host
        # payload build overlaps the device dispatches, while draining the
        # oldest handle bounds device memory to ~window slabs (the
        # out-of-core contract: chunk size never dictates device memory)
        outs: list = []
        handles: list = []

        def drain(keep):
            while len(handles) > keep:
                T, nr = handles.pop(0)
                outs.append(np.asarray(T)[:nr])

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            sh = NamedSharding(self.mesh, P(self.axis_name, None, None))
            for (
                std, stl, wt, nt, n_rows, _, _nr
            ) in _prefetch(self._iter_super_slabs(chunk)):
                T = _project_graph_mesh(
                    jax.device_put(std, sh),
                    jax.device_put(stl, sh),
                    Vp, corr,
                    wt=wt, ntiles=nt, ct=self.ct,
                    mesh=self.mesh, ax=self.axis_name,
                )
                handles.append((T, n_rows))
                drain(self._pipeline_depth)
        else:

            def built():
                for indptr, indices, data, n_rows in self._iter_slabs(
                    chunk
                ):
                    td, tl, wt, nt = _slab_payload(
                        indptr, indices, data, n_rows, self.n_features,
                        self.ct, exact=_bf16_exact(data),
                    )
                    yield td, tl, wt, nt, n_rows

            for td, tl, wt, nt, n_rows in _prefetch(built()):
                T = _project_graph(
                    jnp.asarray(td), jnp.asarray(tl), Vp, corr,
                    wt=wt, ntiles=nt, ct=self.ct,
                )
                handles.append((T, n_rows))
                drain(self._pipeline_depth)
        drain(0)
        return np.concatenate(outs, axis=0)

    # -- streaming statistics byproducts ------------------------------------

    def col_sums(self) -> np.ndarray:
        """Accumulated f64 column sums (streaming ``sum_col_chunk``)."""

        if self._n < 1:
            raise RuntimeError("no rows accumulated yet")
        self._drain_moments(0)
        return self._sums[: self.n_features].copy()

    def col_sums_squared(self) -> np.ndarray:
        if self._n < 1:
            raise RuntimeError("no rows accumulated yet")
        self._drain_moments(0)
        return self._sumsq[: self.n_features].copy()

    def col_var(self) -> np.ndarray:
        """Bessel-corrected column variance over all accumulated rows
        (implicit zeros included — ``var_col`` semantics,
        reference ``csr.rs:641-657``)."""

        n = self._n
        if n < 2:
            raise RuntimeError(
                "need at least 2 accumulated rows for a variance"
            )
        self._drain_moments(0)
        mean = self._sums / n
        return (
            (self._sumsq - mean * self._sums) / (n - 1)
        )[: self.n_features]
