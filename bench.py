"""Benchmark: the north-star workload on the GPU.

Measures 50-component randomized-SVD PCA ``fit_transform`` (oversamples=10,
power iterations=7, QR normalizer — the reference README's recommended
config, ``engine='auto'``) on a seeded synthetic scRNA-scale CSR matrix.
It needs a GPU and fails on any other device.

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"device"}``, where ``device`` names the card as JAX reports it and its
power limit as ``nvidia-smi`` reports it.

``value`` is the warm end-to-end fit_transform wall time with the same
endpoints as the CPU reference: the fused fit graph executes on device AND
the model state (components / explained variance / mean) plus the full
embedding matrix T are materialized on the host — what the reference hands
its caller in RAM. The device-resident warm time and the T pull are broken
out in the stderr detail as ``warm_device_s`` / ``t_pull_T_s``.

``vs_baseline`` is measured / measured: the single-core CPU wall time of
the reference algorithm (Halko randomized SVD over scipy sparse matmuls —
the algorithm single-svdlib implements, identical sketch/power/oversample
parameters, T in RAM at the end) divided by ``value``. The single-core
measurements are cached in ``BASELINE_LOCAL.json``; delete that file to
re-measure.

The default shape (200k x 20k at d=0.1 — the reference's own criterion
bench density, ``benches/csr_matrix_benchmark.rs:28``); ``--full`` /
``--big`` keep the d=0.03 shapes.

Usage: ``python bench.py`` | ``--full`` | ``--big`` | ``--smoke``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HUGE = dict(n=200_000, p=20_000, density=0.1, k=50)
FULL = dict(n=100_000, p=10_000, density=0.03, k=50)
BIG = dict(n=200_000, p=20_000, density=0.03, k=50)
SMOKE = dict(n=20_000, p=2_000, density=0.02, k=20)
SEED = 42

BASELINE_CACHE = os.path.join(os.path.dirname(__file__), "BASELINE_LOCAL.json")


def make_matrix(n, p, density, seed=SEED):
    """Seeded scRNA-like count matrix (integer UMI-style values)."""

    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    nnz_target = int(n * p * density)
    if nnz_target >= 100_000_000:
        # scipy.sparse.random's unique-position sampling is minutes-slow at
        # this scale; sample positions WITH replacement instead (duplicates
        # sum on CSR conversion, realized density ~ 1 - exp(-density)).
        # Values stay integer counts (bf16-exact), determinism stays seeded.
        rows = rng.integers(0, n, nnz_target, dtype=np.int64)
        cols = rng.integers(0, p, nnz_target, dtype=np.int32)
        vals = (rng.poisson(1.5, nnz_target) + 1).astype(np.float32)
        return sp.coo_matrix((vals, (rows, cols)), shape=(n, p)).tocsr()
    mat = sp.random(
        n,
        p,
        density=density,
        format="csr",
        dtype=np.float64,
        random_state=rng,
        data_rvs=lambda size: (rng.poisson(1.5, size) + 1).astype(np.float64),
    )
    return mat.astype(np.float32)


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def device_info() -> dict:
    """The GPU as JAX and ``nvidia-smi`` name it; any other device is an
    error."""

    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's device is {d.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[d.id].strip()
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def run_device(X, k):
    import jax

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.linalg import DensifiedOperator
    from single_algebra_tpu.models import SparsePCABuilder
    from single_algebra_tpu.types import PowerIterationNormalizer, SVDMethod

    method = SVDMethod.random(10, 7, PowerIterationNormalizer.QR)

    t0 = time.perf_counter()
    dense_path = DensifiedOperator.fits(X.shape)
    # the dense engine never touches the sparse device layouts — keep them
    # host-side and skip the transpose build
    m = SparseMatrix.from_scipy(X, device=not dense_path)
    if not dense_path:
        m.transpose()  # sparse path needs both ELL orientations
    t_load = time.perf_counter() - t0
    _log(f"load done in {t_load:.1f}s (dense_path={dense_path})")

    def one_fit():
        pca = (
            SparsePCABuilder()
            .n_components(k)
            .svd_method(method)
            .random_seed(SEED)
            .build()
        )
        t1 = time.perf_counter()
        T = pca.fit_transform(m)
        # fit() pulls the singular values of the one fused (SVD -> flip ->
        # project) dispatch, so reaching here means the whole graph —
        # including T — has executed; materialize the model state on host
        # in ONE round trip (what the reference hands back to its caller).
        jax.device_get((pca.components_, pca.explained_variance_, pca.mean_))
        t_done = time.perf_counter() - t1
        np.asarray(T)  # separately: the full embedding pull
        t_pull = time.perf_counter() - t1 - t_done
        return t_done, t_pull, pca

    t_cold, t_cold_pull, _ = one_fit()  # includes compile + operator build
    _log(f"cold fit done in {t_cold:.1f}s (+{t_cold_pull:.1f}s T pull)")
    warms, pulls = [], []
    for _ in range(5):
        t_w, t_p, pca = one_fit()
        warms.append(t_w)
        pulls.append(t_p)
    # the best whole run: combining the best fit of one run with the best
    # pull of another would report a time no run achieved
    best = min(range(5), key=lambda i: warms[i] + pulls[i])
    _log(
        f"warm fit done in {warms[best]:.2f}s + {pulls[best]:.2f}s T pull "
        f"(runs: {[round(w, 3) for w in warms]})"
    )
    return dict(
        load=t_load, cold=t_cold, warm=warms[best], pull_T=pulls[best],
        pca=pca, m=m, method=method, warm_runs=[round(w, 3) for w in warms],
    )


def measure_pipelined(dev, k):
    """Device-side fit cost under pipelined dispatch: enqueue several fit
    graphs back-to-back (JAX async dispatch) and sync once — host round
    trips and state pulls amortize away, leaving the per-fit device graph
    time a host sees when fitting repeatedly (refits, seed sweeps, masked
    variants). Distinct seeds keep the executions distinct."""

    import jax

    from single_algebra_tpu.models.pca import _fit_graph, make_engine_operator

    m, pca, method = dev["m"], dev["pca"], dev["method"]
    op = make_engine_operator(m, "auto")
    reps = 4

    def enqueue():
        return [
            _fit_graph(
                op, pca.mean_, SEED + 1 + i, k=k, method=method,
                center=True, steps=None, want_transform=True, tol=1e-6,
                lanczos_block=None,
            )
            for i in range(reps)
        ]

    outs = enqueue()
    jax.block_until_ready(outs[-1][0])  # compile (seed is traced: cached)
    t0 = time.perf_counter()
    outs = enqueue()
    jax.block_until_ready([o[0] for o in outs])
    t_graph = (time.perf_counter() - t0) / reps
    _log(f"pipelined device graph: {t_graph:.3f}s/fit (x{reps})")
    return t_graph


def run_cpu_reference(X, k):
    """Single-core CPU pipeline: implicitly centered Halko randomized SVD
    over scipy sparse matmuls — the same algorithm the reference's
    single-svdlib implements (Gaussian sketch, QR-normalized power
    iterations, oversampling), so timings are apples-to-apples.

    Returns (total_s, spmm_s, dense_s, s[:k]): total wall time plus the
    split between the sparse-matvec portion (Rayon-parallel in the
    reference) and the dense-LA portion (serial nalgebra QR/SVD).
    """

    import scipy.linalg as sla

    mu = np.asarray(X.mean(axis=0)).ravel().astype(X.dtype)
    n = X.shape[0]
    acc = {"spmm": 0.0}

    def _timed_sp(fn):
        t = time.perf_counter()
        out = fn()
        acc["spmm"] += time.perf_counter() - t
        return out

    def mv(V):  # (X - 1 mu^T) @ V
        return _timed_sp(
            lambda: X @ V - np.broadcast_to(mu @ V, (n, V.shape[1]))
        )

    def rmv(V):  # (X - 1 mu^T)^T @ V
        return _timed_sp(lambda: X.T @ V - np.outer(mu, V.sum(axis=0)))

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    l = min(k + 10, min(X.shape))
    Y = mv(rng.standard_normal((X.shape[1], l)).astype(X.dtype))
    for _ in range(7):
        Y, _ = sla.qr(Y, mode="economic")
        Z = rmv(Y)
        Z, _ = sla.qr(Z, mode="economic")
        Y = mv(Z)
    Q, _ = sla.qr(Y, mode="economic")
    B = rmv(Q).T  # [l, p]
    ub, s, vt = sla.svd(B, full_matrices=False)
    T = mv(vt[:k].T)
    del T
    dt = time.perf_counter() - t0
    return dt, acc["spmm"], dt - acc["spmm"], s[:k]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--shape", default=None,
                    help="override: n,p,density,k (e.g. 300000,20000,0.1,50)")
    args = ap.parse_args()
    cfg = (
        SMOKE
        if args.smoke
        else (BIG if args.big else (FULL if args.full else HUGE))
    )
    if args.shape:
        n_, p_, d_, k_ = args.shape.split(",")
        cfg = dict(n=int(n_), p=int(p_), density=float(d_), k=int(k_))

    device = device_info()
    from single_algebra_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    key = f"{cfg['n']}x{cfg['p']}x{cfg['density']}x{cfg['k']}"
    cache = {}
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            cache = json.load(f)
    cpu = cache.get(key)

    X = make_matrix(cfg["n"], cfg["p"], cfg["density"])
    _log(f"matrix ready: {X.shape} nnz={X.nnz}")
    dev = run_device(X, cfg["k"])

    if cpu is None and not args.skip_cpu:
        total, spmm, dense, _ = run_cpu_reference(X, cfg["k"])
        cpu = {"total_1core_s": total, "spmm_s": spmm, "dense_s": dense}
        cache[key] = cpu
        with open(BASELINE_CACHE, "w") as f:
            json.dump(cache, f)

    warm_e2e = dev["warm"] + dev["pull_T"]
    vs = cpu["total_1core_s"] / warm_e2e if cpu else None
    t_graph = measure_pipelined(dev, cfg["k"])
    print(
        json.dumps({"detail": {
            "load_s": dev["load"],
            "cold_s": dev["cold"],
            "warm_device_s": dev["warm"],
            "t_pull_T_s": dev["pull_T"],
            "warm_incl_T_pull_s": warm_e2e,
            "cpu_1core_s": cpu["total_1core_s"] if cpu else None,
            "cpu_1core_spmm_s": cpu["spmm_s"] if cpu else None,
            "cpu_1core_dense_s": cpu["dense_s"] if cpu else None,
            "graph_pipelined_s": t_graph,
            "warm_runs_s": dev["warm_runs"],
        }}),
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": (
            f"PCA fit_transform (randomized k={cfg['k']}, os=10, q=7, QR) "
            f"on {cfg['n']}x{cfg['p']} CSR d={cfg['density']} "
            f"({X.nnz} nnz), warm wall time incl. pulling T + model state "
            "to host; vs_baseline = measured 1-core CPU Halko reference / "
            "this (same endpoints)"
        ),
        "value": warm_e2e,
        "unit": "s",
        "vs_baseline": vs,
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
