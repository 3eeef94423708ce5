"""Smoke run of single_algebra_tpu on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --mesh4   # four cards: the sharded path only

One process drives the card(s). Each phase prints one JSON line with its
wall seconds; a failing phase ends the run with a non-zero exit. The
phases, in order:

* ``device``: the default device must be a GPU (there is no CPU fallback).
  Prints its kind and count, ``nvidia-smi``'s name and power limit, and
  whether the native host converters loaded.
* ``kernels``: the tiled densify and products (``ops/tiled.py``) against
  scipy in f64 at real widths: densify at pp = 30,720 with an 8,192-row
  slab in int8, bf16 and f32 (exact), and the products at p = 49,152 on
  an f32 payload at HIGHEST and on a bf16 payload (relative error
  <= 1e-5).
* ``pca_northstar``: ``SparsePCABuilder`` with randomized SVD (k = 50,
  10 oversamples, 7 power iterations, QR) and ``engine='auto'`` on the
  1,000,000 x 30,000 planted matrix (294,197,072 nnz), explained variance
  against the committed f64 truth (<= 1e-5). Prints the engine and the
  Gram tier chosen and the GEMM the int8 tier compiled to.
* ``engines``: every engine and ``StreamingSparsePCA`` at 1,000,000 x
  2,500 (16 clusters, k = 16) against host f64 ``eigh`` of ``X^T X``:
  gram and streaming <= 1e-6, the randomized-sketch engines <= 1e-4 on
  the components clear of the noise bulk (see :func:`check_engines`).
* ``pipeline``: ``examples/scrna_pipeline.run`` at 50,000 cells x 10,000
  genes; every stage's output must be finite.

``--mesh4`` runs, over a four-device mesh at 1,000,000 x 30,000,
``sharded_pca_fit_transform`` with the engine ``choose_sharded_engine``
picks, ``sharded_gram_pca`` and ``StreamingSparsePCA(mesh=...)``, each
against the same committed truth.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The ``check_*`` functions are shared with the GPU tests (``tests/test_gpu.py``),
which call them at smaller sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TRUTH_DIR = os.path.join(ROOT, "benchmarks", "_truth_cache")

# the flagship shape: BASELINE.json's metric, benchmarks/accuracy_at_scale.py
NORTHSTAR = dict(n=1_000_000, p=30_000, density=0.01, seed=7, n_clusters=64)
NORTHSTAR_NNZ = 294_197_072
# the reference's stress width (10M x 2,500) with n cut to 1M
STRESS = dict(n=1_000_000, p=2_500, density=0.01, seed=7, n_clusters=16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def ev_rel_err(ev, ev_ref) -> float:
    """Explained-variance error relative to the largest true value."""

    ev = np.asarray(ev, np.float64)[: len(ev_ref)]
    return float(np.abs(ev - ev_ref).max() / ev_ref[0])


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def planted_counts(n, p, density, seed, n_clusters):
    """The benchmarks' planted-spectrum raw counts (float32 CSR)."""

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from _datagen import cluster_counts_big

    X = cluster_counts_big(
        n, p, n_clusters=n_clusters, seed=seed, density=density
    )
    return X.astype(np.float32)


def host_truth_ev(X, k: int):
    """Top-k centered explained variances in f64 (sparse Gram + eigh)."""

    import scipy.sparse as sp

    n, p = X.shape
    X64 = sp.csr_matrix(X, dtype=np.float64)
    G = (X64.T @ X64).toarray()
    mu = np.asarray(X64.mean(axis=0)).ravel()
    Gc = G - n * np.outer(mu, mu)
    if p <= 4096:
        w = np.linalg.eigvalsh(Gc)[::-1][:k]
    else:
        from scipy.sparse.linalg import eigsh

        w = np.sort(eigsh(Gc, k=k, which="LA")[0])[::-1]
    return w / (n - 1)


def northstar_truth(X, k: int):
    """The committed f64 truth for the flagship matrix, else computed."""

    path = os.path.join(
        TRUTH_DIR, f"northstar_{X.shape[0]}x{X.shape[1]}_{X.nnz}_ev.npy"
    )
    if os.path.exists(path):
        return np.load(path)[:k]
    return host_truth_ev(X, k)


def randomized(k_os=10, q=7):
    from single_algebra_tpu.types import PowerIterationNormalizer, SVDMethod

    return SVDMethod.random(k_os, q, PowerIterationNormalizer.QR)


# ---------------------------------------------------------------------------
# checks (shared with tests/test_gpu.py)
# ---------------------------------------------------------------------------


def check_device(require_gpu: bool = True) -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    if require_gpu and d.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {d.platform} ({d.device_kind})"
        )
    from single_algebra_tpu.native import build as native

    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "count": len(devs),
        "native_converters": native.get_lib() is not None,
        "native_leiden": native.get_leiden_lib() is not None,
    }


def nvidia_smi() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _tiled_layout(X, col_tile, rows_padded_to):
    import jax.numpy as jnp

    from single_algebra_tpu.sparse.convert import csr_to_tiled_ell_numpy

    n, p = X.shape
    td, tl, wt, nt = csr_to_tiled_ell_numpy(
        X.indptr, X.indices, X.data, n, p, col_tile=col_tile,
        rows_padded_to=rows_padded_to,
    )
    return (
        jnp.asarray(np.ascontiguousarray(td.T)),
        jnp.asarray(np.ascontiguousarray(tl.T)),
        wt,
        nt,
    )


def check_densify(rows=8192, p=30_000, col_tile=1024, density=0.01,
                  seed=0) -> dict:
    """One Gram slab densified in each tier's dtype equals scipy exactly."""

    import jax.numpy as jnp
    import ml_dtypes
    import scipy.sparse as sp

    from single_algebra_tpu.ops.tiled import tiled_ell_densify_t

    rng = np.random.default_rng(seed)
    X = sp.random(
        rows, p, density=density, format="csr", dtype=np.float64,
        random_state=rng, data_rvs=lambda s: 1.0 + rng.poisson(2.0, s),
    ).astype(np.float32)
    td, tl, wt, nt = _tiled_layout(X, col_tile, rows)
    pp = nt * col_tile
    ref = X.toarray().T  # [p, rows] f32, integer-valued
    out = {"pp": pp, "slab": int(td.shape[1]), "wt": wt}
    for name, dt, np_dt in (
        ("int8", jnp.int8, np.int8),
        ("bf16", jnp.bfloat16, ml_dtypes.bfloat16),
        ("f32", jnp.float32, np.float32),
    ):
        D = np.asarray(tiled_ell_densify_t(
            td, tl, wt=wt, ntiles=nt, col_tile=col_tile, out_dtype=dt,
        ))
        require(D.shape == (pp, td.shape[1]), f"densify {name} shape")
        err = float(np.abs(
            D[:p, :rows].astype(np.float64) - ref.astype(np_dt)
        ).max())
        pad = bool(D[p:].any() or D[:, rows:].any())
        out[f"densify_{name}_max_abs_err"] = err
        require(err == 0.0 and not pad, f"densify {name}: err {err}")
        del D
    out["densify_tolerance"] = 0.0
    return out


def check_tiled_products(n=150_000, p=49_152, k=64, density=0.004,
                         col_tile=256, seed=1, tol=1e-5) -> dict:
    """A @ B and A^T @ C over the tiled layout against scipy in f64: an f32
    payload at HIGHEST (the gather / scatter-add forms) and a bf16 payload
    with a bf16 operand (the densify-then-matmul form of ``A @ B``),
    whose reference is the f64 product of the same bf16-rounded inputs."""

    import jax.numpy as jnp
    import ml_dtypes
    import scipy.sparse as sp

    from single_algebra_tpu.ops.tiled import tiled_ell_rmv_t, tiled_ell_spmm_t

    rng = np.random.default_rng(seed)
    X = sp.random(
        n, p, density=density, format="csr", dtype=np.float64,
        random_state=rng, data_rvs=rng.random,
    ).astype(np.float32)
    td, tl, wt, nt = _tiled_layout(X, col_tile, 1024)
    R = td.shape[1]
    B = rng.standard_normal((p, k)).astype(np.float32)
    C = rng.standard_normal((n, k)).astype(np.float32)
    Bt = np.zeros((k, nt * col_tile), np.float32)
    Bt[:, :p] = B.T
    Ct = np.zeros((k, R), np.float32)
    Ct[:, :n] = C.T
    out = {"shape": [n, p], "k": k, "nnz": int(X.nnz), "wt": wt,
           "tolerance": tol}
    kw = dict(wt=wt, ntiles=nt, col_tile=col_tile)
    for name, dt in (("f32", np.float32), ("bf16", ml_dtypes.bfloat16)):
        # inputs rounded to the payload dtype; the reference sees the same
        Xr = X.copy()
        Xr.data = X.data.astype(dt).astype(np.float64)
        Br = Bt.astype(dt)
        Cr = Ct.astype(dt)
        tdr = jnp.asarray(np.asarray(td).astype(dt))
        mv = tiled_ell_spmm_t(tdr, tl, jnp.asarray(Br), **kw)
        rmv = tiled_ell_rmv_t(tdr, tl, jnp.asarray(Cr), **kw)
        e_mv = rel_err(np.asarray(mv)[:, :n].T,
                       Xr @ Br[:, :p].T.astype(np.float64))
        e_rmv = rel_err(np.asarray(rmv)[:p],
                        Xr.T @ Cr[:, :n].T.astype(np.float64))
        out[f"{name}_mv_rel_err"] = e_mv
        out[f"{name}_rmv_rel_err"] = e_rmv
        require(e_mv <= tol and e_rmv <= tol,
                f"tiled products ({name}): mv {e_mv}, rmv {e_rmv} > {tol}")
    out["precision"] = "f32 payload at HIGHEST; bf16 payload, f32 accumulation"
    return out


def int8_gemm_targets(eng) -> dict:
    """What the int8 Gram contraction compiled to: the custom-call targets
    of instructions with s8 operands, and whether a Triton GEMM fusion
    holds an s8 dot."""

    import re

    from single_algebra_tpu.linalg.gram import gram_matrix

    hlo = gram_matrix.lower(eng).compile().as_text()
    targets = sorted({
        m.group(1)
        for line in hlo.splitlines() if "s8[" in line
        for m in re.finditer(r'custom_call_target="([^"]+)"', line)
    })
    triton = any(
        "__triton_gemm" in line and "s8[" in line for line in hlo.splitlines()
    )
    s8_dots = sum(
        1 for line in hlo.splitlines() if " dot(" in line and "s8[" in line
    )
    return {"custom_calls": targets, "triton_gemm_fusion": triton,
            "plain_s8_dots": s8_dots}


def _engine_name(op) -> str:
    from single_algebra_tpu.linalg import (
        DensifiedOperator,
        GramPCAEngine,
        SparseOperator,
        TiledSparseOperator,
    )

    for cls, name in (
        (DensifiedOperator, "dense"), (GramPCAEngine, "gram"),
        (TiledSparseOperator, "tiled"), (SparseOperator, "sparse"),
    ):
        if isinstance(op, cls):
            return name
    return type(op).__name__


def check_northstar(cfg=NORTHSTAR, k=50, tol=1e-5, expect_nnz=NORTHSTAR_NNZ,
                    log=lambda *a: None) -> dict:
    """The main path: randomized PCA with engine='auto' through the
    builder, against the f64 truth."""

    import jax

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.linalg.gram import GramPCAEngine, gram_tier
    from single_algebra_tpu.models import SparsePCABuilder
    from single_algebra_tpu.models.pca import make_engine_operator

    t0 = time.perf_counter()
    X = planted_counts(**cfg)
    if expect_nnz is not None:
        require(X.nnz == expect_nnz, f"nnz {X.nnz} != {expect_nnz}")
    ev_ref = northstar_truth(X, k)
    t_data = time.perf_counter() - t0
    m = SparseMatrix.from_scipy(X, device=False)

    def fit():
        pca = (
            SparsePCABuilder().n_components(k).svd_method(randomized())
            .engine("auto").build()
        )
        t1 = time.perf_counter()
        T = pca.fit_transform(m)
        jax.block_until_ready(T)
        ev = np.asarray(pca.explained_variance_, np.float64)
        return time.perf_counter() - t1, T, ev

    cold, T, ev = fit()
    op = make_engine_operator(m, "auto")  # cached by the fit
    engine = _engine_name(op)
    tier = gram_tier(op) if isinstance(op, GramPCAEngine) else None
    log({"engine": engine, "tier": tier})
    if tier == "int8":
        log({"int8_gemm": int8_gemm_targets(op)})
    warm, T, ev = fit()
    err = ev_rel_err(ev, ev_ref)
    T = np.asarray(T)
    require(T.shape == (cfg["n"], k) and np.isfinite(T).all(),
            "north-star embedding")
    require(err <= tol, f"north-star EV rel err {err} > {tol}")
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "shape": [cfg["n"], cfg["p"]], "nnz": int(X.nnz), "k": k,
        "engine": engine, "tier": tier, "ev_rel_err": err, "tolerance": tol,
        "data_and_truth_s": t_data, "cold_fit_transform_s": cold,
        "warm_fit_transform_s": warm,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def check_engines(cfg=STRESS, k=16, chunk_rows=200_000,
                  engines=("dense", "gram", "tiled", "sparse")) -> dict:
    """Every single-device engine and the streaming driver against host
    f64 eigh, at the bars in the verify skill.

    The exact engines (gram, streaming) are held to 1e-6 on all k
    components. The randomized-sketch engines (dense, tiled, sparse) are
    held to 1e-4 on the components that stand clear of the noise bulk
    (true EV at least 1.5x the k-th true EV): the planted generator's
    small clusters put components 8-16 within a few per cent of each
    other and of the bulk, where a sketch of k + 10 columns at 7 power
    iterations leaves ~1e-3 errors on any engine. Their error over all k
    is printed beside it."""

    import jax

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.models import SparsePCABuilder, StreamingSparsePCA

    bars = {"dense": 1e-4, "gram": 1e-6, "tiled": 1e-4, "sparse": 1e-4,
            "streaming": 1e-6}
    exact = ("gram", "streaming")
    X = planted_counts(**cfg)
    ev_ref = host_truth_ev(X, k)
    clear = int(np.sum(ev_ref >= 1.5 * ev_ref[k - 1]))
    m = SparseMatrix.from_scipy(X, device=False)
    out = {"shape": list(X.shape), "nnz": int(X.nnz), "k": k,
           "components_clear_of_bulk": clear}
    failed = []
    for e in engines:
        pca = (
            SparsePCABuilder().n_components(k).svd_method(randomized())
            .engine(e).build()
        )
        t1 = time.perf_counter()
        T = pca.fit_transform(m)
        jax.block_until_ready(T)
        ev = np.asarray(pca.explained_variance_, np.float64)
        err = ev_rel_err(ev, ev_ref)
        err_clear = ev_rel_err(ev[:clear], ev_ref[:clear])
        judged = err if e in exact else err_clear
        ok = judged <= bars[e] and bool(np.isfinite(np.asarray(T)).all())
        out[e] = {"ev_rel_err": err, "ev_rel_err_clear": err_clear,
                  "bar": bars[e],
                  "judged_on": "all" if e in exact else "clear",
                  "cold_s": time.perf_counter() - t1}
        if not ok:
            failed.append(e)
        m._operator_cache = {}  # release this engine's device payload

    t1 = time.perf_counter()
    spca = StreamingSparsePCA(n_components=k, n_features=X.shape[1])
    for r0 in range(0, X.shape[0], chunk_rows):
        spca.partial_fit(X[r0 : r0 + chunk_rows])
    spca.finalize()
    err = ev_rel_err(spca.explained_variance_, ev_ref)
    Ts = spca.transform(X[:chunk_rows])
    out["streaming"] = {"ev_rel_err": err, "bar": bars["streaming"],
                        "cold_s": time.perf_counter() - t1}
    if err > bars["streaming"] or not np.isfinite(Ts).all():
        failed.append("streaming")
    require(not failed, f"engines over their bars: {failed}: {out}")
    return out


def check_pipeline(cells=50_000, genes=10_000, log=lambda *a: None) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import scrna_pipeline

    return scrna_pipeline.run(cells, genes, log=log)


def check_mesh4(cfg=NORTHSTAR, k=50, ndev=4, chunk_rows=262_144,
                exact_tol=1e-5, sketch_tol=1e-2, expect_nnz=NORTHSTAR_NNZ,
                log=lambda *a: None) -> dict:
    """The sharded schedules over an ndev-device mesh against the truth.

    The exact engines (sharded Gram, streaming) are held to the
    single-device bar; the randomized sketch at q=7 does not resolve the
    planted spectrum's tail to it, so its top-50 error is a sanity bar
    and its top-10 error is printed beside it."""

    import jax

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.models import StreamingSparsePCA
    from single_algebra_tpu.parallel import (
        choose_sharded_engine,
        make_mesh,
        sharded_gram_pca,
        sharded_pca_fit_transform,
    )

    require(len(jax.devices()) >= ndev,
            f"need {ndev} devices, have {len(jax.devices())}")
    mesh = make_mesh(ndev)
    X = planted_counts(**cfg)
    if expect_nnz is not None:
        require(X.nnz == expect_nnz, f"nnz {X.nnz} != {expect_nnz}")
    ev_ref = northstar_truth(X, k)
    m = SparseMatrix.from_scipy(X, device=False)
    out = {"shape": list(X.shape), "nnz": int(X.nnz), "k": k, "ndev": ndev}

    engine = choose_sharded_engine(m, mesh)
    t1 = time.perf_counter()
    res = sharded_pca_fit_transform(
        m, k, mesh, svd_method=randomized(), engine=engine
    )
    ev = np.asarray(res.explained_variance, np.float64)
    T = np.asarray(res.transformed)
    out["sharded_pca"] = {
        "engine": engine, "ev_rel_err": ev_rel_err(ev, ev_ref),
        "ev_rel_err_top10": ev_rel_err(ev[:10], ev_ref[:10]),
        "bar": sketch_tol, "cold_s": time.perf_counter() - t1,
    }
    log({"sharded_pca": out["sharded_pca"]})
    ok = (out["sharded_pca"]["ev_rel_err"] <= sketch_tol
          and T.shape == (cfg["n"], k) and np.isfinite(T).all())
    del res, T
    m._operator_cache = {}

    t1 = time.perf_counter()
    res = sharded_gram_pca(m, mesh, n_components=k)
    ev = np.asarray(res.explained_variance, np.float64)
    T = np.asarray(res.transformed)
    out["sharded_gram"] = {"ev_rel_err": ev_rel_err(ev, ev_ref),
                           "bar": exact_tol,
                           "cold_s": time.perf_counter() - t1}
    log({"sharded_gram": out["sharded_gram"]})
    ok = ok and (out["sharded_gram"]["ev_rel_err"] <= exact_tol
                 and T.shape == (cfg["n"], k) and np.isfinite(T).all())
    del res, T
    m._operator_cache = {}

    t1 = time.perf_counter()
    spca = StreamingSparsePCA(n_components=k, n_features=X.shape[1],
                              mesh=mesh)
    for r0 in range(0, X.shape[0], chunk_rows):
        spca.partial_fit(X[r0 : r0 + chunk_rows])
    spca.finalize()
    Ts = spca.transform(X[:chunk_rows])
    out["streaming_mesh"] = {
        "ev_rel_err": ev_rel_err(spca.explained_variance_, ev_ref),
        "bar": exact_tol, "cold_s": time.perf_counter() - t1,
    }
    ok = ok and (out["streaming_mesh"]["ev_rel_err"] <= exact_tol
                 and np.isfinite(Ts).all())
    require(ok, f"mesh path over its bars: {out}")
    return out


# ---------------------------------------------------------------------------


def run_phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    info = fn(*args, **kwargs)
    emit({"phase": name, "seconds": time.perf_counter() - t0, **info})
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-device sharded path")
    args = ap.parse_args(argv)

    dev = run_phase("device", check_device)
    for line in nvidia_smi():
        emit({"nvidia_smi": line})

    from single_algebra_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    note = lambda obj: emit(obj)  # noqa: E731

    if args.mesh4:
        run_phase("mesh4", check_mesh4, log=note)
    else:
        run_phase("kernels", lambda: {**check_densify(),
                                      **check_tiled_products()})
        run_phase("pca_northstar", check_northstar, log=note)
        run_phase("engines", check_engines)
        run_phase("pipeline", check_pipeline,
                  log=lambda msg: print(msg, file=sys.stderr, flush=True))
    emit({"ok": True, "device": {"platform": dev["platform"],
                                 "kind": dev["device_kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
