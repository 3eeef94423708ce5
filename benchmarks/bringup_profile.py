"""Device times of the tiled densify and products on the GPU.

    python benchmarks/bringup_profile.py --out TRACE_DIR

Two measurements, both read from one ``jax.profiler`` trace (device time per
jitted module, summed over the device's kernel events):

(i)  the densify's share of the Gram pass at the north-star width: the
     planted 1M x 30k generator's rows (131,072 of them, so the engine takes
     the same 8,192-row slabs and 30,720 padded columns as at 1M rows),
     ``gram_matrix`` against a graph that only densifies the same slabs;
(ii) the tiled products at the band shape (150,000 x 49,152, density
     0.004, k = 64) over the same payload: ``A @ B`` in two forms,
     (a) densify a row block and contract it on the tensor cores,
     (b) gather the operand's rows by global column id and reduce
     (``ops/tiled.py`` runs (a) on 16-bit payloads and (b) on wider ones),
     and ``A^T @ C`` (a scatter-add). Each in the bf16 payload (what the
     power iterations ride) and the f32 payload at HIGHEST; bytes/s counts
     the payload, operand and output bytes once, against 3.35 TB/s.

Prints one JSON line per measurement and the top device ops of each module.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import defaultdict
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def emit(obj):
    print(json.dumps(obj), flush=True)


# -- trace reduction ---------------------------------------------------------


def device_times(trace_dir, plane_prefix="/device:GPU"):
    """{hlo_module: {hlo_op: total device ns}} over the GPU planes."""

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    out = defaultdict(lambda: defaultdict(float))
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                mod = st.get("hlo_module")
                if mod is None:
                    continue
                out[str(mod)][str(st.get("hlo_op", ev.name))] += ev.duration_ns
    return out


def module_ns(times, prefix):
    return sum(sum(ops.values()) for m, ops in times.items()
               if m.startswith(prefix))


def top_ops(times, prefix, n=8):
    acc = defaultdict(float)
    for m, ops in times.items():
        if m.startswith(prefix):
            for op, ns in ops.items():
                acc[op] += ns
    return sorted(((op, ns / 1e6) for op, ns in acc.items()),
                  key=lambda t: -t[1])[:n]


def named_jit(name, fn, kw):
    """``fn(td, tl, op, **kw)`` under its own jit module name."""

    def call(td, tl, op):
        return fn(td, tl, op, **kw)

    call.__name__ = name
    return jax.jit(call)


def wall(fn, reps=3):
    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# -- the two set-ups -----------------------------------------------------------


def gram_setup(n=131_072, p=30_000):
    from _datagen import cluster_counts_big

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.linalg.gram import (
        GramPCAEngine,
        _slab_for,
        gram_matrix,
        gram_tier,
    )

    X = cluster_counts_big(n, p, n_clusters=64, seed=7,
                           density=0.01).astype(np.float32)
    m = SparseMatrix.from_scipy(X, device=False)
    eng = GramPCAEngine.from_matrix(m)
    tier = gram_tier(eng)
    out_dt = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[tier]
    slab = _slab_for(eng.shape[0])

    @jax.jit
    def densify_only(eng):
        acc = jnp.zeros((), jnp.float32)
        for b, (_, rc) in enumerate(eng.bwidths):
            def body(i, a, b=b):
                D = eng._densify(b, i, out_dt)
                return a + D[0, 0].astype(jnp.float32)

            acc = jax.lax.fori_loop(0, rc // slab, body, acc)
        return acc

    info = {"shape": list(X.shape), "nnz": int(X.nnz), "tier": tier,
            "pp": eng.p_padded, "slab": slab,
            "n_slabs": eng.n_padded // slab,
            "buckets": [list(w) for w in eng.bwidths]}
    return info, (lambda: gram_matrix(eng)), (lambda: densify_only(eng))


def band_setup(n=150_000, p=49_152, density=0.004, k=64, seed=3):
    import scipy.sparse as sp

    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.linalg.operators import TiledSparseOperator
    from single_algebra_tpu.sparse.convert import csr_to_tiled_ell_split_numpy

    rng = np.random.default_rng(seed)
    X = sp.random(n, p, density=density, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random).astype(np.float32)
    m = SparseMatrix.from_scipy(X, device=False)
    ct, br = TiledSparseOperator.COL_TILE, TiledSparseOperator.BLOCK_ROWS
    src = m._layout_for("row")
    td, tl, wt, nt, *_ = csr_to_tiled_ell_split_numpy(
        src._h_indptr, src._h_indices, src._csr_data_host(), n, p,
        col_tile=ct, rows_padded_to=br,
    )
    R = td.shape[1]  # the split layout comes transposed: [nt * wt, R]
    B = rng.standard_normal((k, nt * ct)).astype(np.float32)
    C = rng.standard_normal((k, R)).astype(np.float32)
    td_t = np.asarray(td, np.float32)
    tl_t = jnp.asarray(tl)
    import ml_dtypes

    payloads = {
        "bf16": (jnp.asarray(td_t.astype(ml_dtypes.bfloat16)),
                 jnp.asarray(B.astype(ml_dtypes.bfloat16)),
                 jnp.asarray(C.astype(ml_dtypes.bfloat16))),
        "f32": (jnp.asarray(td_t), jnp.asarray(B), jnp.asarray(C)),
    }
    # reference in f64 on the host, for a sanity check of both forms: the
    # matrix the main payload holds (the rare overflow entries ride side
    # arrays that neither form touches)
    s_idx, r_idx = np.nonzero(td)
    X64 = sp.csr_matrix(
        (td[s_idx, r_idx].astype(np.float64),
         (r_idx, (s_idx // wt) * ct + tl[s_idx, r_idx])),
        shape=(R, nt * ct),
    )[:n, :p]
    ref = {"mv": (X64 @ B[:, :p].T.astype(np.float64)).T,
           "rmv": (X64.T @ C[:, :n].T.astype(np.float64)).T}
    info = {"shape": [n, p], "density": density, "nnz": int(X.nnz), "k": k,
            "col_tile": ct, "wt": wt, "ntiles": nt, "rows_padded": R,
            "slots_per_row": nt * wt}
    return info, payloads, tl_t, (wt, nt, ct), ref


def product_bytes(td, tl, op, out_elems, out_item=4):
    return (td.size * td.dtype.itemsize + tl.size * tl.dtype.itemsize
            + op.size * op.dtype.itemsize + out_elems * out_item)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for the profiler trace")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"needs a GPU, found {jax.devices()[0].platform}")
    from single_algebra_tpu.ops import tiled

    dev = jax.devices()[0]
    emit({"device_kind": dev.device_kind, "count": len(jax.devices())})

    g_info, gram_fn, dens_fn = gram_setup()
    b_info, payloads, tl, (wt, nt, ct), ref = band_setup()
    n, p = b_info["shape"]
    kw = dict(wt=wt, ntiles=nt, col_tile=ct, out_dtype=jnp.float32)

    forms = {"a_mv": tiled._spmm_densify, "b_mv": tiled._spmm_gather,
             "rmv": tiled.tiled_ell_rmv_t}
    calls = {}
    for dt, (td, Bt, Ct) in payloads.items():
        for form, fn in forms.items():
            name = f"{form}_{dt}"
            op = Bt if form.endswith("_mv") else Ct
            calls[name] = partial(named_jit(name, fn, kw), td, tl, op)

    # compile, warm and check every call; host-clock medians with the
    # profiler off
    walls = {"gram": wall(gram_fn), "densify_only": wall(dens_fn)}
    errs = {}
    for name, fn in calls.items():
        walls[name] = wall(fn)
        out = np.asarray(fn(), np.float64)
        kind = "mv" if "_mv_" in name else "rmv"
        got = out[:, :n] if kind == "mv" else out[:p].T
        r = ref[kind]
        errs[name] = float(np.abs(got - r).max() / np.abs(r).max())

    # one trace over one call of each, each under its own jit module name
    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        jax.block_until_ready(gram_fn())
        jax.block_until_ready(dens_fn())
        for fn in calls.values():
            jax.block_until_ready(fn())
    times = device_times(args.out)
    emit({"modules": sorted((m, round(sum(o.values()) / 1e6, 3))
                            for m, o in times.items())})

    g_ns = module_ns(times, "jit_gram_matrix")
    d_ns = module_ns(times, "jit_densify_only")
    emit({"measure": "gram_densify_share", **g_info,
          "gram_device_ms": g_ns / 1e6, "densify_device_ms": d_ns / 1e6,
          "densify_share": d_ns / g_ns if g_ns else None,
          "gram_wall_s": walls["gram"], "densify_wall_s": walls["densify_only"],
          "gram_top_ops_ms": top_ops(times, "jit_gram_matrix"),
          "densify_top_ops_ms": top_ops(times, "jit_densify_only")})

    for name in calls:
        form, dt = name.rsplit("_", 1)
        td, Bt, Ct = payloads[dt]
        kp = Bt.shape[0]
        is_mv = form.endswith("_mv")
        out_elems = kp * td.shape[1] if is_mv else nt * ct * kp
        nbytes = product_bytes(td, tl, Bt if is_mv else Ct, out_elems)
        dev_s = module_ns(times, f"jit_{name}") / 1e9
        emit({"measure": "tiled_product", "call": name, **b_info,
              "payload": dt, "device_ms": dev_s * 1e3,
              "wall_ms": walls[name] * 1e3, "bytes": nbytes,
              "bytes_per_s_device": nbytes / dev_s if dev_s else None,
              "hbm_share_device": (nbytes / dev_s / HBM_BYTES_PER_S
                                   if dev_s else None),
              "rel_err_vs_f64": errs[name],
              "top_ops_ms": top_ops(times, f"jit_{name}", 5)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
