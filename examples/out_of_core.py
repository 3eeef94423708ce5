"""Out-of-core scRNA pipeline: dataset larger than device memory.

Composes the streaming surfaces end-to-end WITHOUT ever holding the
full matrix — the workflow for h5ad files larger than RAM or device memory:

  write a chunked h5ad -> iter_h5ad_chunks row slabs ->
  StreamingSparsePCA.partial_fit (Gram accumulation on device) ->
  HVG straight from the streamed column moments (no second data pass) ->
  finalize + streamed transform -> minibatch KMeans partial_fit

Run: python examples/out_of_core.py [--cells 200000 --genes 5000]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from single_algebra_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

from single_algebra_tpu import SparseMatrix  # noqa: E402
from single_algebra_tpu.feature_selection import (  # noqa: E402
    highly_variable_genes_from_moments,
)
from single_algebra_tpu.io import iter_h5ad_chunks, write_h5ad  # noqa: E402
from single_algebra_tpu.models import KMeans, StreamingSparsePCA  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=100_000)
    ap.add_argument("--genes", type=int, default=4_000)
    ap.add_argument("--chunk", type=int, default=20_000)
    ap.add_argument("--components", type=int, default=30)
    args = ap.parse_args()

    t00 = time.perf_counter()

    def stamp(msg):
        print(f"[{time.perf_counter() - t00:7.2f}s] {msg}", flush=True)

    # --- stage a chunked h5ad on disk (stand-in for a real atlas) ------
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    n_types = 10
    programs = rng.gamma(2.0, 1.0, (n_types, args.genes)) * (
        rng.random((n_types, args.genes)) < 0.3
    )
    path = os.path.join(tempfile.mkdtemp(), "atlas.h5ad")
    blocks, labels = [], []
    for c0 in range(0, args.cells, args.chunk):
        rows = min(args.chunk, args.cells - c0)
        lab = rng.integers(0, n_types, rows)
        X = sp.csr_matrix(
            rng.poisson(programs[lab] * 0.05).astype(np.float32)
        )
        blocks.append(X)
        labels.append(lab)
    labels = np.concatenate(labels)
    full = sp.vstack(blocks).tocsr()
    write_h5ad(path, full)
    stamp(
        f"staged {full.shape} h5ad ({full.nnz} nnz, "
        f"{os.path.getsize(path)/1e6:.0f} MB) at {path}"
    )
    del blocks

    # --- pass 1: stream slabs into the Gram accumulator -----------------
    pca = StreamingSparsePCA(args.components, n_features=args.genes)
    n_seen = 0
    for chunk in iter_h5ad_chunks(path, chunk_rows=args.chunk):
        pca.partial_fit(SparseMatrix.from_scipy(chunk))
        n_seen += chunk.shape[0]
    stamp(f"streamed {n_seen} cells through partial_fit")

    # --- HVG from the already-streamed moments (no extra pass) ----------
    mean = pca.col_sums() / n_seen
    hvg = highly_variable_genes_from_moments(
        mean, pca.col_var(), n_top_genes=1_000
    )
    stamp(f"HVG from streaming moments: kept {hvg.n_selected}")

    pca.finalize()
    ev = np.asarray(pca.explained_variance_)
    stamp(f"finalized PCA: top-5 EV {np.round(ev[:5], 4)}")

    # --- pass 2: streamed transform + minibatch KMeans -------------------
    km = KMeans(n_clusters=n_types, random_seed=0)
    embeddings = []
    for chunk in iter_h5ad_chunks(path, chunk_rows=args.chunk):
        E = np.asarray(pca.transform(SparseMatrix.from_scipy(chunk)))
        km.partial_fit(E.astype(np.float32))
        embeddings.append(E)
    E = np.concatenate(embeddings)
    pred = np.asarray(km.predict(E.astype(np.float32)))
    from single_algebra_tpu.metrics import adjusted_rand_index

    stamp(
        f"minibatch KMeans over streamed embeddings: ARI vs planted "
        f"types {adjusted_rand_index(labels, pred):.3f}"
    )
    os.remove(path)
    stamp("pipeline complete")


if __name__ == "__main__":
    main()
