"""Diffusion-based expression imputation (the MAGIC role).

van Dijk et al. 2018: smooth expression over the cell-cell graph by
powering a Markov transition operator — ``X_imputed = M^t X``. Here the
graph is the fuzzy kNN connectivities (``neighbors.connectivities``,
the same graph Leiden/UMAP use), self-loops added and rows normalized;
each diffusion step is one sparse SpMM over gene blocks on the device.
No [n, n] dense anything; t steps cost t * O(nnz_graph * block).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

__all__ = ["magic"]


def magic(
    X,
    *,
    embedding: Optional[np.ndarray] = None,
    n_neighbors: int = 15,
    t: int = 3,
    self_weight: float = 1.0,
    block: int = 1024,
    device_out: bool = False,
) -> np.ndarray:
    """Impute/denoise expression by graph diffusion.

    X : SparseMatrix or dense [n, p] (typically log-normalized).
    embedding : [n, d] low-dim coordinates the kNN graph is built from
        (a PCA embedding — the MAGIC workflow). Defaults to the raw
        rows of ``X`` (only sensible for small p).
    t : diffusion steps (MAGIC's default neighborhood scale is ~3).
    self_weight : weight of the added self-loop before row
        normalization (keeps each cell anchored to its own profile).
    device_out : return a device array instead of host numpy — the
        downstream consumer (DE, scoring, plotting subsets) often needs
        only slices, and the full [n, p] host pull dominates wall time
        on slow host links.
    Returns a dense [n, p] float32 array (host numpy unless
    ``device_out``).
    """

    from .neighbors import connectivities
    from .sparse.matrix import SparseMatrix

    if t < 1:
        raise ValueError(f"t={t} must be >= 1")
    is_sparse = isinstance(X, SparseMatrix)
    n, p = X.shape if is_sparse else np.asarray(X).shape

    if embedding is None:
        embedding = X.to_dense() if is_sparse else np.asarray(X)
    embedding = np.asarray(embedding, np.float32)
    if embedding.shape[0] != n:
        raise ValueError(
            f"embedding rows ({embedding.shape[0]}) != matrix rows ({n})"
        )

    import scipy.sparse as sp

    W = connectivities(embedding, n_neighbors=n_neighbors).tolil()
    W.setdiag(self_weight)
    W = W.tocsr()
    rs = np.asarray(W.sum(axis=1)).ravel()
    M = sp.diags(1.0 / np.maximum(rs, 1e-30)) @ W  # row-stochastic
    Md = SparseMatrix.from_scipy(M.astype(np.float32).tocsr())

    from .linalg.operators import DensifiedOperator
    from .ops.spmm import ell_scatter_densify

    # kNN-graph diffusion against a WIDE dense operand is a gather-bound
    # worst case for the ELL SpMM (the [rows, W, k] gather budget forces
    # ~100-row blocks -> hundreds of sequential steps). When the [n, n]
    # bf16 hi/lo densification fits device memory, each diffusion step
    # is 4 dense matmul passes;
    # densified ON DEVICE from the tiny graph payload.
    dense_ok = DensifiedOperator.fits(
        (n, n),
        budget_bytes=int(DensifiedOperator.hbm_budget_bytes() * 1.2),
        needs_lo=True,
    )
    if dense_ok:
        Mop = DensifiedOperator.from_matrix(Md, device=True)
        step = Mop.mv_precise
    else:
        step = Md.matmul_dense

    mc = X._layout_for("col") if is_sparse else None  # gene-major ELL
    blocks = []
    for j0 in range(0, p, block):
        j1 = min(j0 + block, p)
        if is_sparse:
            # densify the gene block on device from the col-major
            # layout (one scatter), cells on lanes, then transpose
            blk = ell_scatter_densify(
                mc.ell_data[j0:j1], mc.ell_ids[j0:j1],
                mc.row_nnz[j0:j1], n,
            ).T
        else:
            blk = jnp.asarray(np.asarray(X)[:, j0:j1], jnp.float32)
        for _ in range(t):
            blk = step(blk)
        blocks.append(blk)
    full = jnp.concatenate(blocks, axis=1) if len(blocks) > 1 else blocks[0]
    return full if device_out else np.asarray(full)
