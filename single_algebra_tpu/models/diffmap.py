"""Diffusion maps + diffusion pseudotime on the operator seam.

scanpy's ``tl.diffmap`` / ``tl.dpt`` surface (Coifman et al. 2005;
Haghverdi et al. 2016): eigenvectors of the density-normalized
transition operator built from the fuzzy kNN connectivities.

Device formulation: the anisotropic (alpha=1) kernel ``K = W / (q q^T)``
is an O(nnz) host rescale of the graph's stored values; the symmetric
transition operator ``T = Z^{-1/2} K Z^{-1/2}`` never materializes —
its top eigenpairs come from :func:`block_lanczos_svd` on the PSD shift
``I + T`` (the SpectralClustering operator, ``spectral.py``), one
device SpMM + two diagonal scalings per Krylov pass. Only [n, k]
eigenvectors reach the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..sparse.matrix import SparseMatrix
from .spectral import _ShiftedNormalizedAffinity

__all__ = ["diffmap", "DiffMapResult", "diffusion_pseudotime"]


@dataclasses.dataclass
class DiffMapResult:
    """``embedding[:, 0]`` is the trivial steady-state component
    (eigenvalue ~1), matching scanpy's X_diffmap layout."""

    embedding: np.ndarray  # [n, n_comps] eigenvectors of T, descending
    eigenvalues: np.ndarray  # [n_comps]

    def __repr__(self):
        ev = ", ".join(f"{v:.4f}" for v in self.eigenvalues[:4])
        return (
            f"DiffMapResult(n={self.embedding.shape[0]}, "
            f"n_comps={self.embedding.shape[1]}, evals=[{ev}, ...])"
        )


def _graph_from(data, n_neighbors: int):
    import scipy.sparse as sp

    if sp.issparse(data):
        return data.tocsr()
    if isinstance(data, SparseMatrix):
        return data.to_scipy().tocsr()
    from ..models.umap import fuzzy_connectivities

    X = np.asarray(data, np.float32)
    if X.ndim != 2:
        raise ValueError(f"Expected [n, d] embedding, got {X.shape}")
    k = min(n_neighbors, X.shape[0] - 1)
    if k < 1:
        raise ValueError("need at least 2 samples")
    return fuzzy_connectivities(X, k).tocsr()


def diffmap(
    data,
    n_comps: int = 15,
    *,
    n_neighbors: int = 15,
    seed: int = 0,
    lanczos_steps: Optional[int] = None,
) -> DiffMapResult:
    """Diffusion map of an embedding or a precomputed symmetric graph.

    ``data``: dense [n, d] rows (a kNN connectivities graph is built, the
    scanpy chain) or a symmetric scipy sparse / SparseMatrix adjacency.
    Returns eigenvectors/eigenvalues of the density-normalized transition
    operator, eigenvalues descending (the first is ~1, its vector the
    steady state — kept, as scanpy does).
    """

    W = _graph_from(data, n_neighbors)
    n = W.shape[0]
    if W.shape[0] != W.shape[1]:
        raise ValueError(f"graph must be square, got {W.shape}")
    if not (2 <= n_comps <= n):
        raise ValueError(f"n_comps={n_comps} must be in [2, {n}]")

    # anisotropic density normalization (alpha = 1): K = W / (q q^T)
    q = np.asarray(W.sum(axis=1)).ravel().astype(np.float64)
    q = np.maximum(q, 1e-30)
    coo = W.tocoo()
    kdata = coo.data / (q[coo.row] * q[coo.col])
    import scipy.sparse as sp

    K = sp.csr_matrix((kdata.astype(np.float32), (coo.row, coo.col)),
                      shape=W.shape)
    z = np.asarray(K.sum(axis=1)).ravel().astype(np.float64)
    s = jnp.asarray(
        np.where(z > 0, 1.0 / np.sqrt(np.maximum(z, 1e-30)), 0.0),
        jnp.float32,
    )

    from ..linalg import block_lanczos_svd

    op = _ShiftedNormalizedAffinity(SparseMatrix.from_scipy(K), s)
    b = min(n_comps + 2, n)
    kdim = lanczos_steps or max(96, 8 * n_comps)
    res = block_lanczos_svd(
        op, n_comps, block_size=b,
        steps=max(2, -(-kdim // b)), seed=seed,
    )
    evecs = np.asarray(res.u, np.float64)  # [n, k]
    evals = np.asarray(res.s, np.float64) - 1.0  # undo the I + T shift

    # deterministic sign: largest-|component| entry positive
    flip = np.sign(evecs[np.abs(evecs).argmax(axis=0), np.arange(n_comps)])
    flip = np.where(flip == 0, 1.0, flip)
    return DiffMapResult(embedding=evecs * flip, eigenvalues=evals)


def diffusion_pseudotime(
    result: DiffMapResult, root: int, *, n_dcs: Optional[int] = None
) -> np.ndarray:
    """Diffusion pseudotime relative to a root cell (scanpy ``tl.dpt``
    distance): Euclidean distance to the root in the eigenvector basis
    scaled by ``lambda / (1 - lambda)``, skipping the steady-state
    component. Returns [n] float64, normalized to max 1."""

    emb, ev = result.embedding, result.eigenvalues
    n, k = emb.shape
    if not (0 <= root < n):
        raise ValueError(f"root={root} out of range [0, {n})")
    stop = k if n_dcs is None else min(n_dcs, k)
    lam = np.clip(ev[1:stop], -0.999999, 0.999999)
    scale = lam / (1.0 - lam)
    diff = (emb[:, 1:stop] - emb[root, 1:stop]) * scale[None, :]
    d = np.sqrt((diff * diff).sum(axis=1))
    top = d.max()
    return d / top if top > 0 else d
