"""End-to-end scRNA-seq analysis pipeline.

The workflow the reference library serves inside SingleRust (crate docs,
reference src/lib.rs:28-33), composed from this framework's pieces:

  counts -> QC metrics -> normalize(1e4) -> log1p -> HVG selection ->
  PCA(50) -> neighbor graph -> Leiden + KMeans clustering ->
  t-SNE/UMAP -> rank_genes_groups (marker genes)

Run: python examples/scrna_pipeline.py [--cells 50000 --genes 10000]

``run(...)`` is the same chain as a function: every stage's output must be
finite, and it returns the stage summaries.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from single_algebra_tpu.utils.cache import enable_compile_cache  # noqa: E402
from single_algebra_tpu import Direction, SparseMatrix  # noqa: E402
from single_algebra_tpu.models import SparsePCABuilder, tsne  # noqa: E402
from single_algebra_tpu.models import MaskedSparsePCABuilder  # noqa: E402
from single_algebra_tpu.similarity import CosineSimilarity  # noqa: E402
from single_algebra_tpu.types import (  # noqa: E402
    PowerIterationNormalizer,
    SVDMethod,
)


def synthetic_counts(n_cells, n_genes, n_types=12, seed=0):
    """Cluster-structured Poisson counts (UMI-like)."""

    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    programs = rng.gamma(2.0, 1.0, (n_types, n_genes)) * (
        rng.random((n_types, n_genes)) < 0.4
    )
    rates = programs * np.geomspace(6, 1, n_types)[:, None] * 0.08
    labels = rng.integers(0, n_types, n_cells)
    X = sp.csr_matrix(
        rng.poisson(rates[labels]).astype(np.float32)
    )
    return X, labels


def _finite(name, x):
    a = np.asarray(x)
    if not np.isfinite(a).all():
        raise AssertionError(f"{name}: non-finite output")
    return a


def run(cells=20_000, genes=8_000, hvg=2_000, sim_cells=5_000, log=print):
    """The whole chain on seeded synthetic counts; returns a dict of stage
    summaries and raises if any stage's output is not finite."""

    t00 = time.perf_counter()
    out = {}

    def stamp(msg):
        log(f"[{time.perf_counter() - t00:7.2f}s] {msg}")

    X, labels = synthetic_counts(cells, genes)
    stamp(f"counts: {X.shape}, {X.nnz} UMIs, density {X.nnz/np.prod(X.shape):.3f}")

    m = SparseMatrix.from_scipy(X)

    # --- QC metrics (qc module over MatrixNonZero / MatrixSum traits) ---
    from single_algebra_tpu import calculate_qc_metrics

    mito_mask = np.zeros(genes, bool)
    mito_mask[:: genes // 13] = True  # stand-in mito gene set
    qc_obs, qc_var = calculate_qc_metrics(m, qc_vars={"mito": mito_mask})
    umis_per_cell = _finite("qc total_counts", qc_obs["total_counts"])
    _finite("qc pct_counts_mito", qc_obs["pct_counts_mito"])
    stamp(
        f"QC: median genes/cell={np.median(qc_obs['n_genes_by_counts']):.0f}, "
        f"median UMIs/cell={np.median(umis_per_cell):.0f}, "
        f"median pct mito={np.median(qc_obs['pct_counts_mito']):.1f}%, "
        f"detected genes={(qc_var['n_cells_by_counts'] > 0).sum()}"
    )

    # --- normalize to 1e4 UMIs/cell + log1p (reference Normalize/Log1P) --
    norm = m.normalize(umis_per_cell, 1e4, Direction.ROW).log1p_normalize()
    _finite("normalize + log1p row sums", norm.sum_row())
    stamp("normalized + log1p")

    # --- HVG selection (Seurat-flavor dispersion ranking) ----------------
    from single_algebra_tpu import highly_variable_genes

    hvg = highly_variable_genes(norm, n_top_genes=hvg)
    hvg_mask = hvg.mask
    out["hvg_selected"] = int(hvg.n_selected)
    stamp(
        f"selected {hvg.n_selected} highly variable genes "
        f"(median norm dispersion of kept: "
        f"{np.median(hvg.dispersions_norm[hvg_mask]):.2f})"
    )

    # --- PCA on the HVG subset (MaskedSparsePCA, randomized SVD) --------
    pca = (
        MaskedSparsePCABuilder()
        .mask(hvg_mask)
        .n_components(50)
        .svd_method(SVDMethod.random(10, 7, PowerIterationNormalizer.QR))
        .build()
    )
    E = _finite("PCA embedding", pca.fit_transform(norm)).astype(np.float32)
    cum = _finite("PCA EV ratio", pca.cumulative_explained_variance_ratio())
    out["pca_top10_ratio"] = float(cum[9])
    stamp(
        f"PCA: embedding {E.shape}; top-10 comps carry "
        f"{cum[9]*100:.1f}% of captured variance"
    )

    # --- neighbor similarities over the embedding (similarity module) ---
    S = _finite("cosine similarity", CosineSimilarity().pairwise(E[:sim_cells]))
    stamp(f"cosine similarity {S.shape}, mean={S.mean():.3f}")

    # --- Leiden over the fuzzy kNN graph (cluster + neighbors modules) --
    from single_algebra_tpu import leiden, neighbors

    conn = neighbors.connectivities(E, n_neighbors=15)
    _finite("kNN connectivities", conn.data)
    lr = leiden(conn, resolution=0.5, seed=0)
    from single_algebra_tpu.metrics import adjusted_rand_index

    out["leiden_communities"] = int(lr.n_communities)
    out["leiden_ari"] = float(adjusted_rand_index(labels, lr.labels))
    stamp(
        f"Leiden: {lr.n_communities} communities (quality {lr.quality:.3f}, "
        f"{lr.backend}), ARI vs planted types "
        f"{adjusted_rand_index(labels, lr.labels):.3f}"
    )

    # --- KMeans clustering on the embedding (models.kmeans) -------------
    from single_algebra_tpu.models import KMeans

    km = KMeans(n_clusters=12, n_init=3, random_seed=0).fit(E)
    pred = np.asarray(km.labels_)
    _finite("KMeans centers", km.cluster_centers_)
    # purity against the planted cell types
    purity = sum(
        np.bincount(labels[pred == c]).max()
        for c in range(12)
        if (pred == c).any()
    ) / len(labels)
    from single_algebra_tpu.metrics import silhouette_score

    stamp(
        f"KMeans: 12 clusters, purity vs planted types {purity:.3f}, "
        f"ARI {adjusted_rand_index(labels, pred):.3f}, silhouette "
        f"{silhouette_score(E[:5000], pred[:5000]):.3f}, "
        f"inertia {km.inertia_:.4g} in {km.n_iter_} iters"
    )

    # --- t-SNE for visualization (ALL cells: mode='auto' picks the
    # exact n x n path below ~16k and the knn mode — sparse attraction +
    # blocked exact repulsion — above it) --------------------------------
    sub = E
    Y = _finite(
        "t-SNE", tsne.run(sub, tsne.TSNEConfig(perplexity=30.0, epochs=500))
    )
    sub_labels = labels
    # cluster separation in the embedding
    intra, inter = [], []
    for i in range(0, len(Y), 23):
        for j in range(i + 1, len(Y), 41):
            d = float(np.linalg.norm(Y[i] - Y[j]))
            (intra if sub_labels[i] == sub_labels[j] else inter).append(d)
    out["tsne_separation"] = float(np.median(intra) / np.median(inter))
    stamp(
        f"t-SNE: {Y.shape}; cluster separation "
        f"(median intra/inter) = {out['tsne_separation']:.3f}"
    )

    # --- UMAP over the same embedding ------------------------------------
    from single_algebra_tpu.models import UMAP, UMAPConfig

    U = _finite(
        "UMAP", UMAP(UMAPConfig(n_neighbors=15, n_epochs=200)).fit_transform(sub)
    )
    intra_u, inter_u = [], []
    for i in range(0, len(U), 23):
        for j in range(i + 1, len(U), 41):
            d = float(np.linalg.norm(U[i] - U[j]))
            (intra_u if sub_labels[i] == sub_labels[j] else inter_u).append(d)
    out["umap_separation"] = float(np.median(intra_u) / np.median(inter_u))
    stamp(
        f"UMAP: {U.shape}; cluster separation "
        f"(median intra/inter) = {out['umap_separation']:.3f}"
    )

    # --- marker genes per Leiden community (de module) -------------------
    from single_algebra_tpu import rank_genes_groups

    de = rank_genes_groups(
        norm, [f"c{l}" for l in lr.labels], method="wilcoxon", n_genes=5
    )
    biggest = f"c{np.bincount(lr.labels).argmax()}"
    top = de.group(biggest)
    _finite("DE scores", top["scores"])
    _finite("DE adjusted p-values", top["pvals_adj"])
    stamp(
        f"markers of {biggest}: genes {list(top['names'])}, "
        f"min padj {top['pvals_adj'].min():.2e}, "
        f"max lfc {top['logfoldchanges'].max():.2f}"
    )
    stamp("pipeline complete")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=20_000)
    ap.add_argument("--genes", type=int, default=8_000)
    ap.add_argument("--hvg", type=int, default=2_000)
    ap.add_argument(
        "--sim-cells", type=int, default=5_000,
        help="cells in the dense pairwise-similarity block",
    )
    args = ap.parse_args()
    enable_compile_cache()
    run(args.cells, args.genes, args.hvg, args.sim_cells,
        log=lambda msg: print(msg, flush=True))


if __name__ == "__main__":
    main()
