"""single_algebra_tpu: sparse linear algebra & dimensionality reduction in JAX.

A ground-up JAX/XLA rebuild of the capability surface of
SingleRust/single-algebra v0.9.2 (sparse CSR/CSC statistics, Normalize/Log1P
preprocessing, SparsePCA / MaskedSparsePCA over Lanczos or randomized SVD,
similarity measures, t-SNE), run on an NVIDIA GPU: padded-ELL layouts
feeding SpMM and densify-then-contract products, jitted SVD loops, and
shard_map row-sharding over device meshes.
"""

from .types import (  # noqa: F401
    Direction,
    PowerIterationNormalizer,
    SVDMethod,
)
from .sparse import SparseMatrix, csr_matrix, csc_matrix, random_sparse  # noqa: F401
from .feature_selection import (  # noqa: F401
    HVGResult,
    highly_variable_genes,
    highly_variable_genes_from_moments,
)
from . import metrics  # noqa: F401
from . import io  # noqa: F401
from .qc import calculate_qc_metrics  # noqa: F401
from .de import rank_genes_groups  # noqa: F401
from .cluster import leiden  # noqa: F401
from .preprocess import (  # noqa: F401
    scale,
    regress_out,
    combat,
    normalize_pearson_residuals,
)
from .scoring import score_genes, score_genes_cell_cycle  # noqa: F401
from .ingest import ingest, transfer_values  # noqa: F401
from .doublets import scrublet  # noqa: F401
from .recipes import (  # noqa: F401
    recipe_zheng17,
    recipe_seurat,
    recipe_pearson_residuals,
)
from .imputation import magic  # noqa: F401

__version__ = "0.1.0"
