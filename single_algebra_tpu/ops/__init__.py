"""Compute kernels in XLA: statistics, SpMM, the tiled densify/products."""

from . import stats  # noqa: F401
from .spmm import ell_spmm, ell_spmm_xla  # noqa: F401
