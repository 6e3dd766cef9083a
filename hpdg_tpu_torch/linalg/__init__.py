"""Degree-bucketed block linear algebra."""

from hpdg_tpu_torch.linalg import blockvector as bv  # noqa: F401
from hpdg_tpu_torch.linalg.blockmatrix import BlockSparseMatrix  # noqa: F401
