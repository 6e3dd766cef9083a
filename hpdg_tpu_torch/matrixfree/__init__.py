"""Matrix-free SIPG operators: uniform lattices, sum-factorized general
(hp-adaptive) meshes, the deduplicated SpMV and the diagonal blocks."""

from hpdg_tpu_torch.matrixfree.uniform import (  # noqa: F401
    uniform_sipg_operator, uniform_sipg_factorized)
from hpdg_tpu_torch.matrixfree.sumfact import (  # noqa: F401
    sipg_operator, laplace_bulk_operator, mass_operator, naive_sipg_operator)
from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks  # noqa: F401
from hpdg_tpu_torch.matrixfree.dedup import (  # noqa: F401
    dedup_spmv_operator, dedup_spmv_from_plan)
