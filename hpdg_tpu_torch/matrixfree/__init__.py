"""Matrix-free operators: the SIPG Laplacian on uniform lattices and
sum-factorized general (hp-adaptive) meshes, the deduplicated SpMV, the
diagonal blocks, block-Jacobi loops, the elasticity apply and the
DG-norm error indicators."""

from hpdg_tpu_torch.matrixfree.uniform import (  # noqa: F401
    uniform_sipg_operator, uniform_sipg_factorized)
from hpdg_tpu_torch.matrixfree.sumfact import (  # noqa: F401
    sipg_operator, laplace_bulk_operator, mass_operator, naive_sipg_operator)
from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks  # noqa: F401
from hpdg_tpu_torch.matrixfree.dedup import (  # noqa: F401
    dedup_spmv_operator, dedup_spmv_from_plan)
from hpdg_tpu_torch.matrixfree.elasticity import (  # noqa: F401
    elasticity_operator, elasticity_diagonal_blocks)
from hpdg_tpu_torch.matrixfree.jacobi import (  # noqa: F401
    heat_diagonal_blocks, mass_diagonal_blocks,
    matrix_free_block_projected_jacobi)
from hpdg_tpu_torch.matrixfree.norms import (  # noqa: F401
    ipdg_local_norm, jump_indicator)
