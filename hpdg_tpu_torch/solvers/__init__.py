"""Solvers: Krylov (CG), block Jacobi, matrix-free hp-multigrid, patch
smoothing, refinement."""

from hpdg_tpu_torch.solvers.cg import pcg  # noqa: F401
from hpdg_tpu_torch.solvers.multigrid import (  # noqa: F401
    matrixfree_multigrid_solver)
from hpdg_tpu_torch.solvers.refine import refinement_solve  # noqa: F401
from hpdg_tpu_torch.solvers import smoothers  # noqa: F401
