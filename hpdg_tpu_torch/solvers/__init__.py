"""Solvers: matrix-free hp-multigrid, patch smoothing, refinement."""

from hpdg_tpu_torch.solvers.multigrid import (  # noqa: F401
    matrixfree_multigrid_solver)
from hpdg_tpu_torch.solvers.refine import refinement_solve  # noqa: F401
