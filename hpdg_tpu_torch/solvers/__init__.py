"""Solvers: Krylov (CG) and the loop solver, block smoothers, assembled
and matrix-free hp-multigrid, patch smoothing, refinement, TNNMG."""

from hpdg_tpu_torch.solvers.cg import loop_solve, pcg  # noqa: F401
from hpdg_tpu_torch.solvers.multigrid import (  # noqa: F401
    matrixfree_multigrid_solver, multigrid_solver, parametric_cycle,
    setup_hierarchy)
from hpdg_tpu_torch.solvers.refine import refinement_solve  # noqa: F401
from hpdg_tpu_torch.solvers import smoothers  # noqa: F401
from hpdg_tpu_torch.solvers.tnnmg import (  # noqa: F401
    solve_obstacle_verified, solve_tnnmg)
