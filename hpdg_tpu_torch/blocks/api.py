"""High-level building blocks: assemble, solve.

Port of ``hpdg_tpu.blocks.api`` (the reference's BuildingBlocks
namespace, the API a user programs against).
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble import mass as _mass
from hpdg_tpu_torch.assemble import rhs as _rhs
from hpdg_tpu_torch.assemble import sipg as _sipg
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.matrixfree.norms import ipdg_local_norm
from hpdg_tpu_torch.solvers.cg import loop_solve, pcg
from hpdg_tpu_torch.solvers.multigrid import multigrid_solver
from hpdg_tpu_torch.solvers.tnnmg import solve_tnnmg


def laplace(basis: DGBasis, penalty: float = 2.0, dirichlet: bool = False,
            diffusion=None, plan=None, dtype=torch.float64, device=None,
            penalty_scaling: str = "measure"):
    """SIPG stiffness matrix (BuildingBlocks::laplace)."""
    return _sipg.assemble_laplace(basis, penalty=penalty, dirichlet=dirichlet,
                                  diffusion=diffusion, plan=plan, dtype=dtype,
                                  penalty_scaling=penalty_scaling,
                                  device=device)


def mass(basis: DGBasis, weight=None, quad_order=None, plan=None,
         dtype=torch.float64, device=None):
    """(Weighted) mass matrix (BuildingBlocks::mass)."""
    return _mass.assemble_mass(basis, weight=weight, quad_order=quad_order,
                               plan=plan, dtype=dtype, device=device)


def l2_functional(basis: DGBasis, f, quad_order=None, dtype=torch.float64,
                  device=None):
    """Load vector ∫ f v (BuildingBlocks::l2Functional)."""
    return _rhs.l2_functional(basis, f, quad_order=quad_order, dtype=dtype,
                              device=device)


def dirichlet_data(basis: DGBasis, g, penalty: float = 2.0, plan=None,
                   dtype=torch.float64, device=None,
                   penalty_scaling: str = "measure"):
    """SIPG-consistent Dirichlet rhs terms (BuildingBlocks::
    dirichletData); ``penalty`` and ``penalty_scaling`` are those of the
    matrix it accompanies."""
    return _rhs.dirichlet_rhs(basis, g, penalty=penalty, plan=plan,
                              dtype=dtype, penalty_scaling=penalty_scaling,
                              device=device)


def solve_linear(basis: DGBasis, A, b, x0=None, tol: float = 1e-8,
                 maxiter: int = 100, meshes=None, method: str = "multigrid",
                 operator_factory=None, **mg_kwargs):
    """hp-multigrid linear solve (BuildingBlocks::solveLinear) on the
    device of ``A``.

    ``method``: "multigrid" (the V-cycle iterated to the energy-norm
    correction ``tol``), "cg+mg" (the V-cycle as PCG preconditioner),
    "mf" (the matrix-free solver, sum-factorized levels in ``b``'s dtype
    unless ``use_kernel=True`` asks for the stencil kernel; its cycle
    iterated against ``A``), or "onchip": f32 V-cycle chains of an f32
    copy of ``A`` inside the f64 refinement (``solvers.refine``, fused as
    the reference's: on a card each step replays two captured CUDA
    graphs), the f64 residual on the device, the answer verified by a
    host numpy f64 SpMV.  Returns ``(x, info)``."""
    x0 = bv.zeros_like(b) if x0 is None else x0
    matvec = lambda v: bm.matvec(A, v)  # noqa: E731
    if method == "onchip":
        from hpdg_tpu_torch.solvers.refine import refinement_solve
        from hpdg_tpu_torch.solvers.tnnmg import _np_matvec
        A32 = bm.BlockSparseMatrix(
            A.pattern, A.dim, {k: v.float() for k, v in A.values.items()},
            A.block_shape)
        step32, _ = multigrid_solver(basis, A32, meshes=meshes,
                                     operator_factory=operator_factory,
                                     dtype=torch.float32, **mg_kwargs)
        b_host = {k: v.detach().cpu().double().numpy() for k, v in b.items()}

        def host_residual(x64):
            Ax = _np_matvec(A, {k: v.numpy() for k, v in x64.items()})
            return {k: torch.from_numpy(b_host[k] - Ax[k]) for k in b_host}

        chain_k = 8
        return refinement_solve(
            step32, lambda x: bv.sub(b, matvec(x)), b, chain_k=chain_k,
            tol=tol, max_steps=max(1, -(-maxiter // chain_k)),
            host_residual=host_residual, fused=True)
    if method == "mf":
        from hpdg_tpu_torch.solvers.multigrid import \
            matrixfree_multigrid_solver
        first = next(iter(b.values()))
        mg_kwargs.setdefault("dtype", first.dtype)
        mg_kwargs.setdefault("device", first.device)
        step, _ = matrixfree_multigrid_solver(basis, meshes=meshes,
                                              **mg_kwargs)
        return loop_solve(step, x0, b, matvec_fn=matvec, tol=tol,
                          maxiter=maxiter)
    step, _ = multigrid_solver(basis, A, meshes=meshes,
                               operator_factory=operator_factory,
                               **mg_kwargs)
    if method == "multigrid":
        return loop_solve(step, x0, b, matvec_fn=matvec, tol=tol,
                          maxiter=maxiter)
    if method == "cg+mg":
        precond = lambda r: step(bv.zeros_like(r), r)  # noqa: E731
        return pcg(matvec, b, x0=x0, precond=precond, tol=tol,
                   maxiter=maxiter)
    raise ValueError(method)


def solve_obstacle(basis: DGBasis, A, b, lo, up, x0=None, tol: float = 1e-9,
                   maxiter: int = 100, meshes=None, **kwargs):
    """Obstacle problem by TNNMG (BuildingBlocks::solveObstacle) on the
    device of ``A``; ``lo``/``up`` are bucketed bound vectors."""
    step, _ = multigrid_solver(basis, A, meshes=meshes,
                               dtype=next(iter(b.values())).dtype)
    return solve_tnnmg(A, b, basis, lo, up, mg_step=step, x0=x0, tol=tol,
                       maxiter=maxiter, **kwargs)


def local_norm(basis: DGBasis, x, penalty: float = 2.0,
               dirichlet: bool = False, plan=None, device=None):
    """Per-element squared DG-norm indicator eta_e^2
    (BuildingBlocks::ipdgLocalNorm) as a tensor on ``device``."""
    return ipdg_local_norm(basis, penalty=penalty, dirichlet=dirichlet,
                           plan=plan, device=device)(x)


def global_error(basis: DGBasis, x, penalty: float = 2.0,
                 dirichlet: bool = False, device=None) -> float:
    """Global DG-norm of x (BuildingBlocks' global error)."""
    return float(torch.sqrt(torch.sum(local_norm(
        basis, x, penalty=penalty, dirichlet=dirichlet, device=device))))


def constant_bounds(basis: DGBasis, lower=-np.inf, upper=np.inf,
                    dtype=torch.float64, device=None):
    """Bucketed box-constraint vectors ``(lo, up)`` of constant value."""
    device = dev.resolve(device)
    lo = {p: torch.full((basis.bucket_size(p), basis.n_local(p)), lower,
                        dtype=dtype, device=device)
          for p in basis.bucket_degrees}
    up = {p: torch.full((basis.bucket_size(p), basis.n_local(p)), upper,
                        dtype=dtype, device=device)
          for p in basis.bucket_degrees}
    return lo, up


def interpolate(basis: DGBasis, f, dtype=torch.float64, device=None) -> dict:
    """Nodal interpolation of ``f`` (a callable on a tensor of physical
    points ``(..., dim)``) into the basis, on ``device``."""
    device = dev.resolve(device)
    return {p: f(torch.as_tensor(basis.node_positions(p), dtype=dtype,
                                 device=device)).to(dtype)
            for p in basis.bucket_degrees}
