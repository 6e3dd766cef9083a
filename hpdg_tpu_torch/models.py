"""Problem presets: the framework's "model zoo".

Port of ``hpdg_tpu.models``.  The model families are PDE problem classes
(SIPG Poisson with coefficient diffusion, heat flow, elasticity, the
obstacle problem); each dataclass bundles the assemble/solve pipeline of
its family behind one call, on ``device`` (``None``: the current CUDA
card):

1. ``PoissonProblem``    (weighted) SIPG Poisson, MG / PCG solvers
2. ``HeatProblem``       implicit Euler heat flow (M + dt A)
3. ``ElasticityProblem`` linear elasticity hp-DG
4. ``ObstacleProblem``   box-constrained membrane via TNNMG
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble.plan import build_plan
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.linalg import blockmatrix as bm, blockvector as bv


@dataclass
class PoissonProblem:
    """-div(K grad u) = f with SIPG; BASELINE configs 1-3."""

    basis: DGBasis
    penalty: float = 2.0
    dirichlet: bool = True
    diffusion: object = None
    dtype: object = torch.float64
    device: object = None

    def __post_init__(self):
        self.device = dev.resolve(self.device)
        self.plan = build_plan(self.basis)
        self.A = api.laplace(self.basis, penalty=self.penalty,
                             dirichlet=self.dirichlet,
                             diffusion=self.diffusion, plan=self.plan,
                             dtype=self.dtype, device=self.device)

    def rhs(self, f, g=None):
        b = api.l2_functional(self.basis, f, dtype=self.dtype,
                              device=self.device)
        if g is not None:
            b = bv.add(b, api.dirichlet_data(self.basis, g,
                                             penalty=self.penalty,
                                             plan=self.plan,
                                             dtype=self.dtype,
                                             device=self.device))
        return b

    def solve(self, b, method: str = "multigrid", tol: float = 1e-8,
              maxiter: int = 100, **kw):
        if method != "onchip":
            kw.setdefault("dtype", self.dtype)
        return api.solve_linear(self.basis, self.A, b, tol=tol,
                                maxiter=maxiter, method=method, **kw)

    def operator(self):
        """Matrix-free sum-factorized apply (config 2 production path)."""
        from hpdg_tpu_torch.matrixfree import sipg_operator
        return sipg_operator(self.basis, penalty=self.penalty,
                             dirichlet=self.dirichlet,
                             diffusion=self.diffusion, plan=self.plan,
                             dtype=self.dtype, device=self.device)


@dataclass
class HeatProblem:
    """du/dt = div(grad u), implicit Euler: (M + dt A) u+ = M u.

    ``mg_kwargs`` go to the step's ``multigrid_solver`` (for example
    ``meshes`` or ``coarse``); without them, as in the reference, the
    hierarchy has p-levels only and a 40-sweep GS coarse solve above
    ``multigrid.DENSE_COARSE_MAX`` dofs, which contracts by about 0.99
    per cycle at 884,736 dofs (32^3, p=2)."""

    basis: DGBasis
    dt: float
    penalty: float = 2.0
    dtype: object = torch.float64
    device: object = None
    mg_kwargs: dict | None = None

    def __post_init__(self):
        from hpdg_tpu_torch.assemble import assemble_laplace, assemble_mass
        from hpdg_tpu_torch.solvers.multigrid import multigrid_solver
        self.device = dev.resolve(self.device)
        self.plan = build_plan(self.basis)
        self.A = assemble_laplace(self.basis, penalty=self.penalty,
                                  dirichlet=True, plan=self.plan,
                                  dtype=self.dtype, device=self.device)
        self.M = assemble_mass(self.basis, plan=self.plan, dtype=self.dtype,
                               device=self.device)
        self.S = bm.add_scaled(self.M, self.A, self.dt)
        self._step, _ = multigrid_solver(self.basis, self.S,
                                         dtype=self.dtype,
                                         **(self.mg_kwargs or {}))

    def advance(self, u, tol: float = 1e-10, maxiter: int = 40):
        from hpdg_tpu_torch.solvers.cg import loop_solve
        rhs = bm.matvec(self.M, u)
        return loop_solve(self._step, u, rhs,
                          matvec_fn=lambda v: bm.matvec(self.S, v),
                          tol=tol, maxiter=maxiter)


@dataclass
class ElasticityProblem:
    """Linear elasticity hp-DG (BASELINE config 4)."""

    basis: DGBasis
    mu: float = 1.0
    lam: float = 1.0
    penalty: float = 8.0
    dirichlet: bool = True
    dtype: object = torch.float64
    device: object = None

    def __post_init__(self):
        from hpdg_tpu_torch.assemble.elasticity import assemble_elasticity
        self.device = dev.resolve(self.device)
        self.plan = build_plan(self.basis)
        self.A = assemble_elasticity(self.basis, mu=self.mu, lam=self.lam,
                                     penalty=self.penalty,
                                     dirichlet=self.dirichlet,
                                     plan=self.plan, dtype=self.dtype,
                                     device=self.device)

    def rhs(self, force):
        from hpdg_tpu_torch.assemble.elasticity import l2_functional_vec
        return l2_functional_vec(self.basis, force, dtype=self.dtype,
                                 device=self.device)

    def solve(self, b, tol: float = 1e-8, maxiter: int = 60, meshes=None):
        from hpdg_tpu_torch.assemble.elasticity import assemble_elasticity
        factory = lambda bas: assemble_elasticity(  # noqa: E731
            bas, mu=self.mu, lam=self.lam, penalty=self.penalty,
            dirichlet=self.dirichlet, dtype=self.dtype, device=self.device)
        return api.solve_linear(self.basis, self.A, b, tol=tol,
                                maxiter=maxiter, meshes=meshes,
                                operator_factory=factory,
                                pre_steps=5, post_steps=5,
                                dtype=self.dtype)


@dataclass
class ObstacleProblem:
    """min 1/2 u^T A u - b^T u  s.t.  lo <= u <= up (BASELINE config 5)."""

    basis: DGBasis
    penalty: float = 2.0
    dtype: object = torch.float64
    device: object = None

    def __post_init__(self):
        self.device = dev.resolve(self.device)
        self.plan = build_plan(self.basis)
        self.A = api.laplace(self.basis, penalty=self.penalty,
                             dirichlet=True, plan=self.plan,
                             dtype=self.dtype, device=self.device)

    def solve(self, b, lower=-np.inf, upper=np.inf, tol: float = 1e-9,
              maxiter: int = 100):
        lo, up = api.constant_bounds(self.basis, lower=lower, upper=upper,
                                     dtype=self.dtype, device=self.device)
        return api.solve_obstacle(self.basis, self.A, b, lo, up, tol=tol,
                                  maxiter=maxiter)
