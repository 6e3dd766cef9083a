"""Matrix-free hp-multigrid: levels, the V-cycle and the coarse solve.

Port of the branch of ``hpdg_tpu.solvers.multigrid`` that the 3D SIPG
solve takes: a p-chain (max degree halved down to 1) on the fine
lattice, then h-levels at p=1 down to the base mesh; every non-coarse
level applies the uniform-lattice stencil (``ops.uniform_stencil``: the
CUDA kernel on the card, its plain twin on the CPU) and smooths with
one forward / one backward vertex-patch sweep; the coarsest level is a
dense Cholesky solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.linalg import blockvector as bv


@dataclass
class Level:
    """Operations of one multigrid level (LevelOperations analog)."""

    apply: Callable  # x -> A x
    pre_smooth: Callable  # (x, b) -> x, one sweep
    post_smooth: Callable
    restrict: Callable  # residual -> coarser level
    prolong: Callable  # coarser correction -> this level


def vcycle(levels: list, coarse_solve: Callable, x: dict, b: dict) -> dict:
    """One V-cycle on the finest level: one pre- and one post-smoothing
    sweep per level (the solve's 1+1 setting).

    levels[0] is the coarsest (never smoothed); coarse_solve(b) -> x
    solves it.
    """

    def run(l: int, x, b):
        if l == 0:
            return coarse_solve(b)
        L = levels[l]
        x = L.pre_smooth(x, b)
        r = bv.sub(b, L.apply(x))
        rc = L.restrict(r)
        xc = run(l - 1, bv.zeros_like(rc), rc)
        x = bv.add(x, L.prolong(xc))
        return L.post_smooth(x, b)

    return run(len(levels) - 1, x, b)


def dense_coarse_solver(basis: DGBasis, A: bm.BlockSparseMatrix,
                        dtype=torch.float64, device=None):
    """Direct coarse solve: Cholesky factor computed once on the host in
    f64, triangular solves in ``dtype`` on ``device``."""
    device = dev.resolve(device)
    Ad = bm.to_dense(A, basis)
    Ad = torch.from_numpy(0.5 * (Ad + Ad.T))
    L, info = torch.linalg.cholesky_ex(Ad)
    if int(info) == 0:
        Lc = L.to(device=device, dtype=dtype)
        solve_dense = lambda f: torch.cholesky_solve(f[:, None], Lc)[:, 0]  # noqa: E731
    else:
        # not SPD (e.g. under-penalized SIPG): a dense inverse, as the
        # reference does
        inv = torch.linalg.inv(Ad).to(device=device, dtype=dtype)
        solve_dense = lambda f: inv @ f  # noqa: E731

    idx = {p: torch.as_tensor(
        basis.offsets[basis.bucket_elems[p]][:, None]
        + np.arange(basis.n_local(p))[None, :], device=device)
        for p in basis.bucket_degrees}

    def solve(b: dict) -> dict:
        flat = torch.zeros(basis.ndof, dtype=dtype, device=device)
        for p in basis.bucket_degrees:
            flat[idx[p]] = b[p]
        y = solve_dense(flat)
        return {p: y[idx[p]] for p in basis.bucket_degrees}

    return solve


def matrixfree_multigrid_solver(basis: DGBasis, penalty: float = 2.0,
                                dirichlet: bool = True,
                                meshes: list | None = None,
                                penalty_scaling: str = "measure",
                                smoother: str = "patch",
                                dtype=torch.float32, device=None):
    """Matrix-free hp-multigrid V-cycle for the SIPG Laplacian on a full
    uniform lattice.  Returns ``(step, info)``: ``step(x, b) -> x`` is one
    V-cycle; ``info`` holds the bases, transfers, levels, and per
    non-coarse level its operator and smoother.
    """
    from hpdg_tpu_torch.assemble.sipg import assemble_laplace
    from hpdg_tpu_torch.ops.uniform_stencil import uniform_stencil_operator
    from hpdg_tpu_torch.solvers.patches import UniformPatchSmoother
    from hpdg_tpu_torch.transfer import h_transfer, p_transfer

    if smoother != "patch":
        raise NotImplementedError(
            f"smoother={smoother!r}: Chebyshev and block smoothers are "
            "ROADMAP queue 1, item 10 (diagonal blocks + Chebyshev)")
    device = dev.resolve(device)
    bases, transfers = [basis], []
    while bases[0].max_degree() > 1:
        T = p_transfer(bases[0], max(1, bases[0].max_degree() // 2))
        bases.insert(0, T.coarse)
        transfers.insert(0, T)
    if meshes is not None:
        if meshes[-1] is not basis.mesh:
            raise ValueError("meshes must end with the basis' mesh")
        for coarse_mesh in reversed(list(meshes)[:-1]):
            cb = DGBasis(coarse_mesh,
                         np.full(coarse_mesh.n_elements,
                                 bases[0].max_degree(), dtype=np.int32),
                         family=basis.family)
            T = h_transfer(bases[0], cb)
            bases.insert(0, cb)
            transfers.insert(0, T)

    cb = bases[0]
    if cb.ndof > 6000:
        raise NotImplementedError(
            f"coarse level of {cb.ndof} dofs: the Gauss-Seidel coarse "
            "solver is ROADMAP queue 1, item 11 (gs_coarse_solver)")

    levels = [None]  # the coarsest level is only solved directly
    operators, smoothers = [], []
    for l in range(1, len(bases)):
        bas = bases[l]
        (pd,) = bas.bucket_degrees
        if 2 ** bas.mesh.dim * (pd + 1) ** bas.mesh.dim > 1024:
            raise NotImplementedError(
                f"p={pd}: patch blocks above 1024 dofs smooth with "
                "Chebyshev, ROADMAP queue 1, item 10")
        op = uniform_stencil_operator(bas, penalty=penalty,
                                      dirichlet=dirichlet,
                                      penalty_scaling=penalty_scaling,
                                      device=device)
        sm = UniformPatchSmoother(op, bas, penalty, dirichlet=dirichlet,
                                  penalty_scaling=penalty_scaling,
                                  dtype=dtype, device=device)
        T = transfers[l - 1]
        levels.append(Level(
            apply=op, pre_smooth=sm.forward, post_smooth=sm.backward,
            restrict=(lambda TT: lambda r: TT.restrict(r, dtype=dtype))(T),
            prolong=(lambda TT: lambda c: TT.prolong(c, dtype=dtype))(T)))
        operators.append(op)
        smoothers.append(sm)

    Ac = assemble_laplace(cb, penalty=penalty, dirichlet=dirichlet,
                          penalty_scaling=penalty_scaling, dtype=dtype,
                          device="cpu")
    coarse_solve = dense_coarse_solver(cb, Ac, dtype=dtype, device=device)

    def step(x: dict, b: dict) -> dict:
        return vcycle(levels, coarse_solve, x, b)

    return step, {"bases": bases, "transfers": transfers, "levels": levels,
                  "operators": operators, "smoothers": smoothers}
