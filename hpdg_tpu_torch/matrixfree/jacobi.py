"""Matrix-free block-Jacobi drivers and diagonal-block factories.

Port of ``hpdg_tpu.matrixfree.jacobi``:

* the mass and heat diagonal blocks (mass + SIPG stiffness), plain and
  weighted (a mass weight w(x), a diffusion coefficient K(x));
* the identity and block-diagonal operators;
* the batched projected scalar GS inside diagonal blocks
  (:func:`local_projected_gs`), which is also the local solver of
  TNNMG's projected block GS (``solvers.tnnmg``);
* matrix-free projected and nonlinear block Jacobi.

The blocks are computed in numpy f64 on the host (set-up work) and
handed over as tensors in ``dtype`` on ``device``.  Geometry-aware:
affine maps scale by |det A|, trilinear (Q1) maps integrate the
per-point |det J|.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble.plan import AssemblyPlan
from hpdg_tpu_torch.assemble.rhs import volume_detj
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks
from hpdg_tpu_torch.mesh import geometry as geo


def mass_diagonal_blocks(basis: DGBasis, dtype=torch.float64,
                         device=None) -> dict:
    """p -> [n_p, bs, bs] element mass blocks (the mass matrix is
    block-diagonal)."""
    device = dev.resolve(device)
    mesh = basis.mesh
    out = {}
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, basis.dim, p + 2, family=basis.family)
        elems = basis.bucket_elems[p]
        xpq = (mesh.lower[elems][:, None, :]
               + vt["points"][None, :, :] * mesh.extent[elems][:, None, :])
        detq = volume_detj(mesh, elems, xpq)  # [n, q] on Q1, else [n, 1]
        if geo.is_trilinear(mesh):
            Me = np.einsum("eq,q,iq,jq->eij", detq, vt["weights"],
                           vt["V"], vt["V"])
        else:
            M0 = np.einsum("iq,q,jq->ij", vt["V"], vt["weights"], vt["V"])
            Me = detq[:, :, None] * M0[None]
        out[p] = torch.as_tensor(Me, dtype=dtype, device=device)
    return out


def heat_diagonal_blocks(basis: DGBasis, penalty: float = 2.0,
                         mass_coef: float = 1.0, dirichlet: bool = False,
                         dtype=torch.float64, plan: AssemblyPlan | None = None,
                         device=None) -> dict:
    """Diagonal blocks of ``mass_coef * M + A_sipg``: the heat-operator
    block factory for Jacobi smoothers."""
    A = sipg_diagonal_blocks(basis, penalty=penalty, dirichlet=dirichlet,
                             dtype=dtype, plan=plan, device=device)
    M = mass_diagonal_blocks(basis, dtype=dtype, device=device)
    return {p: mass_coef * M[p] + A[p] for p in A}


def identity_operator():
    """Copies input to output."""
    return lambda x: x


def blockdiag_operator(blocks: dict):
    """Matrix-free apply of a block-diagonal operator given its blocks
    ``{p: [n_p, bs, bs]}``."""
    def apply(x):
        return {p: torch.bmm(blocks[p], x[p].unsqueeze(-1)).squeeze(-1)
                for p in x}
    return apply


def local_projected_gs(Dm, r, x0, lo_b, up_b, sweeps: int = 2):
    """Batched projected scalar GS inside diagonal blocks: minimizes the
    local quadratics ``1/2 y^T Dm y - r^T y`` over the boxes
    ``[lo_b, up_b]``, starting from ``x0`` (all ``[n, bs]``, ``Dm``
    ``[n, bs, bs]``).  One column per update, ``sweeps`` times over the
    block; bounds may hold ±inf.  Returns a new tensor."""
    y = x0.clone()
    for _ in range(sweeps):
        for i in range(Dm.shape[1]):
            s = torch.einsum("nj,nj->n", Dm[:, i, :], y) \
                - Dm[:, i, i] * y[:, i]
            yi = (r[:, i] - s) / Dm[:, i, i]
            y[:, i] = torch.clamp(yi, lo_b[:, i], up_b[:, i])
    return y


def matrix_free_block_projected_jacobi(op, diag_blocks: dict, lo: dict,
                                       up: dict, sweeps: int = 2,
                                       omega: float = 1.0):
    """Matrix-free projected block Jacobi for obstacle problems: the
    residual through the operator ``op``, box-constrained local solves
    on the given diagonal blocks.  Returns a step ``(x, b) -> x`` that
    keeps x feasible."""

    def step(x, b):
        r = bv.sub(b, op(x))
        newx = {}
        for p in x:
            Dm = diag_blocks[p]
            r_loc = r[p] + torch.bmm(Dm, x[p].unsqueeze(-1)).squeeze(-1)
            y = local_projected_gs(Dm, r_loc, x[p], lo[p], up[p],
                                   sweeps=sweeps)
            newx[p] = torch.clamp(x[p] + omega * (y - x[p]), lo[p], up[p])
        return newx

    return step


def matrix_free_block_nonlinear_jacobi(op, diag_blocks: dict, local_solver,
                                       omega: float = 1.0):
    """Generic nonlinear block Jacobi: ``local_solver(D, r, x)`` solves
    the diagonal-block subproblems of a bucket (batched)."""

    def step(x, b):
        r = bv.sub(b, op(x))
        newx = {}
        for p in x:
            Dm = diag_blocks[p]
            r_loc = r[p] + torch.bmm(Dm, x[p].unsqueeze(-1)).squeeze(-1)
            y = local_solver(Dm, r_loc, x[p])
            newx[p] = x[p] + omega * (y - x[p])
        return newx

    return step


def weighted_mass_diagonal_blocks(basis: DGBasis, weight,
                                  dtype=torch.float64, device=None) -> dict:
    """p -> [n_p, bs, bs] element blocks of (w(x) u, v); ``weight`` is a
    vectorized callable on tensors of physical points (..., dim)."""
    mesh = basis.mesh
    device = dev.resolve(device)
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    out = {}
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, basis.dim, p + 2, family=basis.family)
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        xp = (mesh.lower[elems][:, None, :]
              + vt["points"][None, :, :] * ext[:, None, :])
        wq = weight(J(geo.apply_map(mesh, elems, xp))).to(dtype) \
            * J(vt["weights"])[None, :] * J(volume_detj(mesh, elems, xp))
        out[p] = torch.einsum("eq,iq,jq->eij", wq, J(vt["V"]), J(vt["V"]))
    return out


def weighted_heat_diagonal_blocks(basis: DGBasis, weight=None, diffusion=None,
                                  penalty: float = 2.0, mass_coef: float = 1.0,
                                  dirichlet: bool = False, dtype=torch.float64,
                                  penalty_scaling: str = "measure",
                                  plan: AssemblyPlan | None = None,
                                  device=None) -> dict:
    """Diagonal blocks of ``mass_coef * (w u, v) + a_K(u, v)``: the
    weighted heat-operator block factory.  The mass weight ``w(x)`` and
    the diffusion coefficient ``K(x)`` (scalar or (dim, dim) tensor per
    point) are optional callables on physical points."""
    A = sipg_diagonal_blocks(basis, penalty=penalty, dirichlet=dirichlet,
                             dtype=dtype, plan=plan, diffusion=diffusion,
                             penalty_scaling=penalty_scaling, device=device)
    if weight is None:
        M = mass_diagonal_blocks(basis, dtype=dtype, device=device)
    else:
        M = weighted_mass_diagonal_blocks(basis, weight, dtype=dtype,
                                          device=device)
    return {p: mass_coef * M[p] + A[p] for p in A}
