"""Right-hand-side functionals: L2 load vector, SIPG Dirichlet data and
the Neumann boundary functional.

Port of ``hpdg_tpu.assemble.rhs`` (the BuildingBlocks::l2Functional and
::dirichletData analogs).  All three honour first-class geometry: the
host-side geometry factors are uploaded once per call.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble.plan import (AssemblyPlan, build_plan,
                                          boundary_penalty_coef,
                                          boundary_phys_points)
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.mesh import geometry as geo


def volume_detj(mesh, elems, xp) -> np.ndarray:
    """Physical volume element at the parametric points ``xp`` of
    ``elems``: ``[n, q]`` on trilinear meshes, ``[n, 1]`` otherwise."""
    detp = np.prod(mesh.extent[elems], axis=1)
    if geo.is_trilinear(mesh):
        return detp[:, None] * geo.detj_phys(mesh, elems, xp)
    return (detp * geo.detj_phys(mesh, elems))[:, None]


def l2_functional(basis: DGBasis, f, quad_order=None, dtype=torch.float64,
                  device=None) -> dict:
    """b_i = ∫ f phi_i, as a bucketed block vector.

    ``f`` is a vectorized callable on tensors of physical points
    (..., dim).  Default quadrature: Gauss-Legendre exact to order 2p+2.
    """
    device = dev.resolve(device)
    mesh = basis.mesh
    dim = mesh.dim
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    out = {}
    for p in basis.bucket_degrees:
        order = quad_order if quad_order is not None else 2 * p + 2
        nq1 = max(1, (order + 2) // 2)
        vt = tensor.volume_tables(p, dim, nq1, family=basis.family,
                                  quad_family="legendre")
        V, w = vt["V"], vt["weights"]
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        xp = (mesh.lower[elems][:, None, :]
              + vt["points"][None, :, :] * ext[:, None, :])
        detJ = volume_detj(mesh, elems, xp)
        fv = f(as_t(geo.apply_map(mesh, elems, xp))).to(dtype)
        fw = fv * as_t(w)[None, :] * as_t(detJ)
        out[p] = torch.einsum("eq,iq->ei", fw, as_t(V))
    return out


def dirichlet_rhs(basis: DGBasis, g, penalty: float = 2.0,
                  dtype=torch.float64, plan: AssemblyPlan | None = None,
                  penalty_scaling: str = "measure", diffusion=None,
                  device=None) -> dict:
    """SIPG-consistent Dirichlet boundary functional:
    b_i += ∫_bdry g * (mu * v_i - (K grad v_i).n), mu = penalty p^2/|f|.

    Geometry-aware (affine / trilinear meshes) and coefficient-aware, so
    it is the exact adjoint-consistent companion of
    ``assemble_laplace(..., dirichlet=True, diffusion=...)``."""
    from hpdg_tpu_torch.assemble.sipg import is_tensor_coefficient
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    mesh = basis.mesh
    dim = mesh.dim
    geom = geo.has_geometry(mesh)
    kmat = geom or is_tensor_coefficient(diffusion, dim, dtype, device)
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    out = bv.zeros(basis, dtype=dtype, device=device)
    for bg in plan.boundary_groups:
        p, ax, side = bg.p, bg.axis, bg.side
        sign = 1.0 if side == 1 else -1.0
        ft = tensor.face_tables(p, dim, ax, side, p + 2, family=basis.family)
        w, V, D = ft["weights"], ft["V"], ft["Dn"]
        pen = (geo.boundary_penalty_coef_mesh(mesh, bg, penalty,
                                              penalty_scaling)
               if geom else
               boundary_penalty_coef(bg, penalty, penalty_scaling))  # (nf,)
        elems = mesh.bfaces.elem[bg.face_ids]
        xp = boundary_phys_points(basis, bg, ft["points"])
        x = J(geo.apply_map(mesh, elems, xp))
        gv = g(x).to(dtype)  # (nf, q)
        k = None if diffusion is None else diffusion(x).to(dtype)
        gw = gv * J(w)[None]
        # mu * |f| * w = pen_f * w (per-face penalty convention)
        penpart = J(pen)[:, None] * torch.einsum("fq,iq->fi", gw, J(V))
        if kmat:
            keff = geo.effective_tensor(mesh, elems, k, xp) if geom else k
            Ka = J(keff)[..., ax, :]  # (nf, q, dim)
            zg = gw * J(bg.fmeas)[:, None]
            cons = sign * torch.einsum("fq,fqb,fb,biq->fi", zg, Ka,
                                       J(1.0 / mesh.extent[elems]),
                                       J(ft["Dall"]))
        else:
            kz = gw if k is None else gw * k
            cons = torch.einsum(
                "fq,iq->fi", kz * J(sign * bg.fmeas * bg.inv_h)[:, None],
                J(D))
        out[p] = out[p].index_add(
            0, torch.as_tensor(bg.pos, dtype=torch.int64, device=device),
            penpart - cons)
    return out


def neumann_rhs(basis: DGBasis, g, dtype=torch.float64,
                plan: AssemblyPlan | None = None, device=None) -> dict:
    """Neumann boundary functional b_i = ∫_bdry g v_i over the physical
    surface measure (per-point Nanson factor on meshes with geometry)."""
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    mesh = basis.mesh
    dim = mesh.dim
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    out = bv.zeros(basis, dtype=dtype, device=device)
    for bg in plan.boundary_groups:
        p, ax, side = bg.p, bg.axis, bg.side
        ft = tensor.face_tables(p, dim, ax, side, p + 2, family=basis.family)
        w, V = ft["weights"], ft["V"]
        elems = mesh.bfaces.elem[bg.face_ids]
        xp = boundary_phys_points(basis, bg, ft["points"])
        gv = g(J(geo.apply_map(mesh, elems, xp))).to(dtype)
        zw = bg.fmeas[:, None] * w[None]
        if geo.has_geometry(mesh):
            zw = zw * geo.face_jacobian_factor(mesh, elems, ax, xp)
        out[p] = out[p].index_add(
            0, torch.as_tensor(bg.pos, dtype=torch.int64, device=device),
            torch.einsum("fq,iq->fi", gv * J(zw), J(V)))
    return out
