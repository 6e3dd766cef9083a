"""Matrix-free diagonal-block extraction for block-Jacobi smoothing.

Port of ``hpdg_tpu.matrixfree.diagonal``: only the (e, e) diagonal
blocks of the SIPG operator (bulk block plus the M11/M22 face and the
Dirichlet contributions), without forming the global matrix.  Set-up
work: the tables and geometry factors come from the host, the per-point
einsums run in f64 on ``device`` (one vectorized pass per group), and
the blocks are handed over in ``dtype``.  Meshes with first-class
geometry take the tensor-coefficient branch with the effective tensor
``|det J| J^-1 K J^-T`` (``mesh/geometry.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.mesh.structured import require_classic_faces
from hpdg_tpu_torch.assemble.plan import (AssemblyPlan, build_plan,
                                          boundary_phys_points,
                                          face_group_tables, face_phys_points,
                                          penalty_coef, boundary_penalty_coef)
from hpdg_tpu_torch.assemble.sipg import (bulk_tensor_blocks,
                                          is_tensor_coefficient)
from hpdg_tpu_torch.mesh import geometry as geo


def _sym(M):
    return M + M.transpose(-2, -1)


def sipg_diagonal_blocks(basis: DGBasis, penalty: float = 2.0,
                         dirichlet: bool = False, dtype=torch.float64,
                         penalty_scaling: str = "measure",
                         diffusion=None,
                         plan: AssemblyPlan | None = None,
                         device=None) -> dict:
    """p -> Tensor[n_p, bs, bs] diagonal blocks of the SIPG operator, in
    ``dtype`` on ``device``.

    ``diffusion``: optional coefficient K(x) on tensors of physical
    points, scalar or symmetric (dim, dim) TENSOR per point."""
    require_classic_faces(basis.mesh, "sipg_diagonal_blocks")
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    mesh = basis.mesh
    dim = mesh.dim
    f64 = torch.float64
    affine = geo.has_affine(mesh)
    const = diffusion is None and not affine
    kmat = affine or is_tensor_coefficient(diffusion, dim, f64, device)
    J = lambda a: torch.as_tensor(a, dtype=f64, device=device)  # noqa: E731
    I = lambda a: torch.as_tensor(  # noqa: E731, E741
        np.asarray(a, np.int64), device=device)

    def medium(elems, xp):
        """The user's medium at the physical image of the parametric
        points ``xp`` of ``elems`` (None without ``diffusion``)."""
        return None if diffusion is None else diffusion(
            J(geo.apply_map(mesh, elems, xp))).to(f64)

    def fold(elems, k, xp):
        """``k`` with the geometry of ``elems`` at ``xp`` folded in."""
        return J(geo.effective_tensor(mesh, elems, k, xp)) if affine else k

    def K(elems, xp):
        return fold(elems, medium(elems, xp), xp)

    def scatter_add(out, pos, vals):
        """out[pos] += vals (positions may repeat on hanging faces)."""
        out.index_add_(0, I(pos), vals.expand((len(pos),) + out.shape[1:]))

    out = {}
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, dim, p + 2, family=basis.family)
        G, w = vt["G"], vt["weights"]
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        detJ = np.prod(ext, axis=1)
        invh2 = detJ[:, None] / ext**2
        if const:
            S = np.einsum("q,aiq,ajq->aij", w, G, G)
            out[p] = J(np.einsum("ea,aij->eij", invh2, S))
            continue
        xp = (mesh.lower[elems][:, None, :]
              + vt["points"][None, :, :] * ext[:, None, :])
        k = K(elems, xp)
        if kmat:
            # (K grad u, grad v): sum_ab detJ w K_ab h_a^-1 h_b^-1
            cof = detJ[:, None, None] / (ext[:, :, None] * ext[:, None, :])
            out[p] = bulk_tensor_blocks(
                k * J(w)[None, :, None, None] * J(cof)[:, None], J(G))
        else:
            out[p] = torch.einsum("eq,ea,aiq,ajq->eij", k * J(w)[None, :],
                                  J(invh2), J(G), J(G))

    for fg in plan.face_groups:
        pmax = max(fg.p_in, fg.p_out)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        w = fin["weights"]
        pen = J(geo.penalty_coef_mesh(mesh, fg, penalty, pmax,
                                      penalty_scaling) if affine else
                penalty_coef(fg, penalty, pmax,
                             penalty_scaling))[:, None, None]
        c_in = -0.5 * fg.fmeas * fg.inv_h_in
        c_out = -0.5 * fg.fmeas * fg.inv_h_out
        Vi, Vo, wj = J(fin["V"]), J(fout["V"]), J(w)
        BVVi = J(np.einsum("iq,q,jq->ij", fin["V"], w, fin["V"]))
        BVVo = J(np.einsum("iq,q,jq->ij", fout["V"], w, fout["V"]))
        ein = mesh.faces.inside[fg.face_ids]
        eout = mesh.faces.outside[fg.face_ids]
        if const:
            AVDi = J(np.einsum("iq,q,jq->ij", fin["V"], w, fin["Dn"]))
            AVDo = J(np.einsum("iq,q,jq->ij", fout["V"], w, fout["Dn"]))
            M11 = J(c_in)[:, None, None] * _sym(AVDi) + pen * BVVi[None]
            M22 = -J(c_out)[:, None, None] * _sym(AVDo) + pen * BVVo[None]
        elif kmat:
            # co-normal consistency: n.K grad u = sum_b K_{axis,b}/h_b d_b u
            xp = face_phys_points(basis, fg, fin["points"])
            k = medium(ein, xp)  # one evaluation serves both sides
            if affine:
                xpo = face_phys_points(basis, fg, fin["points"], side="out")
                k_in, k_out = fold(ein, k, xp), fold(eout, k, xpo)
            else:
                k_in = k_out = k
            DnKi = torch.einsum("fqb,fb,bjq->fjq", k_in[..., fg.axis, :],
                                J(1.0 / mesh.extent[ein]), J(fin["Dall"]))
            DnKo = torch.einsum("fqb,fb,bjq->fjq", k_out[..., fg.axis, :],
                                J(1.0 / mesh.extent[eout]), J(fout["Dall"]))
            zi = J(-0.5 * fg.fmeas)[:, None, None]
            M11 = (zi * _sym(torch.einsum("iq,q,fjq->fij", Vi, wj, DnKi))
                   + pen * BVVi[None])
            M22 = (-zi * _sym(torch.einsum("iq,q,fjq->fij", Vo, wj, DnKo))
                   + pen * BVVo[None])
        else:
            k = K(ein, face_phys_points(basis, fg, fin["points"]))
            kzi = k * wj[None, :] * J(c_in)[:, None]
            kzo = k * wj[None, :] * J(c_out)[:, None]
            M11 = (_sym(torch.einsum("fq,iq,jq->fij", kzi, Vi, J(fin["Dn"])))
                   + pen * BVVi[None])
            M22 = (-_sym(torch.einsum("fq,iq,jq->fij", kzo, Vo,
                                      J(fout["Dn"])))
                   + pen * BVVo[None])
        scatter_add(out[fg.p_in], fg.in_pos, M11)
        scatter_add(out[fg.p_out], fg.out_pos, M22)

    if dirichlet:
        for bg in plan.boundary_groups:
            ft = tensor.face_tables(bg.p, dim, bg.axis, bg.side, bg.p + 2,
                                    family=basis.family)
            w = ft["weights"]
            sign = 1.0 if bg.side == 1 else -1.0
            c = -sign * bg.fmeas * bg.inv_h
            penb = J(geo.boundary_penalty_coef_mesh(mesh, bg, penalty,
                                                    penalty_scaling)
                     if affine else
                     boundary_penalty_coef(bg, penalty,
                                           penalty_scaling))[:, None, None]
            V, wj = J(ft["V"]), J(w)
            BVV = J(np.einsum("iq,q,jq->ij", ft["V"], w, ft["V"]))
            if const:
                AVD = J(np.einsum("iq,q,jq->ij", ft["V"], w, ft["Dn"]))
                M = J(c)[:, None, None] * _sym(AVD) + penb * BVV[None]
            else:
                elems = mesh.bfaces.elem[bg.face_ids]
                k = K(elems, boundary_phys_points(basis, bg, ft["points"]))
                if kmat:
                    DnK = torch.einsum("fqb,fb,bjq->fjq", k[..., bg.axis, :],
                                       J(1.0 / mesh.extent[elems]),
                                       J(ft["Dall"]))
                    M = (J(-sign * bg.fmeas)[:, None, None]
                         * _sym(torch.einsum("iq,q,fjq->fij", V, wj, DnK))
                         + penb * BVV[None])
                else:
                    kz = k * wj[None, :] * J(c)[:, None]
                    M = (_sym(torch.einsum("fq,iq,jq->fij", kz, V,
                                           J(ft["Dn"])))
                         + penb * BVV[None])
            scatter_add(out[bg.p], bg.pos, M)
    return {p: d.to(dtype) for p, d in out.items()}
