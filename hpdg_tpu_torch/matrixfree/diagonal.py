"""Matrix-free diagonal-block extraction for block-Jacobi smoothing.

Port of ``hpdg_tpu.matrixfree.diagonal`` for box meshes: only the
(e, e) diagonal blocks of the SIPG operator (bulk block plus the
M11/M22 face and the Dirichlet contributions), without forming the
global matrix.  Computed in numpy f64 on the host (set-up work, one
vectorized pass per group) and handed over as tensors on ``device``.
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
from hpdg_tpu_torch.assemble.sipg import is_tensor_coefficient


def _sym(M):
    return M + M.T


def _scatter_add(out, pos, vals):
    """out[pos] += vals (positions may repeat on hanging-face groups)."""
    np.add.at(out, pos, np.broadcast_to(vals, (len(pos),) + out.shape[1:]))


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
    kmat = is_tensor_coefficient(diffusion, dim, torch.float64, "cpu")

    def K(x):
        return diffusion(torch.as_tensor(x, dtype=torch.float64)).to(
            torch.float64).numpy()

    out = {}
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, dim, p + 2, family=basis.family)
        G, w = vt["G"], vt["weights"]
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        detJ = np.prod(ext, axis=1)
        invh2 = detJ[:, None] / ext**2
        if diffusion is None:
            S = np.einsum("q,aiq,ajq->aij", w, G, G)
            out[p] = np.einsum("ea,aij->eij", invh2, S)
            continue
        k = K(mesh.lower[elems][:, None, :]
              + vt["points"][None, :, :] * ext[:, None, :])
        if kmat:
            # (K grad u, grad v): sum_ab detJ w K_ab h_a^-1 h_b^-1
            kw = k * w[None, :, None, None] * detJ[:, None, None, None]
            invh = 1.0 / ext
            out[p] = np.einsum("eqab,ea,eb,aiq,bjq->eij", kw, invh, invh,
                               G, G)
        else:
            out[p] = np.einsum("eq,ea,aiq,ajq->eij", k * w[None, :], invh2,
                               G, G)

    for fg in plan.face_groups:
        pmax = max(fg.p_in, fg.p_out)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        w = fin["weights"]
        pen = penalty_coef(fg, penalty, pmax, penalty_scaling)[:, None, None]
        c_in = -0.5 * fg.fmeas * fg.inv_h_in
        c_out = -0.5 * fg.fmeas * fg.inv_h_out
        BVVi = np.einsum("iq,q,jq->ij", fin["V"], w, fin["V"])
        BVVo = np.einsum("iq,q,jq->ij", fout["V"], w, fout["V"])
        if diffusion is None:
            AVDi = np.einsum("iq,q,jq->ij", fin["V"], w, fin["Dn"])
            AVDo = np.einsum("iq,q,jq->ij", fout["V"], w, fout["Dn"])
            M11 = c_in[:, None, None] * _sym(AVDi) + pen * BVVi[None]
            M22 = -c_out[:, None, None] * _sym(AVDo) + pen * BVVo[None]
        elif kmat:
            # co-normal consistency: n.K grad u = sum_b K_{axis,b}/h_b d_b u
            ein = mesh.faces.inside[fg.face_ids]
            eout = mesh.faces.outside[fg.face_ids]
            k = K(face_phys_points(basis, fg, fin["points"]))
            DnKi = np.einsum("fqb,fb,bjq->fjq", k[..., fg.axis, :],
                             1.0 / mesh.extent[ein], fin["Dall"])
            DnKo = np.einsum("fqb,fb,bjq->fjq", k[..., fg.axis, :],
                             1.0 / mesh.extent[eout], fout["Dall"])
            zi = -0.5 * fg.fmeas
            M11 = (zi[:, None, None]
                   * (np.einsum("iq,q,fjq->fij", fin["V"], w, DnKi)
                      + np.einsum("fiq,q,jq->fij", DnKi, w, fin["V"]))
                   + pen * BVVi[None])
            M22 = (-zi[:, None, None]
                   * (np.einsum("iq,q,fjq->fij", fout["V"], w, DnKo)
                      + np.einsum("fiq,q,jq->fij", DnKo, w, fout["V"]))
                   + pen * BVVo[None])
        else:
            k = K(face_phys_points(basis, fg, fin["points"]))
            kzi = k * w[None, :] * c_in[:, None]
            kzo = k * w[None, :] * c_out[:, None]
            M11 = (np.einsum("fq,iq,jq->fij", kzi, fin["V"], fin["Dn"])
                   + np.einsum("fq,iq,jq->fij", kzi, fin["Dn"], fin["V"])
                   + pen * BVVi[None])
            M22 = (-np.einsum("fq,iq,jq->fij", kzo, fout["V"], fout["Dn"])
                   - np.einsum("fq,iq,jq->fij", kzo, fout["Dn"], fout["V"])
                   + pen * BVVo[None])
        _scatter_add(out[fg.p_in], fg.in_pos, M11)
        _scatter_add(out[fg.p_out], fg.out_pos, M22)

    if dirichlet:
        for bg in plan.boundary_groups:
            ft = tensor.face_tables(bg.p, dim, bg.axis, bg.side, bg.p + 2,
                                    family=basis.family)
            w = ft["weights"]
            sign = 1.0 if bg.side == 1 else -1.0
            c = -sign * bg.fmeas * bg.inv_h
            penb = boundary_penalty_coef(bg, penalty,
                                         penalty_scaling)[:, None, None]
            BVV = np.einsum("iq,q,jq->ij", ft["V"], w, ft["V"])
            if diffusion is None:
                AVD = np.einsum("iq,q,jq->ij", ft["V"], w, ft["Dn"])
                M = c[:, None, None] * _sym(AVD) + penb * BVV[None]
            else:
                k = K(boundary_phys_points(basis, bg, ft["points"]))
                if kmat:
                    elems = mesh.bfaces.elem[bg.face_ids]
                    DnK = np.einsum("fqb,fb,bjq->fjq", k[..., bg.axis, :],
                                    1.0 / mesh.extent[elems], ft["Dall"])
                    z = -sign * bg.fmeas
                    M = (z[:, None, None]
                         * (np.einsum("iq,q,fjq->fij", ft["V"], w, DnK)
                            + np.einsum("fiq,q,jq->fij", DnK, w, ft["V"]))
                         + penb * BVV[None])
                else:
                    kz = k * w[None, :] * c[:, None]
                    M = (np.einsum("fq,iq,jq->fij", kz, ft["V"], ft["Dn"])
                         + np.einsum("fq,iq,jq->fij", kz, ft["Dn"], ft["V"])
                         + penb * BVV[None])
            _scatter_add(out[bg.p], bg.pos, M)
    return {p: torch.as_tensor(d, dtype=dtype, device=device)
            for p, d in out.items()}
