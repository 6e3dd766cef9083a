"""Matrix-free linear-elasticity SIPG apply (vector-valued fields).

Port of ``hpdg_tpu.matrixfree.elasticity``: the
traction-consistent SIPG elasticity operator of
``assemble.elasticity`` as a batched apply.  Strains are evaluated at
the volume quadrature points, tractions and jumps at the face points,
and everything is integrated back through the transposed tables.
Component-major layout (dof = c (p+1)^dim + i), mixed degrees, hanging
faces through the plan's face groups, both penalty scalings.  On meshes
with first-class geometry the per-point tables of
:func:`elasticity_geom_tables` are built on the host and uploaded once
at operator build.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble.plan import (AssemblyPlan, boundary_penalty_coef,
                                          boundary_phys_points, build_plan,
                                          face_group_tables, face_phys_points,
                                          penalty_coef)
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.mesh import geometry as geo
from hpdg_tpu_torch.mesh.structured import require_classic_faces


def elasticity_geom_tables(basis: DGBasis, plan: AssemblyPlan | None = None,
                           penalty: float = 2.0, dirichlet: bool = False,
                           penalty_scaling: str = "measure") -> dict:
    """Per-point geometry tables of the elasticity operator as a plain
    dict of numpy arrays: everything in the operator that depends on
    the element maps (and nothing that depends only on the parametric
    lattice).  Keys:

    * ``bulk[p] = (H, dA)``: H[n,q,b,a] = (1/h_b) J^-1 (local-parametric
      derivative b -> physical derivative a), dA[n,q] = |det J|;
    * ``face[i] = (H_in, H_out, R_in, R_out, pen)`` per face group:
      R[n,q,a] = |det J| J^-1[ax,a] is the Nanson covector, ``pen`` the
      per-face penalty coefficient;
    * ``bnd[i] = (H, R, pen)`` per Dirichlet boundary group (outward R).
    """
    plan = plan or build_plan(basis)
    mesh = basis.mesh
    d = mesh.dim

    def h_and_det(elems, xpq):
        Ji, dA = geo.pullback_factors(mesh, elems, xpq)
        H = (1.0 / mesh.extent[elems])[:, None, :, None] * Ji
        return H, Ji, dA

    bulk = {}
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, d, p + 2, family=basis.family)
        elems = basis.bucket_elems[p]
        xpq = (mesh.lower[elems][:, None, :]
               + vt["points"][None, :, :] * mesh.extent[elems][:, None, :])
        H, _, dA = h_and_det(elems, xpq)
        bulk[p] = (H, dA)

    face = []
    for fg in plan.face_groups:
        pmax = max(fg.p_in, fg.p_out)
        fin, _ = face_group_tables(basis, fg, pmax + 2)
        xpq = face_phys_points(basis, fg, fin["points"])
        xpq_o = face_phys_points(basis, fg, fin["points"], side="out")
        Hi, Jii, dAi = h_and_det(mesh.faces.inside[fg.face_ids], xpq)
        Ho, Jio, dAo = h_and_det(mesh.faces.outside[fg.face_ids], xpq_o)
        pen = geo.penalty_coef_mesh(mesh, fg, penalty, pmax,
                                    penalty_scaling)
        face.append((Hi, Ho, dAi[..., None] * Jii[:, :, fg.axis, :],
                     dAo[..., None] * Jio[:, :, fg.axis, :], pen))

    bnd = []
    if dirichlet:
        for bg in plan.boundary_groups:
            ft = tensor.face_tables(bg.p, d, bg.axis, bg.side, bg.p + 2,
                                    family=basis.family)
            sign = 1.0 if bg.side == 1 else -1.0
            xpq = boundary_phys_points(basis, bg, ft["points"])
            H, Ji, dA = h_and_det(mesh.bfaces.elem[bg.face_ids], xpq)
            pen = geo.boundary_penalty_coef_mesh(mesh, bg, penalty,
                                                 penalty_scaling)
            # outward Nanson covector
            bnd.append((H, sign * dA[..., None] * Ji[:, :, bg.axis, :], pen))
    return {"bulk": bulk, "face": tuple(face), "bnd": tuple(bnd)}


def elasticity_operator(basis: DGBasis, mu: float = 1.0, lam: float = 1.0,
                        penalty: float = 2.0, dirichlet: bool = False,
                        dtype=torch.float64, plan: AssemblyPlan | None = None,
                        penalty_scaling: str = "measure",
                        include_bulk: bool = True, device=None):
    """Returns ``apply: {p: [n_p, dim (p+1)^dim]} -> same`` on
    ``device``.  ``include_bulk=False`` gives the skeleton and boundary
    terms only."""
    mesh = basis.mesh
    require_classic_faces(mesh, "elasticity_operator")
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    if geo.has_geometry(mesh):
        return _elasticity_operator_geom(basis, mu, lam, penalty, dirichlet,
                                         dtype, plan, penalty_scaling,
                                         include_bulk, device)
    d = mesh.dim
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    ix = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                   device=device)
    eye = torch.eye(d, dtype=dtype, device=device)

    # bulk: per bucket G [d, nl, q], the quadrature weight times detJ
    # per element and point, and 1/h per element and axis
    bulk = {}
    for p in basis.bucket_degrees if include_bulk else ():
        vt = tensor.volume_tables(p, d, p + 2, family=basis.family)
        ext = mesh.extent[basis.bucket_elems[p]]
        detJ = np.prod(ext, axis=1)
        bulk[p] = (J(vt["G"]), J(detJ[:, None] * vt["weights"][None, :]),
                   J(1.0 / ext))

    fgroups = []
    for fg in plan.face_groups:
        pmax = max(fg.p_in, fg.p_out)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        w = fin["weights"]
        pen = penalty_coef(fg, penalty, pmax, penalty_scaling)
        fgroups.append(dict(
            fg=fg, in_pos=ix(fg.in_pos), out_pos=ix(fg.out_pos),
            Vi=J(fin["V"]), Vo=J(fout["V"]),
            Di=J(fin["Dall"]), Do=J(fout["Dall"]),  # (d, nl, q)
            zw=J(fg.fmeas[:, None, None] * w[None, :, None]),
            penw=J(pen[:, None, None] * w[None, :, None]),
            ih_in=J(1.0 / mesh.extent[mesh.faces.inside[fg.face_ids]]),
            ih_out=J(1.0 / mesh.extent[mesh.faces.outside[fg.face_ids]])))

    bgroups = []
    if dirichlet:
        for bg in plan.boundary_groups:
            ft = tensor.face_tables(bg.p, d, bg.axis, bg.side, bg.p + 2,
                                    family=basis.family)
            w = ft["weights"]
            pen = boundary_penalty_coef(bg, penalty, penalty_scaling)
            sign = 1.0 if bg.side == 1 else -1.0
            bgroups.append(dict(
                bg=bg, pos=ix(bg.pos), V=J(ft["V"]), Dall=J(ft["Dall"]),
                zw=J(bg.fmeas[:, None, None] * w[None, :, None]),
                penw=J(pen[:, None, None] * w[None, :, None]), sign=sign,
                ih=J(1.0 / mesh.extent[mesh.bfaces.elem[bg.face_ids]])))

    def traction(du, ax):
        """(sigma(u) n)_c from du[..., b, c] = d_b u_c, n = +e_ax."""
        div = torch.diagonal(du, dim1=-2, dim2=-1).sum(-1)[..., None]
        t = mu * (du[..., ax, :] + du[..., :, ax])
        return t + lam * div * eye[ax]

    def test_tensor(jmp, ax):
        """T[..., b, c] with sum_bc T_bc d_b v_c = [u].(sigma(v) e_ax)."""
        T = torch.zeros(jmp.shape[:2] + (d, d), dtype=dtype, device=device)
        T[..., ax, :] += mu * jmp
        T[..., :, ax] += mu * jmp
        return T + lam * jmp[..., ax][..., None, None] * eye

    def apply(x):
        y = {p: torch.zeros_like(x[p]) for p in x} if not include_bulk \
            else {}
        # bulk: 2 mu eps(u):eps(v) + lam div u div v
        for p, (G, wdet, ih) in bulk.items():
            nl = G.shape[1]
            u = x[p].reshape(-1, d, nl)
            du = torch.einsum("ncj,bjq->nqbc", u, G) * ih[:, None, :, None]
            eps = 0.5 * (du + du.transpose(-2, -1))
            div = torch.diagonal(du, dim1=-2, dim2=-1).sum(-1)
            sig = 2 * mu * eps + lam * div[..., None, None] * eye
            sw = sig * wdet[:, :, None, None] * ih[:, None, :, None]
            y[p] = torch.einsum("nqbc,bjq->ncj", sw, G).reshape(u.shape[0],
                                                                d * nl)

        for g in fgroups:
            fg, ax = g["fg"], g["fg"].axis
            nli, nlo = g["Vi"].shape[0], g["Vo"].shape[0]
            u_in = x[fg.p_in][g["in_pos"]].reshape(-1, d, nli)
            u_out = x[fg.p_out][g["out_pos"]].reshape(-1, d, nlo)
            jump = torch.einsum("nci,iq->nqc", u_in, g["Vi"]) \
                - torch.einsum("nci,iq->nqc", u_out, g["Vo"])
            duin = torch.einsum("nci,biq->nqbc", u_in, g["Di"]) \
                * g["ih_in"][:, None, :, None]
            duout = torch.einsum("nci,biq->nqbc", u_out, g["Do"]) \
                * g["ih_out"][:, None, :, None]
            t_avg = 0.5 * (traction(duin, ax) + traction(duout, ax))
            # value-type terms (test function values), then the
            # gradient-type term -1/2 [u].(sigma(v) n)
            zw, penw = g["zw"], g["penw"]
            Tj = test_tensor(jump, ax) * (-0.5 * zw[..., None])
            y_in = torch.einsum("nqc,iq->nci", penw * jump - zw * t_avg,
                                g["Vi"]) \
                + torch.einsum("nqbc,biq->nci",
                               Tj * g["ih_in"][:, None, :, None], g["Di"])
            y_out = torch.einsum("nqc,iq->nci", zw * t_avg - penw * jump,
                                 g["Vo"]) \
                + torch.einsum("nqbc,biq->nci",
                               Tj * g["ih_out"][:, None, :, None], g["Do"])
            y[fg.p_in] = y[fg.p_in].index_add(
                0, g["in_pos"], y_in.reshape(-1, d * nli))
            y[fg.p_out] = y[fg.p_out].index_add(
                0, g["out_pos"], y_out.reshape(-1, d * nlo))

        for g in bgroups:
            bg, ax = g["bg"], g["bg"].axis
            nl = g["V"].shape[0]
            u = x[bg.p][g["pos"]].reshape(-1, d, nl)
            uq = torch.einsum("nci,iq->nqc", u, g["V"])
            du = torch.einsum("nci,biq->nqbc", u, g["Dall"]) \
                * g["ih"][:, None, :, None]
            tv = g["penw"] * uq - g["zw"] * (g["sign"] * traction(du, ax))
            tg = test_tensor(uq, ax) * (-g["zw"][..., None]) \
                * (g["sign"] * g["ih"])[:, None, :, None]
            yb = torch.einsum("nqc,iq->nci", tv, g["V"]) \
                + torch.einsum("nqbc,biq->nci", tg, g["Dall"])
            y[bg.p] = y[bg.p].index_add(0, g["pos"], yb.reshape(-1, d * nl))
        return y

    return apply


def _elasticity_operator_geom(basis, mu, lam, penalty, dirichlet, dtype,
                              plan, penalty_scaling, include_bulk, device):
    """:func:`elasticity_operator` on a mesh with first-class geometry:
    physical gradients through the per-point ``H`` tables, co-normal
    tractions ``g sigma(u) n_phys`` through the Nanson covectors ``R``
    (the parametric face measure stays in the quadrature weight)."""
    mesh = basis.mesh
    d = mesh.dim
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    ix = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                   device=device)
    eye = torch.eye(d, dtype=dtype, device=device)
    gt = elasticity_geom_tables(basis, plan, penalty=penalty,
                                dirichlet=dirichlet,
                                penalty_scaling=penalty_scaling)

    bulk = {}
    for p in basis.bucket_degrees if include_bulk else ():
        vt = tensor.volume_tables(p, d, p + 2, family=basis.family)
        detJ = np.prod(mesh.extent[basis.bucket_elems[p]], axis=1)
        H, dA = gt["bulk"][p]
        bulk[p] = (J(vt["G"]),
                   J(detJ[:, None] * vt["weights"][None, :] * dA), J(H))

    fgroups = []
    for fg, (Hi, Ho, Ri, Ro, pen) in zip(plan.face_groups, gt["face"]):
        pmax = max(fg.p_in, fg.p_out)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        w = fin["weights"]
        fgroups.append(dict(
            fg=fg, in_pos=ix(fg.in_pos), out_pos=ix(fg.out_pos),
            Vi=J(fin["V"]), Vo=J(fout["V"]),
            Di=J(fin["Dall"]), Do=J(fout["Dall"]),  # (d, nl, q)
            zw=J(fg.fmeas[:, None] * w[None, :]),
            penw=J(pen[:, None, None] * w[None, :, None]),
            Hi=J(Hi), Ho=J(Ho), Ri=J(Ri), Ro=J(Ro)))

    bgroups = []
    if dirichlet:
        for bg, (H, R, pen) in zip(plan.boundary_groups, gt["bnd"]):
            ft = tensor.face_tables(bg.p, d, bg.axis, bg.side, bg.p + 2,
                                    family=basis.family)
            w = ft["weights"]
            bgroups.append(dict(
                bg=bg, pos=ix(bg.pos), V=J(ft["V"]), Dall=J(ft["Dall"]),
                zw=J(bg.fmeas[:, None] * w[None, :]),
                penw=J(pen[:, None, None] * w[None, :, None]),
                H=J(H), R=J(R)))
    del gt  # the device copies are all the apply reads

    def sig_of(du):
        eps = 0.5 * (du + du.transpose(-2, -1))
        div = torch.diagonal(du, dim1=-2, dim2=-1).sum(-1)
        return 2 * mu * eps + lam * div[..., None, None] * eye

    def test_gradient_term(jmp, zw, D, H, R):
        """``[nf, d, nl]``: sum_q zw [u].(g sigma(phi_i e_c) n_phys) with
        P[n,q,c,i] = (d_c phi_i)_phys and Q = R.P."""
        P = torch.einsum("biq,nqbc->nqci", D, H)
        Q = torch.einsum("nqc,nqci->nqi", R, P)
        A1 = torch.einsum("nqk,nqki->nqi", jmp, P)
        return (mu * torch.einsum("nq,nqc,nqi->nci", zw, R, A1)
                + mu * torch.einsum("nq,nqc,nqi->nci", zw, jmp, Q)
                + lam * torch.einsum("nq,nqci->nci",
                                     zw * (jmp * R).sum(-1), P))

    def apply(x):
        y = {p: torch.zeros_like(x[p]) for p in x} if not include_bulk \
            else {}
        for p, (G, wdet, H) in bulk.items():
            nl = G.shape[1]
            u = x[p].reshape(-1, d, nl)
            # du[n, q, a, c] = physical d_a u_c at the quadrature points
            du = torch.einsum("nqbc,nqba->nqac",
                              torch.einsum("ncj,bjq->nqbc", u, G), H)
            sw = sig_of(du) * wdet[:, :, None, None]
            y[p] = torch.einsum(
                "nqbc,bjq->ncj", torch.einsum("nqac,nqba->nqbc", sw, H),
                G).reshape(u.shape[0], d * nl)

        for g in fgroups:
            fg = g["fg"]
            nli, nlo = g["Vi"].shape[0], g["Vo"].shape[0]
            u_in = x[fg.p_in][g["in_pos"]].reshape(-1, d, nli)
            u_out = x[fg.p_out][g["out_pos"]].reshape(-1, d, nlo)
            jump = torch.einsum("nci,iq->nqc", u_in, g["Vi"]) \
                - torch.einsum("nci,iq->nqc", u_out, g["Vo"])
            duin = torch.einsum("nci,biq,nqba->nqac", u_in, g["Di"],
                                g["Hi"])
            duout = torch.einsum("nci,biq,nqba->nqac", u_out, g["Do"],
                                 g["Ho"])
            t_avg = 0.5 * (
                torch.einsum("nqa,nqac->nqc", g["Ri"], sig_of(duin))
                + torch.einsum("nqa,nqac->nqc", g["Ro"], sig_of(duout)))
            zw, penw = g["zw"], g["penw"]
            zw3 = zw[..., None]
            y_in = torch.einsum("nqc,iq->nci", penw * jump - zw3 * t_avg,
                                g["Vi"]) \
                - 0.5 * test_gradient_term(jump, zw, g["Di"], g["Hi"],
                                           g["Ri"])
            y_out = torch.einsum("nqc,iq->nci", zw3 * t_avg - penw * jump,
                                 g["Vo"]) \
                - 0.5 * test_gradient_term(jump, zw, g["Do"], g["Ho"],
                                           g["Ro"])
            y[fg.p_in] = y[fg.p_in].index_add(
                0, g["in_pos"], y_in.reshape(-1, d * nli))
            y[fg.p_out] = y[fg.p_out].index_add(
                0, g["out_pos"], y_out.reshape(-1, d * nlo))

        for g in bgroups:
            bg = g["bg"]
            nl = g["V"].shape[0]
            u = x[bg.p][g["pos"]].reshape(-1, d, nl)
            uq = torch.einsum("nci,iq->nqc", u, g["V"])
            du = torch.einsum("nci,biq,nqba->nqac", u, g["Dall"], g["H"])
            t_full = torch.einsum("nqa,nqac->nqc", g["R"], sig_of(du))
            tv = g["penw"] * uq - g["zw"][..., None] * t_full
            yb = torch.einsum("nqc,iq->nci", tv, g["V"]) \
                - test_gradient_term(uq, g["zw"], g["Dall"], g["H"], g["R"])
            y[bg.p] = y[bg.p].index_add(0, g["pos"], yb.reshape(-1, d * nl))
        return y

    return apply


def elasticity_diagonal_blocks(basis: DGBasis, mu: float = 1.0,
                               lam: float = 1.0, penalty: float = 6.0,
                               dirichlet: bool = False, dtype=torch.float64,
                               device=None) -> dict:
    """p -> [n_p, dim bs, dim bs] diagonal (vector) blocks of the SIPG
    elasticity operator, for matrix-free block-Jacobi smoothing (taken
    from the assembled matrix on ``device``)."""
    from hpdg_tpu_torch.assemble.elasticity import assemble_elasticity
    from hpdg_tpu_torch.linalg.blockmatrix import extract_diagonal
    require_classic_faces(basis.mesh, "elasticity_diagonal_blocks")
    A = assemble_elasticity(basis, mu=mu, lam=lam, penalty=penalty,
                            dirichlet=dirichlet, dtype=dtype, device=device)
    return extract_diagonal(A)
