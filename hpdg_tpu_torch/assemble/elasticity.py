"""Batched SIPG assembly for linear elasticity (vector-valued blocks).

Port of ``hpdg_tpu.assemble.elasticity`` (BASELINE config 4 on box
meshes; per-point Jacobians on meshes with first-class geometry).  Bilinear form: a(u,v) = ∫ 2 mu eps(u):eps(v) + lam (div u)
(div v) plus SIPG skeleton terms with traction averages {sigma(u) n},
vector jumps [u] and the scalar assembler's penalty conventions.  Local
dof ordering is component-major (dof = c (p+1)^dim + i), so p- and
h-transfer blocks act on the node index only.

The blocks are built on the device, in ``dtype``, as batched tensors per
degree bucket and face group, and added into the value buffers with one
``index_add_`` per contribution kind and group.  Inside each call every
target block appears once, so the sums are deterministic, and elements
that see the same faces and boundary get bitwise equal blocks (what the
class-deduplicated patch smoother checks).
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble.plan import (AssemblyPlan, boundary_penalty_coef,
                                          boundary_phys_points, build_plan,
                                          face_group_tables, face_phys_points,
                                          penalty_coef)
from hpdg_tpu_torch.assemble.rhs import volume_detj
from hpdg_tpu_torch.assemble.sipg import chunked_over_elements
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg.blockmatrix import BlockSparseMatrix, zeros_values
from hpdg_tpu_torch.mesh import geometry as geo
from hpdg_tpu_torch.mesh.structured import require_classic_faces


def _traction_blocks(d, ax, mu, lam, zA, zB, ihA, ihB, FVD, FDV, FVV, penf,
                     J):
    """``[nf, d, nlA, d, nlB]`` face blocks (test side A, trial side B):
    the traction averages of both sides (``zA``/``zB`` per face with the
    jump signs and the face measure folded in, ``ihA``/``ihB`` the
    [nf, d] inverse extents) and the penalty ``penf`` times FVV."""
    nf = zA.shape[0]
    nlA, nlB = FVV.shape
    out = torch.zeros((nf, d, nlA, d, nlB), dtype=zA.dtype, device=zA.device)
    FVD, FDV, FVV = J(FVD), J(FDV), J(FVV)
    col = lambda a: a[:, None, None]  # noqa: E731
    for c in range(d):
        for e in range(d):
            M = torch.zeros((nf, nlA, nlB), dtype=zA.dtype, device=zA.device)
            # trial-side traction {sigma(u) n}_c against v_A
            if c == e:
                M += col(zA * mu * ihB[:, ax]) * FVD[ax]
            if e == ax:
                M += col(zA * mu * ihB[:, c]) * FVD[c]
            if c == ax:
                M += col(zA * lam * ihB[:, e]) * FVD[e]
            # test-side traction {sigma(v) n}_e against u_B
            if c == e:
                M += col(zB * mu * ihA[:, ax]) * FDV[ax]
            if c == ax:
                M += col(zB * mu * ihA[:, e]) * FDV[e]
            if e == ax:
                M += col(zB * lam * ihA[:, c]) * FDV[c]
            if c == e:
                M += col(penf) * FVV
            out[:, c, :, e, :] = M
    return out


def assemble_elasticity(basis: DGBasis, mu: float = 1.0, lam: float = 1.0,
                        penalty: float = 2.0, dirichlet: bool = False,
                        dtype=torch.float64, plan: AssemblyPlan | None = None,
                        penalty_scaling: str = "measure", device=None
                        ) -> BlockSparseMatrix:
    """The elasticity SIPG matrix with ``block_shape = (dim, dim)``."""
    mesh = basis.mesh
    require_classic_faces(mesh, "assemble_elasticity")
    device = dev.resolve(device)
    if geo.has_geometry(mesh):
        return _assemble_elasticity_geom(basis, mu, lam, penalty, dirichlet,
                                         dtype, plan, penalty_scaling,
                                         device)
    plan = plan or build_plan(basis)
    d = mesh.dim
    vals = zeros_values(plan.pattern, d, block_shape=(d, d), dtype=dtype,
                        device=device)
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    ix = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                   device=device)

    # ---------------- bulk ----------------
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, d, p + 2, family=basis.family)
        G, w = vt["G"], vt["weights"]
        nl = (p + 1) ** d
        SS = J(np.einsum("q,aiq,bjq->abij", w, G, G))  # (d, d, nl, nl)
        ext = mesh.extent[basis.bucket_elems[p]]
        detJ = np.prod(ext, axis=1)
        g = J(detJ[:, None, None] / (ext[:, :, None] * ext[:, None, :]))
        n = len(ext)
        # mu delta_ce sum_a g_aa S_aa + mu g_ec S_ec + lam g_ce S_ce
        lap = torch.einsum("na,aij->nij", torch.diagonal(g, dim1=1, dim2=2),
                           torch.diagonal(SS, dim1=0, dim2=1).permute(2, 0, 1))
        blk = (mu * torch.einsum("nec,ecij->nciej", g, SS)
               + lam * torch.einsum("nce,ceij->nciej", g, SS))
        for c in range(d):
            blk[:, c, :, c, :] += mu * lap
        vals[(p, p)][:n] += blk.reshape(n, d * nl, d * nl)

    # ---------------- interior faces ----------------
    for fg in plan.face_groups:
        pi, po, ax = fg.p_in, fg.p_out, fg.axis
        pmax = max(pi, po)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        w = fin["weights"]
        pen = J(penalty_coef(fg, penalty, pmax, penalty_scaling))
        ein = mesh.faces.inside[fg.face_ids]
        eout = mesh.faces.outside[fg.face_ids]
        IH = {1.0: J(1.0 / mesh.extent[ein]),  # keyed by jump sign
              -1.0: J(1.0 / mesh.extent[eout])}
        tabs = {1.0: fin, -1.0: fout}
        fmeas = J(fg.fmeas)
        nf = len(fg.face_ids)

        def face_blocks(sA, sB):
            TA, TB = tabs[sA], tabs[sB]
            FVD = np.einsum("iq,q,bjq->bij", TA["V"], w, TB["Dall"])
            FDV = np.einsum("biq,q,jq->bij", TA["Dall"], w, TB["V"])
            FVV = np.einsum("iq,q,jq->ij", TA["V"], w, TB["V"])
            out = _traction_blocks(d, ax, mu, lam, -0.5 * sA * fmeas,
                                   -0.5 * sB * fmeas, IH[sA], IH[sB],
                                   FVD, FDV, FVV, (sA * sB) * pen, J)
            return out.reshape(nf, d * TA["V"].shape[0],
                               d * TB["V"].shape[0])

        vals[(pi, pi)].index_add_(0, ix(fg.in_pos), face_blocks(1.0, 1.0))
        vals[(po, po)].index_add_(0, ix(fg.out_pos), face_blocks(-1.0, -1.0))
        vals[(pi, po)].index_add_(0, ix(fg.slot12), face_blocks(1.0, -1.0))
        vals[(po, pi)].index_add_(0, ix(fg.slot21), face_blocks(-1.0, 1.0))

    # ---------------- Dirichlet boundary ----------------
    if dirichlet:
        for bg in plan.boundary_groups:
            p, ax, side = bg.p, bg.axis, bg.side
            sgn = 1.0 if side == 1 else -1.0
            ft = tensor.face_tables(p, d, ax, side, p + 2,
                                    family=basis.family)
            w = ft["weights"]
            nl = (p + 1) ** d
            pen = J(boundary_penalty_coef(bg, penalty, penalty_scaling))
            elems = mesh.bfaces.elem[bg.face_ids]
            ih = J(sgn / mesh.extent[elems])  # signed normal-derivative scale
            z = -J(bg.fmeas)
            FVD = np.einsum("iq,q,bjq->bij", ft["V"], w, ft["Dall"])
            FDV = np.einsum("biq,q,jq->bij", ft["Dall"], w, ft["V"])
            FVV = np.einsum("iq,q,jq->ij", ft["V"], w, ft["V"])
            # full (not halved) consistency terms on both sides
            out = _traction_blocks(d, ax, mu, lam, z, z, ih, ih, FVD, FDV,
                                   FVV, pen, J)
            vals[(p, p)].index_add_(0, ix(bg.pos),
                                    out.reshape(len(elems), d * nl, d * nl))

    return BlockSparseMatrix(plan.pattern, d, vals, block_shape=(d, d))


def elasticity_point_tables(mesh, elems, xpq, Dall, ax=None, sign=1.0):
    """Host numpy per-point tables of the elasticity pullback at the
    GLOBAL parametric points ``xpq`` (n, q, d) of ``elems``:

    * ``P[n,q,a,i] = sum_m Dall[m,i,q] / h_m  Jinv[n,q,m,a]``, the
      physical derivative a of local basis function i (``Dall``: the
      (d, nl, q) element-local derivative tables),
    * ``dA[n,q] = |det J|``,
    * with a face axis ``ax``: the Nanson covector
      ``R[n,q,b] = sign |det J| Jinv[n,q,ax,b]`` and ``Q = R . P``.
    """
    Ji, dA = geo.pullback_factors(mesh, elems, xpq)
    ih = 1.0 / mesh.extent[elems]
    P = np.einsum("miq,nm,nqma->nqai", Dall, ih, Ji)
    if ax is None:
        return P, dA
    R = sign * dA[..., None] * Ji[:, :, ax, :]
    return P, R, np.einsum("nqb,nqbj->nqj", R, P)


def _traction(P, R, Q, mu, lam):
    """``T[n,q,c,b,j] = mu R_b P[c,j] + mu delta_cb Q[j] + lam R_c P[b,j]``:
    the co-normal traction operator ``g sigma(.) n_phys`` per point."""
    T = (mu * torch.einsum("nqb,nqcj->nqcbj", R, P)
         + lam * torch.einsum("nqc,nqbj->nqcbj", R, P))
    for c in range(P.shape[2]):
        T[:, :, c, c, :] += mu * Q
    return T


def _assemble_elasticity_geom(basis: DGBasis, mu, lam, penalty, dirichlet,
                              dtype, plan, penalty_scaling, device
                              ) -> BlockSparseMatrix:
    """Elasticity assembly on meshes with first-class geometry (affine /
    trilinear Q1): per-quad-point Jacobians through the pullback.

    The geometry tables (:func:`elasticity_point_tables`) are built on
    the host and uploaded once; the block einsums run on ``device``.
    Pointwise, ``g (sigma(u) n_phys)_c = mu R_b D_c u_b + mu (R.Dhat) u_c
    + lam R_c div u`` keeps the PARAMETRIC face measure in the quadrature
    weight, exactly as the scalar path (``mesh/geometry.py``)."""
    plan = plan or build_plan(basis)
    mesh = basis.mesh
    d = mesh.dim
    vals = zeros_values(plan.pattern, d, block_shape=(d, d), dtype=dtype,
                        device=device)
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    ix = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                   device=device)

    # ---------------- bulk ----------------
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, d, p + 2, family=basis.family)
        nl = (p + 1) ** d
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        xpq = (mesh.lower[elems][:, None, :]
               + vt["points"][None, :, :] * ext[:, None, :])
        P, dA = elasticity_point_tables(mesh, elems, xpq, vt["G"])
        wdet = vt["weights"][None, :] * np.prod(ext, axis=1)[:, None] * dA

        def bulk(P, wdet):
            wP = wdet[:, :, None, None] * P
            A1 = torch.einsum("nqai,nqaj->nij", wP, P)
            blk = (mu * torch.einsum("nqei,nqcj->nciej", wP, P)
                   + lam * torch.einsum("nqci,nqej->nciej", wP, P))
            for c in range(d):
                blk[:, c, :, c, :] += mu * A1
            return blk.reshape(len(P), d * nl, d * nl)

        n = basis.bucket_size(p)
        vals[(p, p)][:n] += chunked_over_elements(
            bulk, n, 3 * (d * nl) ** 2 * J(0.0).element_size(),
            J(P), J(wdet))

    # ---------------- interior faces ----------------
    for fg in plan.face_groups:
        pi, po, ax = fg.p_in, fg.p_out, fg.axis
        pmax = max(pi, po)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        w = fin["weights"]
        pen = J(geo.penalty_coef_mesh(mesh, fg, penalty, pmax,
                                      penalty_scaling))
        ein = mesh.faces.inside[fg.face_ids]
        eout = mesh.faces.outside[fg.face_ids]
        xpq = face_phys_points(basis, fg, fin["points"])
        xpq_o = face_phys_points(basis, fg, fin["points"], side="out")
        sides = {}
        for sgn, elems, tab, xq in ((1.0, ein, fin, xpq),
                                    (-1.0, eout, fout, xpq_o)):
            P, R, Q = (J(a) for a in elasticity_point_tables(
                mesh, elems, xq, tab["Dall"], ax=ax))
            sides[sgn] = dict(V=tab["V"], Vt=J(tab["V"]),
                              T=_traction(P, R, Q, mu, lam))
        nf = len(fg.face_ids)
        zw = J(np.asarray(fg.fmeas)[:, None] * w[None, :])  # (nf, q)

        def face_blocks(sA, sB):
            A_, B_ = sides[sA], sides[sB]
            nlA, nlB = A_["V"].shape[0], B_["V"].shape[0]
            M = (-0.5 * sA * torch.einsum("nq,iq,nqcej->nciej",
                                          zw, A_["Vt"], B_["T"])
                 - 0.5 * sB * torch.einsum("nq,jq,nqeci->nciej",
                                           zw, B_["Vt"], A_["T"]))
            FVV = J(np.einsum("iq,q,jq->ij", A_["V"], w, B_["V"]))
            penf = (sA * sB) * pen
            for c in range(d):
                M[:, c, :, c, :] += penf[:, None, None] * FVV[None]
            return M.reshape(nf, d * nlA, d * nlB)

        vals[(pi, pi)].index_add_(0, ix(fg.in_pos), face_blocks(1.0, 1.0))
        vals[(po, po)].index_add_(0, ix(fg.out_pos), face_blocks(-1.0, -1.0))
        vals[(pi, po)].index_add_(0, ix(fg.slot12), face_blocks(1.0, -1.0))
        vals[(po, pi)].index_add_(0, ix(fg.slot21), face_blocks(-1.0, 1.0))

    # ---------------- Dirichlet boundary ----------------
    if dirichlet:
        for bg in plan.boundary_groups:
            p, ax, side = bg.p, bg.axis, bg.side
            sgn = 1.0 if side == 1 else -1.0
            ft = tensor.face_tables(p, d, ax, side, p + 2,
                                    family=basis.family)
            w = ft["weights"]
            nl = (p + 1) ** d
            pen = J(geo.boundary_penalty_coef_mesh(mesh, bg, penalty,
                                                   penalty_scaling))
            elems = mesh.bfaces.elem[bg.face_ids]
            xpq = boundary_phys_points(basis, bg, ft["points"])
            P, R, Q = (J(a) for a in elasticity_point_tables(
                mesh, elems, xpq, ft["Dall"], ax=ax, sign=sgn))  # outward
            T = _traction(P, R, Q, mu, lam)
            zw = J(w[None, :] * np.asarray(bg.fmeas)[:, None])
            V = J(ft["V"])
            M = (-torch.einsum("nq,iq,nqcej->nciej", zw, V, T)
                 - torch.einsum("nq,jq,nqeci->nciej", zw, V, T))
            FVV = J(np.einsum("iq,q,jq->ij", ft["V"], w, ft["V"]))
            for c in range(d):
                M[:, c, :, c, :] += pen[:, None, None] * FVV[None]
            vals[(p, p)].index_add_(
                0, ix(bg.pos), M.reshape(len(elems), d * nl, d * nl))

    return BlockSparseMatrix(plan.pattern, d, vals, block_shape=(d, d))


def l2_functional_vec(basis: DGBasis, f, quad_order=None, dtype=torch.float64,
                      device=None) -> dict:
    """Vector load ``b_{(c,i)} = ∫ f_c phi_i``; ``f`` maps tensors of
    points (..., dim) to values (..., dim).  Component-major layout;
    box meshes."""
    device = dev.resolve(device)
    mesh = basis.mesh
    d = mesh.dim
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    out = {}
    for p in basis.bucket_degrees:
        order = quad_order if quad_order is not None else 2 * p + 2
        nq1 = max(1, (order + 2) // 2)
        vt = tensor.volume_tables(p, d, nq1, family=basis.family,
                                  quad_family="legendre")
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        xp = (mesh.lower[elems][:, None, :]
              + vt["points"][None, :, :] * ext[:, None, :])
        fv = f(J(geo.apply_map(mesh, elems, xp))).to(dtype)  # (n, nq, d)
        fw = fv * J(vt["weights"])[None, :, None] \
            * J(volume_detj(mesh, elems, xp))[:, :, None]
        b = torch.einsum("eqc,iq->eci", fw, J(vt["V"]))
        out[p] = b.reshape(len(elems), d * (p + 1) ** d)
    return out
