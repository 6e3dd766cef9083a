"""Batched SIPG assembly for linear elasticity (vector-valued blocks).

Port of ``hpdg_tpu.assemble.elasticity`` on box meshes (BASELINE
config 4).  Bilinear form: a(u,v) = ∫ 2 mu eps(u):eps(v) + lam (div u)
(div v) plus SIPG skeleton terms with traction averages {sigma(u) n},
vector jumps [u] and the scalar assembler's penalty conventions.  Local
dof ordering is component-major (dof = c (p+1)^dim + i), so p- and
h-transfer blocks act on the node index only.

The blocks are built on the device, in ``dtype``, as batched tensors per
degree bucket and face group, and added into the value buffers with one
``index_add_`` per contribution kind and group.  Inside each call every
target block appears once, so the sums are deterministic, and elements
that see the same faces and boundary get bitwise equal blocks (what the
class-deduplicated patch smoother checks).  Meshes with first-class
geometry (affine, trilinear) wait for ROADMAP queue 1, item 19.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble.plan import (AssemblyPlan, boundary_penalty_coef,
                                          build_plan, face_group_tables,
                                          penalty_coef)
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg.blockmatrix import BlockSparseMatrix, zeros_values
from hpdg_tpu_torch.mesh.structured import (require_box_geometry,
                                            require_classic_faces)


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
    require_box_geometry(mesh, "assemble_elasticity")
    device = dev.resolve(device)
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
        x = (mesh.lower[elems][:, None, :]
             + vt["points"][None, :, :] * ext[:, None, :])
        fv = f(J(x)).to(dtype)  # (n, nq, d)
        fw = fv * J(vt["weights"])[None, :, None] \
            * J(np.prod(ext, axis=1))[:, None, None]
        b = torch.einsum("eqc,iq->eci", fw, J(vt["V"]))
        out[p] = b.reshape(len(elems), d * (p + 1) ** d)
    return out
