"""Sum-factorized matrix-free SIPG / Laplace / mass operators.

Port of ``hpdg_tpu.matrixfree.sumfact``, in any dimension, with mixed
degrees, 2:1 hanging faces and first-class geometry:

* the bulk term contracts each degree bucket with the 1D value and
  derivative tables one axis at a time (:func:`_chain`), O(d (p+1)^(d+1))
  per element and table, never an O((p+1)^(2d)) intermediate;
* the skeleton gathers both sides of every face group, evaluates the
  traces with the group's face tables (``assemble.plan
  .face_group_tables``, which maps the coarse side of a hanging face
  onto its sub-face), and lands ALL face and boundary contributions of a
  bucket with ONE ``index_add_``.

Every operator is a closure ``{p: Tensor[n_p, (p+1)^d]} -> {p: ...}``
whose constants live on ``device`` in ``dtype``.  Geometry folds into
per-point effective tensors (``mesh/geometry.py``) that are computed on
the host and uploaded ONCE at operator build; the apply never touches
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.assemble.plan import (AssemblyPlan, build_plan,
                                          boundary_phys_points,
                                          face_group_tables, face_phys_points,
                                          penalty_coef, boundary_penalty_coef)
from hpdg_tpu_torch.assemble.sipg import dg_theta, is_tensor_coefficient
from hpdg_tpu_torch.mesh import geometry as geo


def _chain(u: torch.Tensor, tables: list) -> torch.Tensor:
    """``u[n, i0, ..., i_{d-1}]`` contracted with ``tables[a][i_a, q_a]``
    on every axis -> ``[n, q0, ..., q_{d-1}]``, one axis at a time.

    Contracting the first spatial axis and appending the new one at the
    end brings the axes back in order after d steps."""
    for T in tables:
        u = torch.tensordot(u, T, dims=([1], [0]))
    return u


def _bucket_geometry(basis: DGBasis, p: int):
    ext = basis.mesh.extent[basis.bucket_elems[p]]
    return ext, np.prod(ext, axis=1)


def _medium(mesh, elems, xpq, diffusion, J):
    """The medium of one batch of points as a closure ``() -> k`` on the
    device: the user's ``diffusion`` evaluated at the physical image of
    the GLOBAL parametric points ``xpq`` (n, q, dim) of ``elems``, with
    the mesh's geometry folded in (``|det J| J^-1 K J^-T``).  Everything
    that does not depend on the apply's input is uploaded here; without
    ``diffusion`` the effective tensor is a constant."""
    affine = geo.has_affine(mesh)
    if diffusion is None:
        keff = J(geo.effective_tensor(mesh, elems, None, xpq))
        return lambda: keff
    xq = J(geo.apply_map(mesh, elems, xpq))
    if not affine:
        return lambda: diffusion(xq).to(xq.dtype)
    Ji, det = (J(a) for a in geo.pullback_factors(mesh, elems, xpq))
    return lambda: geo.fold_medium(Ji, det, diffusion(xq).to(xq.dtype))


def laplace_bulk_operator(basis: DGBasis, diffusion=None,
                          dtype=torch.float64, device=None):
    """Matrix-free (K grad u, grad v) over all elements.

    ``diffusion`` may return a scalar or a symmetric (dim, dim) TENSOR
    per point (anisotropic media); on meshes with geometry the pullback
    tensor is folded in."""
    device = dev.resolve(device)
    dim = basis.dim
    mesh = basis.mesh
    affine = geo.has_affine(mesh)
    kmat = affine or is_tensor_coefficient(diffusion, dim, dtype, device)
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    bshape = lambda v: v.reshape((-1,) + (1,) * dim)  # noqa: E731
    prep = {}
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, dim, p + 2, family=basis.family)
        t1 = vt["t1d"]
        ext, detJ = _bucket_geometry(basis, p)
        elems = basis.bucket_elems[p]
        wq = J(vt["weights"].reshape((len(t1.qweights),) * dim))
        V, D = J(t1.values), J(t1.derivatives)
        item = dict(V=V, D=D, Vt=V.T.contiguous(), Dt=D.T.contiguous(),
                    wq=wq)
        if diffusion is not None or affine:
            xpq = (mesh.lower[elems][:, None, :]
                   + vt["points"][None, :, :] * ext[:, None, :])
            item["k"] = _medium(mesh, elems, xpq, diffusion, J)
        if kmat:
            item["invh"] = [bshape(J(1.0 / ext[:, a])) for a in range(dim)]
            item["wdet"] = wq[None] * bshape(J(detJ))
        else:
            item["coef"] = [bshape(J(detJ / ext[:, a] ** 2))
                            for a in range(dim)]
        prep[p] = item

    def apply(x):
        y = {}
        for p, it in prep.items():
            shp = x[p].shape
            d1 = it["V"].shape[0]
            u = x[p].reshape((shp[0],) + (d1,) * dim)
            kq = it["k"]() if "k" in it else None
            tabs_f = lambda a: [it["D"] if c == a else it["V"]  # noqa: E731
                                for c in range(dim)]
            tabs_b = lambda a: [it["Dt"] if c == a else it["Vt"]  # noqa: E731
                                for c in range(dim)]
            out = 0.0
            if kmat:
                # tensor medium: all reference-gradient fields, mixed by
                # K per point: g_a = w detJ / (h_a h_b) sum_b K_ab du_b
                kq = kq.reshape((shp[0],) + it["wq"].shape + (dim, dim))
                dus = [_chain(u, tabs_f(b)) * it["invh"][b]
                       for b in range(dim)]
                for a in range(dim):
                    g = 0.0
                    for b in range(dim):
                        g = g + kq[..., a, b] * dus[b]
                    g = g * it["wdet"] * it["invh"][a]
                    out = out + _chain(g, tabs_b(a))
            else:
                if kq is not None:
                    kq = kq.reshape((shp[0],) + it["wq"].shape)
                for a in range(dim):
                    g = _chain(u, tabs_f(a)) * it["wq"][None]
                    if kq is not None:
                        g = g * kq
                    out = out + _chain(g * it["coef"][a], tabs_b(a))
            y[p] = out.reshape(shp)
        return y

    return apply


def mass_operator(basis: DGBasis, dtype=torch.float64, device=None):
    """Matrix-free (u, v): one dense block GEMM per bucket (per-element
    blocks on trilinear meshes, whose volume element varies per point)."""
    device = dev.resolve(device)
    mesh = basis.mesh
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    prep = {}
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, basis.dim, p + 2, family=basis.family)
        ext, detJ = _bucket_geometry(basis, p)
        elems = basis.bucket_elems[p]
        if geo.is_trilinear(mesh):
            xpq = (mesh.lower[elems][:, None, :]
                   + vt["points"][None, :, :] * ext[:, None, :])
            detq = detJ[:, None] * geo.detj_phys(mesh, elems, xpq)
            Me = np.einsum("eq,q,iq,jq->eij", detq, vt["weights"],
                           vt["V"], vt["V"])
            prep[p] = (J(Me), None)
        else:
            M0 = np.einsum("iq,q,jq->ij", vt["V"], vt["weights"], vt["V"])
            prep[p] = (J(M0), J(detJ * geo.detj_phys(mesh, elems))[:, None])

    def apply(x):
        return {p: (torch.einsum("ni,nij->nj", x[p], M) if detJ is None
                    else (x[p] @ M) * detJ)
                for p, (M, detJ) in prep.items()}

    return apply


def _conormal_rows(mesh, diffusion, J, *sides):
    """Closure ``() -> tuple`` of the signed conormal rows
    ``sign * k_eff[..., axis, :]`` (nf, q, dim), one per ``side =
    (elems, xpq, axis, sign)``.  Constant media (``diffusion is None``)
    keep only the rows on the device; a user medium is evaluated ONCE per
    apply at the inside points and shared by the sides."""
    if diffusion is None:
        rows = tuple(
            sgn * J(geo.effective_tensor(mesh, e, None, xpq)[..., ax, :])
            for e, xpq, ax, sgn in sides)
        return lambda: rows
    e0, xpq0 = sides[0][:2]
    xq = J(geo.apply_map(mesh, e0, xpq0))
    if not geo.has_affine(mesh):
        def plain():
            k = diffusion(xq).to(xq.dtype)
            return tuple(sgn * k[..., ax, :] for _, _, ax, sgn in sides)
        return plain
    fac = [tuple(J(a) for a in geo.pullback_factors(mesh, e, xpq))
           for e, xpq, _, _ in sides]

    def folded():
        k = diffusion(xq).to(xq.dtype)
        return tuple(
            sgn * geo.fold_medium(Ji, det, k)[..., ax, :]
            for (Ji, det), (_, _, ax, sgn) in zip(fac, sides))
    return folded


def _face_prep(basis: DGBasis, plan: AssemblyPlan):
    """Static (host numpy) per-face-group data for the skeleton terms."""
    groups = []
    for fg in plan.face_groups:
        pmax = max(fg.p_in, fg.p_out)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        groups.append(dict(
            fg=fg, w=fin["weights"], Vi=fin["V"], Di=fin["Dn"],
            Vo=fout["V"], Do=fout["Dn"], pmax=pmax, pts=fin["points"],
            Dalli=fin["Dall"], Dallo=fout["Dall"]))
    return groups


def sipg_operator(basis: DGBasis, penalty: float = 2.0,
                  dirichlet: bool = False, diffusion=None,
                  dtype=torch.float64, plan: AssemblyPlan | None = None,
                  penalty_scaling: str = "measure", dg_form="sipg",
                  sigma1: float = 0.0, device=None):
    """Full matrix-free IPDG apply (bulk + skeleton + Dirichlet terms),
    semantically identical to the ``assemble_laplace(...)`` matvec.

    ``dg_form``: "sipg" | "iipg" | "nipg" (or theta float) — symmetry
    factor of the consistency terms.  ``sigma1``: gradient-jump
    stabilization on interior faces.
    """
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    dim = basis.dim
    mesh = basis.mesh
    affine = geo.has_affine(mesh)
    kmat = affine or is_tensor_coefficient(diffusion, dim, dtype, device)
    theta = dg_theta(dg_form)
    bulk = laplace_bulk_operator(basis, diffusion=diffusion, dtype=dtype,
                                 device=device)
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    I = lambda a: torch.as_tensor(  # noqa: E731, E741
        np.asarray(a, np.int64), device=device)

    groups = []
    for g in _face_prep(basis, plan):
        fg = g["fg"]
        pen_w = ((geo.penalty_coef_mesh(mesh, fg, penalty, g["pmax"],
                                        penalty_scaling) if affine else
                  penalty_coef(fg, penalty, g["pmax"],
                               penalty_scaling))[:, None] * g["w"][None, :])
        ein = mesh.faces.inside[fg.face_ids]
        eout = mesh.faces.outside[fg.face_ids]
        t = dict(p_in=fg.p_in, p_out=fg.p_out,
                 in_pos=I(fg.in_pos), out_pos=I(fg.out_pos),
                 Vi=J(g["Vi"]), Di=J(g["Di"]), Vo=J(g["Vo"]), Do=J(g["Do"]),
                 ViT=J(g["Vi"].T), DiT=J(g["Di"].T), VoT=J(g["Vo"].T),
                 DoT=J(g["Do"].T), w=J(g["w"]),
                 zw=J(fg.fmeas[:, None] * g["w"][None, :]), pen_w=J(pen_w),
                 ihi=J(fg.inv_h_in)[:, None], iho=J(fg.inv_h_out)[:, None])
        if diffusion is not None or affine:
            xpq = face_phys_points(basis, fg, g["pts"])  # parametric
            xpq_out = face_phys_points(basis, fg, g["pts"], side="out")
        if diffusion is not None and not kmat:
            t["k"] = _medium(mesh, ein, xpq, diffusion, J)
        if kmat:
            # each side's conormal row along ITS chart's face axis,
            # signed so the parametric normal points inside -> outside
            # (twisted imports; the defaults keep +e_axis)
            t["Ka"] = _conormal_rows(
                mesh, diffusion, J,
                (ein, xpq, fg.axis, float(2 * fg.in_side - 1)),
                (eout, xpq_out, fg.out_axis, float(1 - 2 * fg.out_side)))
            t["ihv"] = J(1.0 / mesh.extent[ein])
            t["ohv"] = J(1.0 / mesh.extent[eout])
            t["Dalli"], t["Dallo"] = J(g["Dalli"]), J(g["Dallo"])
            if sigma1 != 0.0:
                sn_i, sn_o, zs = geo.face_grad_jump_geometry(
                    mesh, fg, xpq, xpq_out)
                zsw = zs * g["w"][None, :]
                t["s1_cw"] = J((sigma1 / zsw.sum(axis=1))[:, None] * zsw)
                t["s1_sn_in"], t["s1_sn_out"] = J(sn_i), J(sn_o)
        groups.append(t)

    bgroups = []
    if dirichlet:
        for bg in plan.boundary_groups:
            ft = tensor.face_tables(bg.p, dim, bg.axis, bg.side, bg.p + 2,
                                    family=basis.family)
            sign = 1.0 if bg.side == 1 else -1.0
            t = dict(p=bg.p, pos=I(bg.pos), sign=sign,
                     V=J(ft["V"]), D=J(ft["Dn"]), VT=J(ft["V"].T),
                     DT=J(ft["Dn"].T),
                     zw=J(bg.fmeas[:, None] * ft["weights"][None, :]),
                     pen_w=J((geo.boundary_penalty_coef_mesh(
                         mesh, bg, penalty, penalty_scaling) if affine else
                         boundary_penalty_coef(bg, penalty, penalty_scaling)
                     )[:, None] * ft["weights"][None, :]),
                     sih=J(sign * bg.inv_h)[:, None])
            elems = mesh.bfaces.elem[bg.face_ids]
            if diffusion is not None or affine:
                xpq = boundary_phys_points(basis, bg, ft["points"])
            if diffusion is not None and not kmat:
                t["k"] = _medium(mesh, elems, xpq, diffusion, J)
            if kmat:
                t["Ka"] = _conormal_rows(mesh, diffusion, J,
                                         (elems, xpq, bg.axis, 1.0))
                t["Dall"] = J(ft["Dall"])
                t["ih"] = J(1.0 / mesh.extent[elems])
            bgroups.append(t)

    # the scatter targets of all skeleton contributions, per bucket, in
    # the order the apply produces them: ONE index_add_ per bucket
    targets = {p: [] for p in basis.bucket_degrees}
    for t in groups:
        targets[t["p_in"]].append(t["in_pos"])
        targets[t["p_out"]].append(t["out_pos"])
    for t in bgroups:
        targets[t["p"]].append(t["pos"])
    targets = {p: torch.cat(v) for p, v in targets.items() if v}

    def apply(x):
        y = bulk(x)
        contribs = {p: [] for p in targets}
        for t in groups:
            u_in = x[t["p_in"]][t["in_pos"]]
            u_out = x[t["p_out"]][t["out_pos"]]
            jump = u_in @ t["Vi"] - u_out @ t["Vo"]
            zw, penw = t["zw"], t["pen_w"]
            if kmat:
                Kai, Kao = t["Ka"]()  # (nf, q, dim)
                duin = torch.einsum("fi,biq->fbq", u_in, t["Dalli"])
                duout = torch.einsum("fi,biq->fbq", u_out, t["Dallo"])
                dninq = torch.einsum("fqb,fb,fbq->fq", Kai, t["ihv"], duin)
                dnoutq = torch.einsum("fqb,fb,fbq->fq", Kao, t["ohv"], duout)
                avg = 0.5 * (dninq + dnoutq)
                t2b = zw * (0.5 * theta * jump)
                c_in = ((zw * (-avg) + penw * jump) @ t["ViT"]
                        + torch.einsum("fq,fqb,fb,biq->fi", t2b, Kai,
                                       t["ihv"], t["Dalli"]))
                c_out = ((zw * avg - penw * jump) @ t["VoT"]
                         + torch.einsum("fq,fqb,fb,biq->fi", t2b, Kao,
                                        t["ohv"], t["Dallo"]))
                if sigma1 != 0.0:
                    sn_i, sn_o = t["s1_sn_in"], t["s1_sn_out"]
                    gin = torch.einsum("fbq,fqb->fq", duin, sn_i)
                    gout = torch.einsum("fbq,fqb->fq", duout, sn_o)
                    gj = t["s1_cw"] * (gin - gout)
                    c_in = c_in + torch.einsum("fq,fqb,biq->fi", gj, sn_i,
                                               t["Dalli"])
                    c_out = c_out - torch.einsum("fq,fqb,biq->fi", gj, sn_o,
                                                 t["Dallo"])
                contribs[t["p_in"]].append(c_in)
                contribs[t["p_out"]].append(c_out)
                continue
            dninq = (u_in @ t["Di"]) * t["ihi"]
            dnoutq = (u_out @ t["Do"]) * t["iho"]
            avg = 0.5 * (dninq + dnoutq)
            k = 1.0 if diffusion is None else t["k"]()
            t1_in = zw * (-(k * avg)) + penw * jump
            t2 = zw * (0.5 * theta * k * jump)
            t2_in = t2 * t["ihi"]
            t1_out = zw * (k * avg) - penw * jump
            t2_out = t2 * t["iho"]
            if sigma1 != 0.0:
                # gradient-jump stabilization: the plain (no K) normal
                # derivative traces, weight sigma1 * w_q on box meshes
                gj = (dninq - dnoutq) * t["w"][None, :]
                t2_in = t2_in + sigma1 * gj * t["ihi"]
                t2_out = t2_out - sigma1 * gj * t["iho"]
            contribs[t["p_in"]].append(t1_in @ t["ViT"] + t2_in @ t["DiT"])
            contribs[t["p_out"]].append(t1_out @ t["VoT"]
                                        + t2_out @ t["DoT"])
        for t in bgroups:
            u = x[t["p"]][t["pos"]]
            uq = u @ t["V"]
            zw, penw = t["zw"], t["pen_w"]
            if kmat:
                Ka, = t["Ka"]()
                du = torch.einsum("fi,biq->fbq", u, t["Dall"])
                dnKq = t["sign"] * torch.einsum("fqb,fb,fbq->fq", Ka,
                                                t["ih"], du)
                t1 = zw * (-dnKq) + penw * uq
                t2b = zw * (theta * uq)
                contribs[t["p"]].append(
                    t1 @ t["VT"] + t["sign"] * torch.einsum(
                        "fq,fqb,fb,biq->fi", t2b, Ka, t["ih"], t["Dall"]))
                continue
            dnq = (u @ t["D"]) * t["sih"]
            k = 1.0 if diffusion is None else t["k"]()
            t1 = zw * (-(k * dnq)) + penw * uq
            t2 = zw * (theta * k * uq) * t["sih"]
            contribs[t["p"]].append(t1 @ t["VT"] + t2 @ t["DT"])
        for p, idx in targets.items():
            y[p] = y[p].index_add(0, idx, torch.cat(contribs[p]))
        return y

    return apply


def naive_sipg_operator(basis: DGBasis, penalty: float = 2.0,
                        dirichlet: bool = False, dtype=torch.float64,
                        plan: AssemblyPlan | None = None, dg_form="sipg",
                        sigma1: float = 0.0, device=None):
    """Naive matrix-free IPDG: assemble the block-sparse matrix once and
    matvec it (the differential-testing partner of the sum-factorized
    path)."""
    from hpdg_tpu_torch.assemble.sipg import assemble_laplace
    from hpdg_tpu_torch.linalg.blockmatrix import matvec
    A = assemble_laplace(basis, penalty=penalty, dirichlet=dirichlet,
                         dtype=dtype, plan=plan, dg_form=dg_form,
                         sigma1=sigma1, device=device)
    return lambda x: matvec(A, x)
