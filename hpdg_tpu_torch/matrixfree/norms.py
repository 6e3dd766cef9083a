"""DG energy-norm functionals: the per-element error indicator.

Port of ``hpdg_tpu.matrixfree.norms`` (IPDGLocalNorm of the
reference):

    eta_e^2 = (grad x, grad x)_E + sum_{faces f of E} sigma max(p)^2
              / (2 |f|) int_f [x]^2

Each interior face splits its jump energy evenly between its two
elements; boundary faces count fully for their element when
``dirichlet``.  ``jump_indicator`` is the face part alone.  Both return
``apply(x) -> Tensor[n_elements]`` in flat element order, on the
device of their tables; every bucket and face group lands in ``eta``
with one ``index_add_``.  On meshes with first-class geometry the bulk
part is the PHYSICAL gradient energy, through the effective tensor
``|det J| J^-1 J^-T`` uploaded at build; the face part keeps the
parametric penalty coefficients, as in the reference.
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
from hpdg_tpu_torch.matrixfree.sumfact import _bucket_geometry, _chain
from hpdg_tpu_torch.mesh import geometry as geo
from hpdg_tpu_torch.mesh.structured import require_classic_faces


def _face_terms(basis: DGBasis, plan: AssemblyPlan, penalty: float,
                penalty_scaling: str, J, I) -> list:
    """Per interior face group: gathers, trace tables, the penalty
    weights ``0.5 c_f w_q`` and the elements inside, then outside."""
    mesh = basis.mesh
    out = []
    for fg in plan.face_groups:
        pmax = max(fg.p_in, fg.p_out)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        pw = (0.5 * penalty_coef(fg, penalty, pmax, penalty_scaling)[:, None]
              * fin["weights"][None, :])
        out.append(dict(p_in=fg.p_in, p_out=fg.p_out, in_pos=I(fg.in_pos),
                        out_pos=I(fg.out_pos), Vi=J(fin["V"]), Vo=J(fout["V"]),
                        pw=J(pw),
                        elems=I(np.concatenate([
                            mesh.faces.inside[fg.face_ids],
                            mesh.faces.outside[fg.face_ids]]))))
    return out


def _add_jumps(eta: torch.Tensor, x: dict, faces: list) -> torch.Tensor:
    for t in faces:
        jump = (x[t["p_in"]][t["in_pos"]] @ t["Vi"]
                - x[t["p_out"]][t["out_pos"]] @ t["Vo"])
        contrib = (t["pw"] * jump ** 2).sum(dim=1)
        eta = eta.index_add(0, t["elems"], torch.cat([contrib, contrib]))
    return eta


def ipdg_local_norm(basis: DGBasis, penalty: float = 2.0,
                    dirichlet: bool = False, dtype=torch.float64,
                    plan: AssemblyPlan | None = None,
                    penalty_scaling: str = "measure", device=None):
    """Returns ``apply(x) -> Tensor[n_elements]`` of eta_e^2 (flat
    element order) in ``dtype`` on ``device``."""
    require_classic_faces(basis.mesh, "ipdg_local_norm")
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    dim = basis.dim
    mesh = basis.mesh
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    I = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731, E741
                                  device=device)
    bulk = []
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, dim, p + 2, family=basis.family)
        t1 = vt["t1d"]
        ext, detJ = _bucket_geometry(basis, p)
        wq = vt["weights"].reshape((len(t1.qweights),) * dim)
        V, D = J(t1.values), J(t1.derivatives)
        bshape = lambda v: J(v).reshape((-1,) + (1,) * dim)  # noqa: E731
        t = dict(
            p=p, elems=I(basis.bucket_elems[p]), wq=J(wq)[None],
            tabs=[[D if b == a else V for b in range(dim)]
                  for a in range(dim)],
            coef=[bshape(detJ / ext[:, a] ** 2) for a in range(dim)])
        if geo.has_geometry(mesh):
            elems = basis.bucket_elems[p]
            xpq = (mesh.lower[elems][:, None, :]
                   + vt["points"][None, :, :] * ext[:, None, :])
            G = geo.effective_tensor(mesh, elems, None, xpq)
            t["G"] = J(np.ascontiguousarray(G)).reshape(
                (-1,) + wq.shape + (dim, dim))
            t["invh"] = [bshape(1.0 / ext[:, a]) for a in range(dim)]
            t["wdet"] = t["wq"] * bshape(detJ)
        bulk.append(t)
    faces = _face_terms(basis, plan, penalty, penalty_scaling, J, I)
    bnd = []
    if dirichlet:
        for bg in plan.boundary_groups:
            ft = tensor.face_tables(bg.p, dim, bg.axis, bg.side, bg.p + 2,
                                    family=basis.family)
            pw = (boundary_penalty_coef(bg, penalty, penalty_scaling)[:, None]
                  * ft["weights"][None, :])
            bnd.append(dict(p=bg.p, pos=I(bg.pos), V=J(ft["V"]), pw=J(pw),
                            elems=I(mesh.bfaces.elem[bg.face_ids])))

    def apply(x: dict) -> torch.Tensor:
        x = {p: v.to(dtype) for p, v in x.items()}
        eta = torch.zeros(mesh.n_elements, dtype=dtype, device=device)
        # bulk: |grad x|^2 per element, one axis of the gradient at a time
        for t in bulk:
            u = x[t["p"]].reshape((-1,) + (t["tabs"][0][0].shape[0],) * dim)
            acc = 0.0
            if "G" in t:
                dus = [_chain(u, t["tabs"][a]) * t["invh"][a]
                       for a in range(dim)]
                for a in range(dim):
                    for b in range(dim):
                        acc = acc + (t["wdet"] * t["G"][..., a, b] * dus[a]
                                     * dus[b]).reshape(u.shape[0], -1).sum(1)
            else:
                for a in range(dim):
                    du = _chain(u, t["tabs"][a])
                    acc = acc + (t["coef"][a] * t["wq"] * du ** 2).reshape(
                        du.shape[0], -1).sum(dim=1)
            eta = eta.index_add(0, t["elems"], acc)
        eta = _add_jumps(eta, x, faces)
        for t in bnd:
            tr = x[t["p"]][t["pos"]] @ t["V"]
            eta = eta.index_add(0, t["elems"], (t["pw"] * tr ** 2).sum(dim=1))
        return eta

    return apply


def jump_indicator(basis: DGBasis, penalty: float = 2.0,
                   dtype=torch.float64, plan: AssemblyPlan | None = None,
                   penalty_scaling: str = "measure", device=None):
    """Per-element jump-only indicator: eta_e^2 = sum over the element's
    interior faces of sigma max(p)^2 / (2 |f|) int_f [x]^2, the skeleton
    part of :func:`ipdg_local_norm` (usable at p=1, where hierarchic
    surrogates are empty).  Returns ``apply(x) -> Tensor[n_elements]``."""
    require_classic_faces(basis.mesh, "jump_indicator")
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    n = basis.mesh.n_elements
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    I = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731, E741
                                  device=device)
    faces = _face_terms(basis, plan, penalty, penalty_scaling, J, I)

    def apply(x: dict) -> torch.Tensor:
        return _add_jumps(torch.zeros(n, dtype=dtype, device=device),
                          {p: v.to(dtype) for p, v in x.items()}, faces)

    return apply
