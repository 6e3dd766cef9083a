"""Batched SIPG stiffness assembly, constant-coefficient box meshes.

Port of the dictionary-GEMM path of ``hpdg_tpu.assemble.sipg``: for
constant coefficients every SIPG block is a linear combination of a
small CONSTANT matrix dictionary (basis-table integrals); geometry and
penalty live only in per-block scalar coefficients, so the value buffer
of each (p_row, p_col) key is one GEMM ``coef [nblocks, K] @ D [K,
br*bc]``.

Conventions match the reference exactly: Gauss-Lobatto quadrature of
DUNE order 2*max(p), [u] = u_in - u_out, normal inside -> outside,
Dirichlet boundary terms with full (not halved) consistency weights.
Variable/tensor diffusion, affine geometry and the factorized
``coef_parts`` output wait for later items of ROADMAP queue 1.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.assemble.plan import (AssemblyPlan, build_plan,
                                          face_group_tables, penalty_coef,
                                          boundary_penalty_coef)
from hpdg_tpu_torch.linalg.blockmatrix import BlockSparseMatrix


def dg_theta(dg_form) -> float:
    """DG-form name -> symmetry factor theta of the consistency terms:
    SIPG -1, IIPG 0, NIPG +1; floats pass through."""
    if isinstance(dg_form, str):
        return {"sipg": -1.0, "iipg": 0.0, "nipg": 1.0}[dg_form.lower()]
    return float(dg_form)


class _DictBuilder:
    """Constant-coefficient assembly as ONE GEMM per (p_row, p_col) key.

    ``add`` records ``blocks[slots] += coefs * mat`` as a dictionary
    column plus per-block scalar coefficients (host numpy f64);
    ``finish`` scatters the coefficients into ``coef [nblocks, K]`` and
    multiplies out ``coef @ D`` in ``dtype`` on ``device``.
    """

    def __init__(self, plan: AssemblyPlan, dim: int, dtype, device):
        self.plan = plan
        self.dim = dim
        self.dtype = dtype
        self.device = device
        self.mats = {}     # key -> list of np [br*bc] dictionary rows
        self.entries = {}  # key -> list of (slots np, col, coefs np)

    def add(self, key, slots, mat_np, coefs):
        """blocks[slots] += coefs[:, None, None] * mat_np."""
        cols = self.mats.setdefault(key, [])
        col = len(cols)
        cols.append(np.asarray(mat_np, np.float64).reshape(-1))
        self.entries.setdefault(key, []).append(
            (np.asarray(slots, np.int64), col,
             np.broadcast_to(np.asarray(coefs, np.float64), (len(slots),))))

    def finish(self) -> dict:
        vals = {}
        for (pr, pc), (rows, _) in self.plan.pattern.entries.items():
            key = (pr, pc)
            nblocks = len(rows)
            br = (pr + 1) ** self.dim
            bc = (pc + 1) ** self.dim
            if key not in self.mats:
                vals[key] = torch.zeros((nblocks, br, bc), dtype=self.dtype,
                                        device=self.device)
                continue
            D = np.stack(self.mats[key])
            coef = np.zeros((nblocks, D.shape[0]))
            for (s, c, v) in self.entries[key]:
                np.add.at(coef[:, c], s, v)
            as_t = lambda a: torch.as_tensor(  # noqa: E731
                a, dtype=self.dtype, device=self.device)
            vals[key] = (as_t(coef) @ as_t(D)).reshape(nblocks, br, bc)
        return vals


def assemble_laplace(basis: DGBasis, penalty: float = 2.0,
                     dirichlet: bool = False, diffusion=None,
                     dtype=torch.float64, plan: AssemblyPlan | None = None,
                     penalty_scaling: str = "measure",
                     dg_form="sipg",
                     sigma1: float = 0.0,
                     coef_parts: bool = False,
                     device=None) -> BlockSparseMatrix:
    """Assemble the constant-coefficient IPDG stiffness matrix.

    ``dg_form``: "sipg" (default, symmetric) | "iipg" | "nipg", or the
    theta float itself.  ``sigma1``: gradient-jump stabilization
    sigma1/|f| (grad phi_i . n)(grad phi_j . n) on interior faces.
    """
    if diffusion is not None:
        raise NotImplementedError(
            "variable diffusion: ROADMAP queue 1, item 9 (general-mesh apply "
            "and the generic assembly paths)")
    if coef_parts:
        raise NotImplementedError(
            "coef_parts: ROADMAP queue 1, item 15 (dedup SpMV)")
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    mesh = basis.mesh
    dim = mesh.dim
    theta = dg_theta(dg_form)
    vb = _DictBuilder(plan, dim, dtype, device)

    # ---------------- bulk ----------------
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, dim, p + 2, family=basis.family)
        G, w = vt["G"], vt["weights"]
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        detJ = np.prod(ext, axis=1)
        invh2 = detJ[:, None] / ext**2  # (n, dim): detJ / h_a^2
        S = np.einsum("q,aiq,ajq->aij", w, G, G)
        slots = np.arange(basis.bucket_size(p), dtype=np.int32)
        for a in range(dim):
            vb.add((p, p), slots, S[a], invh2[:, a])

    # ---------------- interior faces ----------------
    for fg in plan.face_groups:
        pi, po = fg.p_in, fg.p_out
        pmax = max(pi, po)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        w = fin["weights"]
        Vi, Di = fin["V"], fin["Dn"]
        Vo, Do = fout["V"], fout["Dn"]
        pen1 = penalty_coef(fg, penalty, pmax, penalty_scaling)
        c_in = -0.5 * fg.fmeas * fg.inv_h_in
        c_out = -0.5 * fg.fmeas * fg.inv_h_out
        AVDi = np.einsum("iq,q,jq->ij", Vi, w, Di)
        AVDo = np.einsum("iq,q,jq->ij", Vo, w, Do)
        BVVi = np.einsum("iq,q,jq->ij", Vi, w, Vi)
        BVVo = np.einsum("iq,q,jq->ij", Vo, w, Vo)
        X1 = np.einsum("iq,q,jq->ij", Vi, w, Do)
        X2 = np.einsum("iq,q,jq->ij", Di, w, Vo)
        X3 = np.einsum("iq,q,jq->ij", Vi, w, Vo)
        # M11 = c_in (AVDi - theta AVDi^T) + pen BVVi (etc.); theta folds
        # into the dictionary matrices (SIPG theta=-1 gives sym() entries)
        vb.add((pi, pi), fg.in_pos, AVDi - theta * AVDi.T, c_in)
        vb.add((pi, pi), fg.in_pos, BVVi, pen1)
        vb.add((po, po), fg.out_pos, AVDo - theta * AVDo.T, -1.0 * c_out)
        vb.add((po, po), fg.out_pos, BVVo, pen1)
        vb.add((pi, po), fg.slot12, X1, c_out)
        vb.add((pi, po), fg.slot12, X2, theta * c_in)
        vb.add((pi, po), fg.slot12, X3, -pen1)
        vb.add((po, pi), fg.slot21, X1.T, -theta * c_out)
        vb.add((po, pi), fg.slot21, X2.T, -1.0 * c_in)
        vb.add((po, pi), fg.slot21, X3.T, -pen1)
        if sigma1 != 0.0:
            GDDi = np.einsum("iq,q,jq->ij", Di, w, Di)
            GDDo = np.einsum("iq,q,jq->ij", Do, w, Do)
            GDio = np.einsum("iq,q,jq->ij", Di, w, Do)
            ihi, iho = fg.inv_h_in, fg.inv_h_out
            vb.add((pi, pi), fg.in_pos, GDDi, sigma1 * ihi * ihi)
            vb.add((po, po), fg.out_pos, GDDo, sigma1 * iho * iho)
            vb.add((pi, po), fg.slot12, GDio, -sigma1 * ihi * iho)
            vb.add((po, pi), fg.slot21, GDio.T, -sigma1 * ihi * iho)

    # ---------------- Dirichlet boundary ----------------
    if dirichlet:
        for bg in plan.boundary_groups:
            p, ax, side = bg.p, bg.axis, bg.side
            sign = 1.0 if side == 1 else -1.0
            ft = tensor.face_tables(p, dim, ax, side, p + 2,
                                    family=basis.family)
            w, V, D = ft["weights"], ft["V"], ft["Dn"]
            pen1 = boundary_penalty_coef(bg, penalty, penalty_scaling)
            c = -sign * bg.fmeas * bg.inv_h
            AVD = np.einsum("iq,q,jq->ij", V, w, D)
            BVV = np.einsum("iq,q,jq->ij", V, w, V)
            vb.add((p, p), bg.pos, AVD - theta * AVD.T, c)
            vb.add((p, p), bg.pos, BVV, pen1)

    return BlockSparseMatrix(plan.pattern, dim, vb.finish())
