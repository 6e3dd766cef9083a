"""Batched SIPG stiffness assembly.

Port of ``hpdg_tpu.assemble.sipg``:

* constant coefficients take the dictionary-GEMM path: every SIPG block
  is a linear combination of a small CONSTANT matrix dictionary
  (basis-table integrals); geometry and penalty live only in per-block
  scalar coefficients, so the value buffer of each (p_row, p_col) key is
  one GEMM ``coef [nblocks, K] @ D [K, br*bc]`` (:class:`_DictBuilder`),
  or its unmultiplied factors with ``coef_parts=True``
  (:class:`_CoefBuilder`, consumed by ``matrixfree.dedup``);
* a scalar or tensor ``diffusion``, and every mesh with first-class
  geometry (affine ``jac`` or trilinear ``corners``, which fold into an
  effective per-point tensor ``|det J| J^-1 K J^-T``, see
  ``mesh/geometry.py``), takes the per-quadrature-point einsums.

Conventions match the reference exactly: Gauss-Lobatto quadrature of
DUNE order 2*max(p), [u] = u_in - u_out, normal inside -> outside,
Dirichlet boundary terms with full (not halved) consistency weights.
``geom_scale`` waits for ROADMAP queue 1, item 13.
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
from hpdg_tpu_torch.linalg.blockmatrix import BlockSparseMatrix
from hpdg_tpu_torch.mesh import geometry as geo

# Upper bound on the bytes of one per-point intermediate of the
# per-point assembly ([e, q, a, j] in the bulk): larger batches are cut
# into element chunks, which leaves every block's sum as it is.
CHUNK_BYTES = 1 << 30


def chunked_over_elements(fn, n: int, row_bytes: int, *tensors):
    """``fn(*[t[lo:hi] for t in tensors])`` over element chunks whose
    intermediate (``row_bytes`` per element) stays under
    :data:`CHUNK_BYTES`, concatenated.  One call when it all fits."""
    step = max(1, CHUNK_BYTES // max(1, row_bytes))
    if n <= step:
        return fn(*tensors)
    return torch.cat([fn(*[t[lo:lo + step] for t in tensors])
                      for lo in range(0, n, step)])


def bulk_tensor_blocks(kc, G):
    """``sum_{q,a,b} G[a,i,q] kc[e,q,a,b] G[b,j,q]`` -> ``[e, i, j]``,
    contracted K.G first so the largest intermediate is ``[e, q, a, j]``
    (never ``[e, q, i, j]``), in element chunks."""
    n, nq, d, _ = kc.shape
    nl = G.shape[1]

    def one(kc_):
        T = torch.einsum("eqab,bjq->eqaj", kc_, G)
        return torch.einsum("aiq,eqaj->eij", G, T)

    return chunked_over_elements(one, n, nq * d * nl * kc.element_size(),
                                 kc)


def dg_theta(dg_form) -> float:
    """DG-form name -> symmetry factor theta of the consistency terms:
    SIPG -1, IIPG 0, NIPG +1; floats pass through."""
    if isinstance(dg_form, str):
        return {"sipg": -1.0, "iipg": 0.0, "nipg": 1.0}[dg_form.lower()]
    return float(dg_form)


def is_tensor_coefficient(diffusion, dim: int, dtype, device) -> bool:
    """True if ``diffusion(x)`` returns a (dim, dim) tensor per point."""
    if diffusion is None:
        return False
    probe = diffusion(torch.full((1, dim), 0.5, dtype=dtype, device=device))
    return probe.dim() >= 3


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

    def factors(self) -> dict:
        """``{key: (coef [nblocks, K] np.f64, D [K, br*bc] np.f64)}``."""
        parts = {}
        for (pr, pc), (rows, _) in self.plan.pattern.entries.items():
            key = (pr, pc)
            br = (pr + 1) ** self.dim
            bc = (pc + 1) ** self.dim
            if key not in self.mats:
                parts[key] = (np.zeros((len(rows), 0)),
                              np.zeros((0, br * bc)))
                continue
            D = np.stack(self.mats[key])
            coef = np.zeros((len(rows), D.shape[0]))
            for (s, c, v) in self.entries[key]:
                np.add.at(coef[:, c], s, v)
            parts[key] = (coef, D)
        return parts

    def finish(self) -> dict:
        vals = {}
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=self.dtype, device=self.device)
        for (pr, pc), (coef, D) in self.factors().items():
            vals[(pr, pc)] = (as_t(coef) @ as_t(D)).reshape(
                coef.shape[0], (pr + 1) ** self.dim, (pc + 1) ** self.dim)
        return vals


class _CoefBuilder(_DictBuilder):
    """:class:`_DictBuilder` that never multiplies out the blocks:
    ``finish`` returns the factorized value buffer
    ``{key: (coef [nblocks, K], D [K, br*bc])}`` (host numpy f64,
    ``values = coef @ D``).  Two blocks are bitwise equal whenever their
    coefficient rows are, so ``matrixfree.dedup`` deduplicates on the
    small ``[nblocks, K]`` table."""

    def finish(self) -> dict:
        return self.factors()


class _ValueBuilder:
    """Assemble the per-(p_row, p_col) value tensors without a scatter
    per contribution.  The plan's slot layout is diag-first with each
    face group's off-diagonal slots contiguous in allocation order, so
    the buffer is built by one ``index_add`` per bucket for everything
    landing on the diagonal (bulk + M11/M22 + boundary) and a single
    concatenation of the per-group off-diagonal blocks."""

    def __init__(self, plan: AssemblyPlan, dim: int, dtype, device):
        self.plan = plan
        self.dim = dim
        self.dtype = dtype
        self.device = device
        self.bulk = {}        # p -> [n_p, bs, bs] (diag slots, in order)
        self.diag_idx = {}    # p -> list of index arrays
        self.diag_val = {}    # p -> list of block tensors
        self.off = {}         # (pr, pc) -> list of block tensors (slot order)

    def set_bulk(self, p, blocks):
        self.bulk[p] = blocks

    def add_diag(self, p, idx, blocks):
        nf = len(idx)
        self.diag_idx.setdefault(p, []).append(np.asarray(idx, np.int64))
        self.diag_val.setdefault(p, []).append(
            blocks.expand((nf,) + blocks.shape[-2:]))

    def add_off(self, key, blocks, nf):
        self.off.setdefault(key, []).append(
            blocks.expand((nf,) + blocks.shape[-2:]))

    def finish(self) -> dict:
        vals = {}
        for (pr, pc), (rows, _) in self.plan.pattern.entries.items():
            parts = []
            if pr == pc:
                n = self.plan.pattern.row_sizes[pr]
                bs = (pr + 1) ** self.dim
                diag = self.bulk.get(pr)
                if diag is None:
                    diag = torch.zeros((n, bs, bs), dtype=self.dtype,
                                       device=self.device)
                if pr in self.diag_idx:
                    idx = torch.as_tensor(np.concatenate(self.diag_idx[pr]),
                                          device=self.device)
                    diag = diag.index_add(0, idx,
                                          torch.cat(self.diag_val[pr]))
                parts.append(diag)
            parts.extend(self.off.get((pr, pc), []))
            vals[(pr, pc)] = (parts[0] if len(parts) == 1
                              else torch.cat(parts))
        return vals


def pullback_diffusion(F):
    """Tensor coefficient of the affine geometry map ``x -> F x``:
    solving the Laplace problem on the image mesh F(Omega) equals
    solving -div(K grad u) = |det F| f on the reference box mesh with
    K = |det F| F^-1 F^-T (geometry expressed as a medium; meshes with
    ``jac``/``corners`` fold it in by themselves)."""
    F = np.asarray(F, np.float64)
    Fi = np.linalg.inv(F)
    K0 = abs(np.linalg.det(F)) * (Fi @ Fi.T)

    def K(x):
        return torch.as_tensor(K0, dtype=x.dtype, device=x.device).expand(
            x.shape[:-1] + K0.shape)

    return K


def assemble_laplace(basis: DGBasis, penalty: float = 2.0,
                     dirichlet: bool = False, diffusion=None,
                     dtype=torch.float64, plan: AssemblyPlan | None = None,
                     penalty_scaling: str = "measure",
                     dg_form="sipg",
                     sigma1: float = 0.0,
                     coef_parts: bool = False,
                     device=None) -> BlockSparseMatrix:
    """Assemble the (optionally variable-coefficient) IPDG stiffness matrix.

    ``dg_form``: "sipg" (default, symmetric) | "iipg" | "nipg", or the
    theta float itself.  ``sigma1``: gradient-jump stabilization
    sigma1/|f| (grad phi_i . n)(grad phi_j . n) on interior faces.

    ``diffusion``: optional vectorized coefficient ``K(x)`` taking a
    tensor ``(..., dim)`` of physical points and returning ``(...)``
    (scalar medium) or ``(..., dim, dim)`` (symmetric TENSOR medium).

    ``coef_parts``: return the factorized value buffer
    ``{(pr, pc): (coef [nblocks, K], D [K, br*bc])}`` (host numpy f64)
    instead of a BlockSparseMatrix; constant coefficients on box meshes
    only.
    """
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    mesh = basis.mesh
    dim = mesh.dim
    affine = geo.has_affine(mesh)
    # constant coefficients on boxes take the dictionary-GEMM fast path;
    # variable diffusion, or first-class geometry (which folds into an
    # effective per-point tensor), needs the per-quad-point einsums
    fast = diffusion is None and not affine
    kmat = affine or is_tensor_coefficient(diffusion, dim, dtype, device)
    theta = dg_theta(dg_form)
    if coef_parts and not fast:
        raise ValueError("coef_parts needs the constant-coefficient "
                         "box-mesh fast path (no diffusion, no affine "
                         "geometry)")
    vb = (_CoefBuilder(plan, dim, dtype, device) if coef_parts
          else _DictBuilder(plan, dim, dtype, device) if fast
          else _ValueBuilder(plan, dim, dtype, device))
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731

    def K(x):
        return None if diffusion is None else diffusion(J(x)).to(dtype)

    def Keff(elems, k, xp):
        """The medium with the geometry folded in (on ``device``)."""
        return J(geo.effective_tensor(mesh, elems, k, xp)) if affine else k

    # ---------------- bulk ----------------
    for p in basis.bucket_degrees:
        vt = tensor.volume_tables(p, dim, p + 2, family=basis.family)
        G, w = vt["G"], vt["weights"]
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        detJ = np.prod(ext, axis=1)
        invh2 = detJ[:, None] / ext**2  # (n, dim): detJ / h_a^2
        if fast:
            S = np.einsum("q,aiq,ajq->aij", w, G, G)
            slots = np.arange(basis.bucket_size(p), dtype=np.int32)
            for a in range(dim):
                vb.add((p, p), slots, S[a], invh2[:, a])
            continue
        xp = (mesh.lower[elems][:, None, :]
              + vt["points"][None, :, :] * ext[:, None, :])
        k = Keff(elems, K(geo.apply_map(mesh, elems, xp)), xp)
        if kmat:
            # tensor medium: detJ / (h_a h_b) geometry factors
            cof = detJ[:, None, None] / (ext[:, :, None] * ext[:, None, :])
            bulk = bulk_tensor_blocks(
                k * J(w)[None, :, None, None] * J(cof)[:, None], J(G))
        else:
            bulk = torch.einsum("eq,ea,aiq,ajq->eij", k * J(w)[None, :],
                                J(invh2), J(G), J(G))
        vb.set_bulk(p, bulk)

    # ---------------- interior faces ----------------
    for fg in plan.face_groups:
        pi, po, ax = fg.p_in, fg.p_out, fg.axis
        pmax = max(pi, po)
        fin, fout = face_group_tables(basis, fg, pmax + 2)
        w = fin["weights"]
        Vi, Di = fin["V"], fin["Dn"]
        Vo, Do = fout["V"], fout["Dn"]
        pen1 = (geo.penalty_coef_mesh(mesh, fg, penalty, pmax,
                                      penalty_scaling) if affine
                else penalty_coef(fg, penalty, pmax, penalty_scaling))
        c_in = -0.5 * fg.fmeas * fg.inv_h_in
        c_out = -0.5 * fg.fmeas * fg.inv_h_out
        if fast:
            AVDi = np.einsum("iq,q,jq->ij", Vi, w, Di)
            AVDo = np.einsum("iq,q,jq->ij", Vo, w, Do)
            BVVi = np.einsum("iq,q,jq->ij", Vi, w, Vi)
            BVVo = np.einsum("iq,q,jq->ij", Vo, w, Vo)
            X1 = np.einsum("iq,q,jq->ij", Vi, w, Do)
            X2 = np.einsum("iq,q,jq->ij", Di, w, Vo)
            X3 = np.einsum("iq,q,jq->ij", Vi, w, Vo)
            # M11 = c_in (AVDi - theta AVDi^T) + pen BVVi (etc.); theta
            # folds into the dictionary matrices (SIPG theta=-1 gives
            # sym() entries)
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
            continue

        # face quad points on the intersection: xp parametric (inside
        # chart), the medium is evaluated at their physical image
        xp = face_phys_points(basis, fg, fin["points"])
        ein = mesh.faces.inside[fg.face_ids]
        eout = mesh.faces.outside[fg.face_ids]
        k = K(geo.apply_map(mesh, ein, xp))
        pen = J(pen1)[:, None, None]
        BVVi = J(np.einsum("iq,q,jq->ij", Vi, w, Vi))
        BVVo = J(np.einsum("iq,q,jq->ij", Vo, w, Vo))
        BVio = J(np.einsum("iq,q,jq->ij", Vi, w, Vo))
        if affine:
            xpo = face_phys_points(basis, fg, fin["points"], side="out")
            k_in, k_out = Keff(ein, k, xp), Keff(eout, k, xpo)
        else:
            k_in = k_out = k
        if kmat:
            # tensor medium / geometry: co-normal derivative traces
            # (K grad phi).n = sum_b k_eff[ax, b] Dall[b] / h_b, each side
            # along ITS chart's face axis, signed so the parametric
            # normal points inside -> outside (twisted imports; the
            # defaults reduce to +e_axis on both sides)
            sgn_i = float(2 * fg.in_side - 1)
            sgn_o = float(1 - 2 * fg.out_side)
            KDi = torch.einsum("fqb,biq,fb->fiq", sgn_i * k_in[..., ax, :],
                               J(fin["Dall"]), J(1.0 / mesh.extent[ein]))
            KDo = torch.einsum("fqb,biq,fb->fiq",
                               sgn_o * k_out[..., fg.out_axis, :],
                               J(fout["Dall"]), J(1.0 / mesh.extent[eout]))
            half = -0.5 * J(fg.fmeas)[:, None] * J(w)[None, :]
            # symmetry terms carry theta: coefficient 0.5 theta z =
            # (-theta) * half
            M11 = (torch.einsum("fq,iq,fjq->fij", half, J(Vi), KDi)
                   - theta * torch.einsum("fq,fiq,jq->fij", half, KDi, J(Vi))
                   + pen * BVVi[None])
            M22 = (-torch.einsum("fq,iq,fjq->fij", half, J(Vo), KDo)
                   + theta * torch.einsum("fq,fiq,jq->fij", half, KDo, J(Vo))
                   + pen * BVVo[None])
            M12 = (torch.einsum("fq,iq,fjq->fij", half, J(Vi), KDo)
                   + theta * torch.einsum("fq,fiq,jq->fij", half, KDi, J(Vo))
                   - pen * BVio[None])
            M21 = (-torch.einsum("fq,iq,fjq->fij", half, J(Vo), KDi)
                   - theta * torch.einsum("fq,fiq,jq->fij", half, KDo, J(Vi))
                   - pen * BVio.T[None])
            if sigma1 != 0.0:
                # sigma1/|f|_phys int [grad u . n][grad v . n] ds with
                # plain (no K) physical gradients and per-point normals
                xpo_s1 = (xpo if affine else face_phys_points(
                    basis, fg, fin["points"], side="out"))
                sn_i, sn_o, zs = geo.face_grad_jump_geometry(
                    mesh, fg, xp, xpo_s1)
                s_in = J(np.einsum("biq,fqb->fiq", fin["Dall"], sn_i))
                s_out = J(np.einsum("biq,fqb->fiq", fout["Dall"], sn_o))
                zsw = zs * w[None, :]
                cfq = J((sigma1 / zsw.sum(axis=1))[:, None] * zsw)
                M11 = M11 + torch.einsum("fq,fiq,fjq->fij", cfq, s_in, s_in)
                M22 = M22 + torch.einsum("fq,fiq,fjq->fij", cfq, s_out,
                                         s_out)
                M12 = M12 - torch.einsum("fq,fiq,fjq->fij", cfq, s_in,
                                         s_out)
                M21 = M21 - torch.einsum("fq,fiq,fjq->fij", cfq, s_out,
                                         s_in)
        else:
            kzi = k * J(w)[None, :] * J(c_in)[:, None]  # -0.5 |f|/h_in K w
            kzo = k * J(w)[None, :] * J(c_out)[:, None]
            M11 = (torch.einsum("fq,iq,jq->fij", kzi, J(Vi), J(Di))
                   - theta * torch.einsum("fq,iq,jq->fij", kzi, J(Di), J(Vi))
                   + pen * BVVi[None])
            M22 = (-torch.einsum("fq,iq,jq->fij", kzo, J(Vo), J(Do))
                   + theta * torch.einsum("fq,iq,jq->fij", kzo, J(Do), J(Vo))
                   + pen * BVVo[None])
            M12 = (torch.einsum("fq,iq,jq->fij", kzo, J(Vi), J(Do))
                   + theta * torch.einsum("fq,iq,jq->fij", kzi, J(Di), J(Vo))
                   - pen * BVio[None])
            M21 = (-theta * torch.einsum("fq,iq,jq->fij", kzo, J(Do), J(Vi))
                   - torch.einsum("fq,iq,jq->fij", kzi, J(Vo), J(Di))
                   - pen * BVio.T[None])
            if sigma1 != 0.0:
                GDDi = J(np.einsum("iq,q,jq->ij", Di, w, Di))
                GDDo = J(np.einsum("iq,q,jq->ij", Do, w, Do))
                GDio = J(np.einsum("iq,q,jq->ij", Di, w, Do))
                ihi = J(fg.inv_h_in)[:, None, None]
                iho = J(fg.inv_h_out)[:, None, None]
                M11 = M11 + sigma1 * ihi * ihi * GDDi[None]
                M22 = M22 + sigma1 * iho * iho * GDDo[None]
                M12 = M12 - sigma1 * ihi * iho * GDio[None]
                M21 = M21 - sigma1 * ihi * iho * GDio.T[None]
        nf = len(fg.face_ids)
        vb.add_diag(pi, fg.in_pos, M11)
        vb.add_diag(po, fg.out_pos, M22)
        vb.add_off((pi, po), M12, nf)
        vb.add_off((po, pi), M21, nf)

    # ---------------- Dirichlet boundary ----------------
    if dirichlet:
        for bg in plan.boundary_groups:
            p, ax, side = bg.p, bg.axis, bg.side
            sign = 1.0 if side == 1 else -1.0
            ft = tensor.face_tables(p, dim, ax, side, p + 2,
                                    family=basis.family)
            w, V, D = ft["weights"], ft["V"], ft["Dn"]
            pen1 = (geo.boundary_penalty_coef_mesh(mesh, bg, penalty,
                                                   penalty_scaling)
                    if affine else
                    boundary_penalty_coef(bg, penalty, penalty_scaling))
            c = -sign * bg.fmeas * bg.inv_h
            if fast:
                AVD = np.einsum("iq,q,jq->ij", V, w, D)
                BVV = np.einsum("iq,q,jq->ij", V, w, V)
                vb.add((p, p), bg.pos, AVD - theta * AVD.T, c)
                vb.add((p, p), bg.pos, BVV, pen1)
                continue
            elems = mesh.bfaces.elem[bg.face_ids]
            xp = boundary_phys_points(basis, bg, ft["points"])
            k = Keff(elems, K(geo.apply_map(mesh, elems, xp)), xp)
            pen = J(pen1)[:, None, None]
            BVV = J(np.einsum("iq,q,jq->ij", V, w, V))
            if kmat:
                # co-normal trace with outward normal sign * e_ax
                KD = sign * torch.einsum(
                    "fqb,biq,fb->fiq", k[..., ax, :], J(ft["Dall"]),
                    J(1.0 / mesh.extent[elems]))
                cf = -1.0 * J(bg.fmeas)[:, None] * J(w)[None, :]
                M = (torch.einsum("fq,iq,fjq->fij", cf, J(V), KD)
                     - theta * torch.einsum("fq,fiq,jq->fij", cf, KD, J(V))
                     + pen * BVV[None])
            else:
                kz = k * J(w)[None, :] * J(c)[:, None]
                M = (torch.einsum("fq,iq,jq->fij", kz, J(V), J(D))
                     - theta * torch.einsum("fq,iq,jq->fij", kz, J(D), J(V))
                     + pen * BVV[None])
            vb.add_diag(p, bg.pos, M)

    if coef_parts:
        return vb.finish()
    return BlockSparseMatrix(plan.pattern, dim, vb.finish())
