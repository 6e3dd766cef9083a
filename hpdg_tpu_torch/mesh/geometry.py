"""First-class general element geometry: affine and trilinear (Q1).

Port of ``hpdg_tpu.mesh.geometry`` (host-side numpy, as there).  The
geometry is stored as mesh data and folded into the *coefficient
tensors* every batched operator already consumes:

* bulk:   |det J| J^-1 K J^-T replaces K (the pullback identity),
* faces:  the co-normal flux per side obeys, POINTWISE,
  ``g(x) (K grad_phys u) . n_phys = (K_eff(x) grad_param u)_axis`` with
  ``g = |det J| |J^-T e_axis|`` the Nanson area factor — so the face
  consistency terms keep the parametric face measure in the quadrature
  weight and need no extra geometry factors, for affine AND curved maps,
* penalty: a per-face constant by convention ("measure" scaling is
  geometry-free; "normal" uses the face-center physical factors).

So general geometry needs no new kernels: every operator (assembled,
matrix-free, diagonal blocks) takes the tensor-coefficient path with per-element-constant (affine) or per-quad-point (trilinear)
effective tensors.  The parametric boxes remain the topology carrier:
face matching, 2:1 refinement, partitions and the whole sharded layer
are geometry-agnostic.

Two representations, in precedence order:

* ``mesh.corners`` (n, 2^dim, dim): genuinely TRILINEAR (isoparametric
  Q1) hexes/quads — the multilinear interpolation of the physical corner
  positions over the element's parametric box.  Per-point Jacobians.
* ``mesh.jac``/``mesh.shift``: per-element AFFINE maps on the global
  parametric space, ``x_phys = shift[e] + jac[e] @ x_param`` —
  parallelepiped cells, constant Jacobians (cheaper; exactly conforming
  for global maps).

Constructors: :func:`affine_image` (one global affine map),
:func:`affinize` (per-element linearization of a smooth map),
:func:`isoparametric` (corner-sampled Q1 geometry of a smooth map —
exactly conforming across shared faces of the SAME refinement level;
build it on the coarsest mesh and refine to keep hanging-node
hierarchies geometrically conforming, since children inherit by exact
restriction), :func:`from_hex_lattice` (meshio/Gmsh-style import,
affine when all cells are parallelepipeds, trilinear otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch.mesh.structured import (Mesh, from_boxes, Faces,
                                      BoundaryFaces)
from dataclasses import replace


def _bits(dim: int) -> np.ndarray:
    """Corner bit table (2^dim, dim): bit of corner c along axis a is
    ``(c >> (dim-1-a)) & 1`` (C order, last axis fastest — matches
    refine()'s child_pos convention)."""
    nc = 2**dim
    return ((np.arange(nc)[:, None] >> np.arange(dim - 1, -1, -1)[None, :])
            & 1).astype(np.float64)


def has_geometry(mesh: Mesh) -> bool:
    """True if the mesh carries first-class geometry (affine or Q1)."""
    return (getattr(mesh, "corners", None) is not None
            or getattr(mesh, "jac", None) is not None)


def has_affine(mesh: Mesh) -> bool:
    return has_geometry(mesh)


def is_trilinear(mesh: Mesh) -> bool:
    return getattr(mesh, "corners", None) is not None


def has_element_charts(mesh: Mesh) -> bool:
    """True if the elements live in parametric charts of their own
    (:func:`from_cell_vertices`: disjoint unit boxes), i.e. some interior
    face is not a shared face of the two parametric boxes.  There the
    parametric position of one element says nothing about another's, and
    code that re-derives topology from the boxes must refuse."""
    f = mesh.faces
    if not len(f):
        return False
    if not f.is_classic:
        return True
    plane_in = (mesh.lower[f.inside, f.axis]
                + mesh.extent[f.inside, f.axis])
    plane_out = mesh.lower[f.outside, f.axis]
    return bool((np.abs(plane_in - plane_out)
                 > 1e-6 * mesh.extent.min()).any())


# ---------------------------------------------------------------------------
# Q1 (multilinear) primitives — all numpy, host-side
# ---------------------------------------------------------------------------

def q1_eval(corners: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Evaluate the multilinear corner interpolation: ``corners``
    (n, 2^d, d) physical corners, ``xi`` (n, q, d) element-LOCAL points
    in [0,1]^d -> (n, q, d) physical points."""
    d = corners.shape[-1]
    B = _bits(d)  # (nc, d)
    # N_c(xi) = prod_a (B[c,a] ? xi_a : 1-xi_a):   (n, q, nc)
    t = np.where(B[None, None, :, :] > 0.5,
                 xi[:, :, None, :], 1.0 - xi[:, :, None, :])
    N = t.prod(axis=-1)
    return np.einsum("nqc,ncd->nqd", N, corners)


def q1_jacobian_local(corners: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """d(phi)/d(xi) of the multilinear map: (n, q, d, d) with column a =
    derivative along local axis a."""
    n, q, d = xi.shape
    B = _bits(d)
    t = np.where(B[None, None, :, :] > 0.5,
                 xi[:, :, None, :], 1.0 - xi[:, :, None, :])  # (n,q,nc,d)
    sgn = 2.0 * B - 1.0  # (nc, d)
    J = np.empty((n, q, d, d))
    for a in range(d):
        # dN_c/dxi_a = sgn[c,a] * prod_{b != a} t[...,b]
        prod = np.ones((n, q, B.shape[0]))
        for b in range(d):
            if b != a:
                prod = prod * t[..., b]
        dN = prod * sgn[None, None, :, a]
        J[..., a] = np.einsum("nqc,ncd->nqd", dN, corners)
    return J


def q1_child_corners(corners: np.ndarray, parent_idx: np.ndarray,
                     child_pos: np.ndarray) -> np.ndarray:
    """Corners of refinement children: evaluate each parent's trilinear
    map at the child sub-box corners (exact restriction).  ``parent_idx``
    and ``child_pos`` are per-child arrays; child_pos uses the same
    C-order bit convention as the corner index."""
    d = corners.shape[-1]
    B = _bits(d)
    # child corner c local coords within the parent: (bits(pos)+bits(c))/2
    pos_off = B[np.asarray(child_pos, dtype=np.int64)]  # (m, d)
    xi = 0.5 * (pos_off[:, None, :] + B[None, :, :])    # (m, nc, d)
    return q1_eval(corners[np.asarray(parent_idx, dtype=np.int64)], xi)


def _q1_gauss_det(mesh: Mesh) -> np.ndarray:
    """SIGNED det J_global at the tensor Gauss(2) points, (n, 2^d)."""
    d = mesh.dim
    g = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])
    pts = np.stack(np.meshgrid(*([g] * d), indexing="ij"),
                   axis=-1).reshape(-1, d)  # (2^d, d) local
    xi = np.broadcast_to(pts, (mesh.n_elements,) + pts.shape)
    Jl = q1_jacobian_local(mesh.corners, xi)
    return np.linalg.det(Jl) / np.prod(mesh.extent, axis=1)[:, None]


def mean_detj_q1(mesh: Mesh) -> np.ndarray:
    """Per-element mean of |det J_global| over the parametric box, exact
    for Q1 geometry (tensor Gauss(2) rule integrates the degree-<=2-per-
    variable det polynomial exactly).  volumes = prod(extent) * this."""
    return np.abs(_q1_gauss_det(mesh)).mean(axis=1)


def _check_q1_orientation(mesh: Mesh, what: str):
    """Reject locally inverted/degenerate Q1 cells: the signed det must
    stay positive pointwise, NOT on average — an inverted corner can
    hide inside a positive mean.  Checked at the Gauss(2) points, the
    corners and the center (det is degree <= 2 per variable, so this
    samples every region a practical inversion lives in)."""
    d = mesh.dim
    g = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])
    probe = [np.stack(np.meshgrid(*([g] * d), indexing="ij"),
                      axis=-1).reshape(-1, d),
             _bits(d), np.full((1, d), 0.5)]
    pts = np.concatenate(probe)
    xi = np.broadcast_to(pts, (mesh.n_elements,) + pts.shape)
    det = np.linalg.det(q1_jacobian_local(mesh.corners, xi))
    if np.min(det) <= 0:
        raise ValueError(f"{what}: inverted or degenerate hex (det J "
                         "changes sign; check vertex ordering)")


# ---------------------------------------------------------------------------
# per-point geometry queries (elems + GLOBAL parametric points)
# ---------------------------------------------------------------------------

def _param_pts(mesh: Mesh, elems, x) -> np.ndarray:
    """Normalize points to (n, q, dim) and convert to element-local."""
    x = np.asarray(x, np.float64)
    if x.ndim == 2:  # (q, dim) shared across elements
        x = np.broadcast_to(x, (len(elems),) + x.shape)
    return (x - mesh.lower[elems][:, None, :]) / mesh.extent[elems][:, None, :]


def apply_map(mesh: Mesh, elems, x):
    """Map GLOBAL parametric points (n, q, dim) to physical space."""
    if is_trilinear(mesh):
        return q1_eval(mesh.corners[elems], _param_pts(mesh, elems, x))
    if not has_geometry(mesh):
        return x
    A = mesh.jac[elems]
    s = mesh.shift[elems]
    return s[:, None, :] + np.einsum("eab,eqb->eqa", A, np.asarray(x))


def jacobians(mesh: Mesh, elems, pts) -> np.ndarray:
    """Per-point Jacobian d(phys)/d(global param): (n, q, d, d).
    ``pts``: global parametric points (n, q, d) or (q, d)."""
    d = mesh.dim
    if is_trilinear(mesh):
        xi = _param_pts(mesh, elems, pts)
        Jl = q1_jacobian_local(mesh.corners[elems], xi)
        return Jl / mesh.extent[elems][:, None, None, :]
    nq = np.asarray(pts).shape[-2]
    if not has_geometry(mesh):
        return np.broadcast_to(np.eye(d), (len(elems), nq, d, d))
    return np.broadcast_to(mesh.jac[elems][:, None], (len(elems), nq, d, d))


def geometry_tensor(mesh: Mesh, elems) -> np.ndarray:
    """Per-element effective tensor G_e = |det A| A^-1 A^-T (n, d, d),
    evaluated at the element CENTER for trilinear meshes."""
    d = mesh.dim
    if not has_geometry(mesh):
        return np.broadcast_to(np.eye(d), (len(elems), d, d))
    ctr = (mesh.lower[elems] + 0.5 * mesh.extent[elems])[:, None, :]
    J = jacobians(mesh, elems, ctr)[:, 0]
    Ji = np.linalg.inv(J)
    det = np.abs(np.linalg.det(J))
    return det[:, None, None] * np.einsum("eab,ecb->eac", Ji, Ji)


def effective_tensor(mesh: Mesh, elems, k, pts):
    """Fold the geometry into an evaluated coefficient, per point.

    ``k``: None | (n, q) scalar array | (n, q, d, d) tensor array — the
    user's medium K evaluated at the physical quadrature points (numpy
    array, or a torch tensor on any device).  ``pts``: the GLOBAL
    PARAMETRIC quadrature points, (n, q, d) or (q, d).  Returns the
    (n, q, d, d) effective tensor |det J| J^-1 K J^-T: a numpy array for
    a numpy ``k``, a torch tensor on ``k``'s device when ``k`` is a
    torch tensor (the host-side inverse Jacobians are uploaded once,
    here).  Only call for meshes with first-class geometry."""
    if isinstance(k, torch.Tensor):
        return _effective_tensor_torch(mesh, elems, k, pts)
    d = mesh.dim
    nq = np.asarray(pts).shape[-2]
    if not is_trilinear(mesh):
        # affine: per-element constants, broadcast over points
        A = mesh.jac[elems]
        Ai = np.linalg.inv(A)
        det = np.abs(np.linalg.det(A))
        G1 = det[:, None, None] * np.einsum("eab,ecb->eac", Ai, Ai)
        if k is None:  # a copy: consumers hand it to torch, which wants
            # writable memory
            return np.broadcast_to(G1[:, None],
                                   (len(elems), nq, d, d)).copy()
        if k.ndim == 2:  # scalar medium
            return k[:, :, None, None] * G1[:, None]
        return (np.einsum("eab,eqbc,edc->eqad", Ai, k, Ai)
                * det[:, None, None, None])
    J = jacobians(mesh, elems, pts)          # (n, q, d, d)
    Ji = np.linalg.inv(J)
    det = np.abs(np.linalg.det(J))           # (n, q)
    G = det[..., None, None] * np.einsum("nqab,nqcb->nqac", Ji, Ji)
    if k is None:
        return G
    if k.ndim == 2:  # scalar medium
        return k[:, :, None, None] * G
    # tensor medium: |det J| J^-1 K(x_q) J^-T per point
    return (np.einsum("nqab,nqbc,nqdc->nqad", Ji, k, Ji)
            * det[..., None, None])


def pullback_factors(mesh: Mesh, elems, pts):
    """``(J^-1, |det J|)`` of the parametric->physical map at the GLOBAL
    parametric points ``pts``: host numpy ``(n, q, d, d)`` and ``(n, q)``
    (affine meshes broadcast their per-element constants)."""
    d = mesh.dim
    nq = np.asarray(pts).shape[-2]
    if is_trilinear(mesh):
        J = jacobians(mesh, elems, pts)
    else:
        J = np.broadcast_to(mesh.jac[elems][:, None],
                            (len(elems), nq, d, d))
    return (np.ascontiguousarray(np.linalg.inv(J)),
            np.ascontiguousarray(np.abs(np.linalg.det(J))))


def fold_medium(Ji, det, k):
    """``|det J| J^-1 K J^-T`` per point on torch tensors of one device:
    ``Ji`` (n, q, d, d), ``det`` (n, q), ``k`` (n, q) scalar or
    (n, q, d, d) tensor medium."""
    if k.ndim == 2:  # scalar medium
        G = det[..., None, None] * torch.einsum("nqab,nqcb->nqac", Ji, Ji)
        return k[:, :, None, None] * G
    return (torch.einsum("nqab,nqbc,nqdc->nqad", Ji, k, Ji)
            * det[..., None, None])


def _effective_tensor_torch(mesh: Mesh, elems, k, pts):
    """:func:`effective_tensor` for a medium that lives in a torch
    tensor: the geometry factors are computed on the host in f64 and
    moved to ``k``'s device and dtype; the contraction runs there."""
    Ji, det = pullback_factors(mesh, elems, pts)
    return fold_medium(
        torch.as_tensor(Ji, dtype=k.dtype, device=k.device),
        torch.as_tensor(det, dtype=k.dtype, device=k.device), k)


def detj_phys(mesh: Mesh, elems, pts=None):
    """|det| of the parametric->physical map.  Without ``pts``: the
    per-element constant (n,) — affine meshes only.  With ``pts`` (global
    parametric, (n, q, d) or (q, d)): per point (n, q)."""
    if pts is not None:
        return np.abs(np.linalg.det(jacobians(mesh, elems, pts)))
    if is_trilinear(mesh):
        raise ValueError("trilinear geometry: detj_phys needs points")
    if not has_geometry(mesh):
        return np.ones(len(elems))
    return np.abs(np.linalg.det(mesh.jac[elems]))


def face_jacobian_factor(mesh: Mesh, elems, axis, pts=None) -> np.ndarray:
    """Nanson factor g = |det J| |J^-T e_axis|: physical face measure =
    g * parametric face measure for a face with parametric normal
    e_axis.  Per element without ``pts`` (face CENTER for trilinear
    meshes); per point (n, q) with ``pts``."""
    if pts is None:
        if is_trilinear(mesh):
            ctr = (mesh.lower[elems] + 0.5 * mesh.extent[elems])[:, None, :]
            return face_jacobian_factor(mesh, elems, axis, ctr)[:, 0]
        if not has_geometry(mesh):
            return np.ones(len(elems))
        A = mesh.jac[elems]
        Ai = np.linalg.inv(A)
        det = np.abs(np.linalg.det(A))
        axis = np.broadcast_to(np.asarray(axis), (len(elems),))
        rows = Ai[np.arange(len(elems)), axis, :]  # A^-T e_ax = A^-1[ax,:]
        return det * np.linalg.norm(rows, axis=1)
    J = jacobians(mesh, elems, pts)
    Ji = np.linalg.inv(J)
    det = np.abs(np.linalg.det(J))
    axis = np.broadcast_to(np.asarray(axis), (len(elems),))
    rows = Ji[np.arange(len(elems)), :, axis, :]   # (n, q, d)
    return det * np.linalg.norm(rows, axis=-1)


def face_penalty_geometry(mesh: Mesh, fg):
    """(fmeas_phys, inv_h_phys_in, inv_h_phys_out) for a face group,
    per-face constants (face-CENTER values for trilinear meshes — the
    penalty is a per-face-constant convention, matching the reference's
    sigma max(p)^2/|e| with one measure per edge, variableipdg.hh:253).
    """
    ein = mesh.faces.inside[fg.face_ids]
    eout = mesh.faces.outside[fg.face_ids]
    if not has_geometry(mesh):
        return fg.fmeas, fg.inv_h_in, fg.inv_h_out
    g_in = face_jacobian_factor(mesh, ein, fg.axis)
    g_out = face_jacobian_factor(mesh, eout, fg.out_axis)
    det_in = _det_center(mesh, ein)
    det_out = _det_center(mesh, eout)
    # conforming affine meshes have identical physical faces from both
    # sides; affinized curvilinear maps differ at the linearization
    # error — use the mean (symmetric, consistent)
    fmeas = 0.5 * (g_in + g_out) * fg.fmeas
    ih_in = fg.inv_h_in * g_in / det_in
    ih_out = fg.inv_h_out * g_out / det_out
    return fmeas, ih_in, ih_out


def _det_center(mesh: Mesh, elems) -> np.ndarray:
    if is_trilinear(mesh):
        ctr = (mesh.lower[elems] + 0.5 * mesh.extent[elems])[:, None, :]
        return detj_phys(mesh, elems, ctr)[:, 0]
    return detj_phys(mesh, elems)


def face_grad_jump_geometry(mesh: Mesh, fg, xp_in, xp_out):
    """Per-point geometry of the sigma1 gradient-jump stabilization
    sigma1/|f| * integral [grad u . n][grad v . n] ds on general
    (affine / trilinear / box) meshes — the geometry-generic analog of
    the reference's per-point jacobianInverseTransposed + unit-normal
    construction (variableipdg.hh:286-351; the reference takes the
    normal at the face center, here it is per quadrature point, exact
    on curved faces).

    ``xp_in`` / ``xp_out``: GLOBAL parametric face quadrature points of
    the inside / outside elements, (f, q, d).

    Returns ``(sn_in, sn_out, zs)``:

    * ``sn_in[f, q, b]`` — contraction vector such that the physical
      normal derivative of inside basis function i is
      ``sum_b Dall_in[b, i, q] * sn_in[f, q, b]`` with ``Dall`` the
      element-local (unit-cube) derivative tables:
      ``sn = (J^-1 n) / h`` per point, n the inside-side unit normal.
    * ``sn_out`` — the same for the outside element (same n).
    * ``zs[f, q]`` — physical surface measure per point EXCLUDING the
      quadrature weight (parametric face measure x Nanson factor,
      symmetric mean of the two sides);
      ``|f|_phys = (w[None, :] * zs).sum(axis=1)``.
    """
    ein = mesh.faces.inside[fg.face_ids]
    eout = mesh.faces.outside[fg.face_ids]
    ax = int(fg.axis)
    oax = int(getattr(fg, "out_axis", ax))
    sgn_in = 2 * int(getattr(fg, "in_side", 1)) - 1
    J_in = jacobians(mesh, ein, xp_in)           # (f, q, d, d)
    J_out = jacobians(mesh, eout, xp_out)
    Ji_in = np.linalg.inv(J_in)
    Ji_out = np.linalg.inv(J_out)
    nrm = sgn_in * Ji_in[:, :, ax, :]            # J^-T (+-e_ax) rows
    nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / nlen
    sn_in = (np.einsum("fqba,fqa->fqb", Ji_in, nrm)
             / mesh.extent[ein][:, None, :])
    sn_out = (np.einsum("fqba,fqa->fqb", Ji_out, nrm)
              / mesh.extent[eout][:, None, :])
    g_in = np.abs(np.linalg.det(J_in)) * nlen[..., 0]
    g_out = (np.abs(np.linalg.det(J_out))
             * np.linalg.norm(Ji_out[:, :, oax, :], axis=-1))
    zs = 0.5 * (g_in + g_out) * np.asarray(fg.fmeas)[:, None]
    return sn_in, sn_out, zs


def boundary_penalty_geometry(mesh: Mesh, bg):
    """(fmeas_phys, inv_h_phys) for a boundary group."""
    elems = mesh.bfaces.elem[bg.face_ids]
    if not has_geometry(mesh):
        return bg.fmeas, bg.inv_h
    g = face_jacobian_factor(mesh, elems, bg.axis)
    det = _det_center(mesh, elems)
    return g * bg.fmeas, bg.inv_h * g / det


def penalty_coef_mesh(mesh: Mesh, fg, penalty: float, pmax: int,
                      scaling: str = "measure") -> np.ndarray:
    """Geometry-aware face penalty coefficient c_f (= mu_f |f_phys|); for
    axis-aligned meshes identical to assemble.plan.penalty_coef."""
    if scaling == "measure":
        return penalty * pmax**2 * np.ones(len(fg.face_ids))
    if scaling == "normal":
        fmeas, ih_in, ih_out = face_penalty_geometry(mesh, fg)
        return penalty * pmax**2 * fmeas * 0.5 * (ih_in + ih_out)
    raise ValueError(scaling)


def boundary_penalty_coef_mesh(mesh: Mesh, bg, penalty: float,
                               scaling: str = "measure") -> np.ndarray:
    if scaling == "measure":
        return penalty * bg.p**2 * np.ones(len(bg.face_ids))
    if scaling == "normal":
        fmeas, ih = boundary_penalty_geometry(mesh, bg)
        return penalty * bg.p**2 * fmeas * ih
    raise ValueError(scaling)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def affine_image(mesh: Mesh, A, b=None) -> Mesh:
    """The image of a box mesh under ONE global affine map x -> A x + b
    (sheared/rotated/stretched domains; exactly conforming)."""
    A = np.asarray(A, np.float64)
    b = np.zeros(mesh.dim) if b is None else np.asarray(b, np.float64)
    n = mesh.n_elements
    return replace(mesh,
                   jac=np.broadcast_to(A, (n, mesh.dim, mesh.dim)).copy(),
                   shift=np.broadcast_to(b, (n, mesh.dim)).copy())


def affinize(mesh: Mesh, phi, dphi=None) -> Mesh:
    """Per-element affine approximation of a smooth map ``phi`` (the
    degree-1 isoparametric geometry): A_e = Dphi(center_e) (central
    finite differences unless ``dphi`` is given), shift chosen so the
    element center maps exactly.  For a globally affine ``phi`` this is
    exact and conforming; for curved maps neighboring maps disagree at
    O(h^2) on shared faces (standard first-order geometry).  Prefer
    :func:`isoparametric` for exactly conforming curved geometry."""
    c = mesh.centers()
    n, d = c.shape
    if dphi is not None:
        A = np.asarray(dphi(c), np.float64).reshape(n, d, d)
    else:
        A = np.empty((n, d, d))
        h = 1e-5 * max(float(mesh.extent.min()), 1e-3)
        for a in range(d):
            e = np.zeros(d)
            e[a] = h
            A[:, :, a] = (np.asarray(phi(c + e)) - np.asarray(phi(c - e))) \
                / (2 * h)
    shift = np.asarray(phi(c), np.float64) - np.einsum("eab,eb->ea", A, c)
    if np.linalg.det(A).min() <= 0:
        raise ValueError("affinize: map is orientation-reversing or "
                         "degenerate on some element")
    return replace(mesh, jac=A, shift=shift)


def isoparametric(mesh: Mesh, phi) -> Mesh:
    """Q1 (trilinear) isoparametric geometry: sample a smooth map ``phi``
    ((m, dim) -> (m, dim), vectorized) at the parametric box corners.
    Neighboring elements share corner values, so the geometry is EXACTLY
    conforming across every shared same-level face (the bilinear face
    interpolant is determined by the shared corners).  Build on the
    coarsest mesh and refine to keep hanging-node hierarchies conforming
    (children restrict the parent map exactly); calling this directly on
    an already-refined nc mesh re-samples phi at hanging vertices and the
    geometry differs O(h^2) across the nc interface."""
    d = mesh.dim
    B = _bits(d)
    x = (mesh.lower[:, None, :]
         + B[None, :, :] * mesh.extent[:, None, :])  # (n, nc, d) param
    corners = np.asarray(phi(x.reshape(-1, d)),
                         np.float64).reshape(x.shape)
    m = replace(mesh, corners=corners, jac=None, shift=None)
    _check_q1_orientation(m, "isoparametric")
    return m


# VTK/Gmsh hexahedron vertex ordering: bottom quad (0,1,2,3) CCW, top
# quad (4,5,6,7); reference-cell (z,y,x)-bit corners in our C-order
# convention mapped accordingly.
_VTK_CORNER_REF = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64)


def from_hex_lattice(points, cells, lattice_shape, tol: float = 1e-9
                     ) -> Mesh:
    """Import an unstructured-hex mesh (meshio/Gmsh-style arrays) whose
    cells form a structured lattice: ``points`` (npts, 3) vertex
    coordinates, ``cells`` (ncells, 8) vertex indices in VTK hexahedron
    ordering, ``lattice_shape`` the (nx, ny, nz) cell layout in C order
    (last axis fastest — the order Gmsh transfinite/structured grids
    emit).  Parallelepiped cells (affine images of the cube, to ``tol``)
    get per-element AFFINE maps; genuinely trilinear cells get Q1
    isoparametric geometry (``mesh.corners``) with per-point Jacobians.

    The parametric domain is the unit lattice; topology comes from it,
    geometry from the vertices.  Use ``meshio.read(...)`` to get the
    arrays from .msh/.vtu files when meshio is available."""
    points = np.asarray(points, np.float64)
    cells = np.asarray(cells)
    shape = tuple(int(s) for s in lattice_shape)
    n = cells.shape[0]
    if int(np.prod(shape)) != n:
        raise ValueError(f"lattice_shape {shape} does not match "
                         f"{n} cells")
    if points.shape[1] != 3 or cells.shape[1] != 8:
        raise ValueError("expected (npts, 3) points and (ncells, 8) hexes")
    corners = points[cells]  # (n, 8, 3)
    # affine fit: A columns from the three edge vectors at corner 0,
    # x_phys = v0 + A @ (ref - corner0_ref); ref coords are the VTK unit
    # cube in (x, y, z); our parametric axes are (a0, a1, a2) = (x, y, z)
    v0 = corners[:, 0]
    A = np.stack([corners[:, 1] - v0,      # d/dx
                  corners[:, 3] - v0,      # d/dy
                  corners[:, 4] - v0],     # d/dz
                 axis=-1)                  # (n, 3, 3)
    # parallelepiped check: predicted corners vs actual
    pred = v0[:, None, :] + np.einsum("eab,cb->eca", A, _VTK_CORNER_REF)
    scale = np.abs(A).sum(axis=(1, 2))[:, None, None] + 1e-30
    err = np.abs(pred - corners).max(axis=(1, 2)) / scale.reshape(-1)
    trilinear = bool((err > tol).any())
    # parametric unit lattice in C order (last axis fastest)
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                               indexing="ij"), axis=-1).reshape(-1, 3)
    lower = idx.astype(np.float64)
    extent = np.ones_like(lower)
    if trilinear:
        # reorder VTK corners into our C-order bit convention:
        # corner c has ref coords bits (x, y, z) = B[c]
        B = _bits(3)
        vtk_of_bit = np.array([int(np.where(
            (_VTK_CORNER_REF == B[c]).all(axis=1))[0][0])
            for c in range(8)])
        corn = corners[:, vtk_of_bit, :]
        m = from_boxes(lower, extent, corners=corn)
        _check_q1_orientation(m, "from_hex_lattice")
    else:
        # physical map on parametric coords x: shift + A x with
        # shift = v0 - A @ lower (per element)
        shift = v0 - np.einsum("eab,eb->ea", A, lower)
        if np.linalg.det(A).min() <= 0:
            raise ValueError("negative-volume hex (check vertex ordering)")
        m = from_boxes(lower, extent, jac=A, shift=shift)
    # conformity: shared parametric faces must map to the same physical
    # face from both sides (vertices already guarantee it for a valid
    # import; verify cheaply via the shared-face centroids)
    f = m.faces
    if len(f):
        ctr_in = _face_centroid(m, f.inside, f.axis, high=True)
        ctr_out = _face_centroid(m, f.outside, f.axis, high=False)
        dev = np.abs(ctr_in - ctr_out).max()
        if dev > 1e-8 * max(1.0, np.abs(points).max()):
            raise ValueError(f"imported hexes disagree on shared faces "
                             f"(max deviation {dev:.2e}) — the cell "
                             "array is not lattice-ordered")
    return m


_VTK_CORNER_REF_2D = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)


def from_quad_lattice(points, cells, lattice_shape, tol: float = 1e-9
                      ) -> Mesh:
    """2D analog of :func:`from_hex_lattice`: import a lattice-ordered
    quadrilateral mesh (VTK quad vertex ordering, CCW).  Parallelogram
    cells get affine maps; genuinely bilinear cells get Q1 corners."""
    points = np.asarray(points, np.float64)
    cells = np.asarray(cells)
    shape = tuple(int(s) for s in lattice_shape)
    n = cells.shape[0]
    if int(np.prod(shape)) != n:
        raise ValueError(f"lattice_shape {shape} does not match {n} cells")
    if points.shape[1] != 2 or cells.shape[1] != 4:
        raise ValueError("expected (npts, 2) points and (ncells, 4) quads")
    corners = points[cells]  # (n, 4, 2)
    v0 = corners[:, 0]
    A = np.stack([corners[:, 1] - v0, corners[:, 3] - v0], axis=-1)
    pred = v0[:, None, :] + np.einsum("eab,cb->eca", A, _VTK_CORNER_REF_2D)
    scale = np.abs(A).sum(axis=(1, 2))[:, None, None] + 1e-30
    err = np.abs(pred - corners).max(axis=(1, 2)) / scale.reshape(-1)
    bilinear = bool((err > tol).any())
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                               indexing="ij"), axis=-1).reshape(-1, 2)
    lower = idx.astype(np.float64)
    extent = np.ones_like(lower)
    if bilinear:
        B = _bits(2)
        vtk_of_bit = np.array([int(np.where(
            (_VTK_CORNER_REF_2D == B[c]).all(axis=1))[0][0])
            for c in range(4)])
        m = from_boxes(lower, extent, corners=corners[:, vtk_of_bit, :])
        _check_q1_orientation(m, "from_quad_lattice")
    else:
        shift = v0 - np.einsum("eab,eb->ea", A, lower)
        if np.linalg.det(A).min() <= 0:
            raise ValueError("negative-area quad (check vertex ordering)")
        m = from_boxes(lower, extent, jac=A, shift=shift)
    f = m.faces
    if len(f):
        ctr_in = _face_centroid(m, f.inside, f.axis, high=True)
        ctr_out = _face_centroid(m, f.outside, f.axis, high=False)
        dev = np.abs(ctr_in - ctr_out).max()
        if dev > 1e-8 * max(1.0, np.abs(points).max()):
            raise ValueError(f"imported quads disagree on shared faces "
                             f"(max deviation {dev:.2e}) — the cell "
                             "array is not lattice-ordered")
    return m


def _face_centroid(mesh: Mesh, elems, axis, high) -> np.ndarray:
    """Physical centroid of the (axis, side) face of each element;
    ``high`` is a bool (all faces same side) or a per-face side array."""
    ctr = mesh.lower[elems] + 0.5 * mesh.extent[elems]
    off = np.zeros_like(ctr)
    sgn = np.where(np.asarray(high, bool), 0.5, -0.5)
    off[np.arange(len(elems)), axis] = sgn * mesh.extent[elems, axis]
    x = (ctr + off)[:, None, :]
    return apply_map(mesh, elems, x)[:, 0]


# ---------------------------------------------------------------------
# general (non-lattice) hex/quad topology import
# ---------------------------------------------------------------------

def _frame_faces(dim: int):
    """For the bit corner convention: per (axis, side), the 4 (2 in 2D)
    corner indices of that cube face, ordered by ascending tangential
    bits (tangential axes in natural order, last fastest)."""
    B = _bits(dim).astype(np.int64)
    out = {}
    for a in range(dim):
        tang = [t for t in range(dim) if t != a]
        for s in (0, 1):
            ids = np.where(B[:, a] == s)[0]
            key = [tuple(B[c, t] for t in tang) for c in ids]
            out[(a, s)] = ids[np.lexsort(tuple(
                np.array([k[i] for k in key])
                for i in range(len(tang) - 1, -1, -1)))]
    return out


def from_cell_vertices(points, cells, tol: float = 1e-9) -> Mesh:
    """Import a GENERAL unstructured hex (3D) or quad (2D) mesh from
    vertex/cell arrays — no lattice ordering required (the non-lattice
    generalization of :func:`from_hex_lattice`; the reference reads such
    meshes into UGGrid and discretizes with
    functionspacebases/dynamicdgqkglbasis.hh, which works on any cube
    grid).

    ``points`` (npts, dim) coordinates; ``cells`` (ncells, 2^dim)
    vertex ids in VTK hexahedron/quad ordering.  Topology is derived by
    matching shared faces (sorted vertex tuples) and assigning each
    element a parametric FRAME (one of the 2^dim dim! cube symmetries,
    encoded as a corner permutation) by BFS over the face graph, so
    every interior face pairs an inside high-side with an outside
    low-side at identity tangential correspondence — the repo's Faces
    contract.  Meshes that admit no such global assignment (faces
    meeting with an odd twist) raise with the offending cell pair; 2:1
    refinements should go through mesh.adaptive instead.

    Parametric boxes are unit cubes spread along axis 0 (parametric
    positions of DIFFERENT elements are meaningless here — consumers
    must use physical coordinates, which all geometry-aware paths do).
    Affine cells get jac/shift; genuinely multilinear cells get Q1
    ``corners`` with per-point Jacobians.
    """
    points = np.asarray(points, np.float64)
    cells = np.asarray(cells)
    n, nc = cells.shape
    dim = {4: 2, 8: 3}.get(nc)
    if dim is None or points.shape[1] != dim:
        raise ValueError("expected (ncells, 4) quads with (npts, 2) "
                         "points or (ncells, 8) hexes with (npts, 3)")
    B = _bits(dim).astype(np.int64)
    ref = _VTK_CORNER_REF if dim == 3 else _VTK_CORNER_REF_2D
    vtk_of_bit = np.array([int(np.where((ref == B[c]).all(axis=1))[0][0])
                           for c in range(nc)])
    cells_bit = cells[:, vtk_of_bit]  # default frame, bit convention

    ffaces = _frame_faces(dim)
    face_keys = sorted(ffaces.keys())
    nfpc = len(face_keys)  # faces per cell = 2*dim
    fsize = nc // 2

    # --- match faces by sorted vertex tuple ---
    quads = np.stack([cells_bit[:, ffaces[k]] for k in face_keys],
                     axis=1)  # (n, 2*dim, fsize) frame-independent SETS
    skeys = np.sort(quads.reshape(n * nfpc, fsize), axis=1)
    uniqk, inv, counts = np.unique(skeys, axis=0, return_inverse=True,
                                   return_counts=True)
    if counts.max(initial=1) > 2:
        raise ValueError("a face is shared by more than two cells")
    pair_of = {}
    partner = -np.ones(n * nfpc, dtype=np.int64)
    for fi, key in enumerate(inv):
        if key in pair_of:
            partner[fi] = pair_of[key]
            partner[pair_of[key]] = fi
        else:
            pair_of[key] = fi

    # --- per-element vertex adjacency (edges of the cube) ---
    edges = [(c1, c2) for c1 in range(nc) for c2 in range(c1 + 1, nc)
             if int(np.abs(B[c1] - B[c2]).sum()) == 1]

    def neighbor_map(e):
        adj = {}
        for c1, c2 in edges:
            v1, v2 = int(cells_bit[e, c1]), int(cells_bit[e, c2])
            adj.setdefault(v1, []).append(v2)
            adj.setdefault(v2, []).append(v1)
        return adj

    # --- BFS frame assignment ---
    order = np.full((n, nc), -1, dtype=np.int64)  # corner ids, bit order
    order[0] = cells_bit[0]
    seen = np.zeros(n, bool)
    seen[0] = True
    from collections import deque
    queue = deque([0])
    tang_axes = {a: [t for t in range(dim) if t != a] for a in range(dim)}

    def face_of(order_e, vset):
        for (a, s), ids in ffaces.items():
            if {int(order_e[c]) for c in ids} == vset:
                return a, s
        return None

    while queue:
        e = queue.popleft()
        for lf in range(nfpc):
            pf = partner[e * nfpc + lf]
            if pf < 0:
                continue
            q = int(pf // nfpc)
            if seen[q]:
                # closure face of the BFS tree: any frame mismatch
                # becomes a per-face twist code below (the generality of
                # the reference's UGGrid path, dynamicdgqkglbasis.hh:
                # 36-151 — arbitrary intersection orientation)
                continue
            vset = set(int(v) for v in quads[e, lf])
            afs = face_of(order[e], vset)
            assert afs is not None
            a, s = afs
            ids_e = ffaces[(a, s)]
            ids_q = ffaces[(a, 1 - s)]
            adj = neighbor_map(q)
            oq = np.full(nc, -1, dtype=np.int64)
            ids_q_opp = ffaces[(a, s)]
            qverts = set(int(v) for v in cells_bit[q])
            if not vset <= qverts:
                raise ValueError("face matching inconsistency")
            for ce, cq, cq_opp in zip(ids_e, ids_q, ids_q_opp):
                v = int(order[e][ce])
                oq[cq] = v
                others = [u for u in adj[v] if u not in vset]
                if len(others) != 1:
                    raise ValueError(
                        f"cell {q}: vertex {v} has {len(others)} "
                        "off-face edges (degenerate hex)")
                oq[cq_opp] = others[0]
            if sorted(int(v) for v in oq) != sorted(qverts):
                raise ValueError(
                    f"cell {q}: face-aligned frame propagation does not "
                    "reach all vertices (degenerate connectivity)")
            order[q] = oq
            seen[q] = True
            queue.append(q)
    if not seen.all():
        raise ValueError("hex mesh has disconnected components "
                         f"({int((~seen).sum())} unreachable cells)")

    # --- faces/bfaces from the assigned frames ---
    # Each matched pair is processed once; BFS-tree faces come out with
    # identity codes, closure faces may carry (out_axis, out_side,
    # twist) ≠ defaults — meshes with singular edges / odd face twists
    # import instead of raising.
    fin, fout, fax = [], [], []
    fis, foa, fos, ftw = [], [], [], []
    bel, bax, bsd = [], [], []
    for fi in range(n * nfpc):
        e = fi // nfpc
        pf = int(partner[fi])
        vset = set(int(v) for v in quads[e, fi % nfpc])
        if pf < 0:
            a, s = face_of(order[e], vset)
            bel.append(e)
            bax.append(a)
            bsd.append(s)
            continue
        if pf < fi:
            continue  # pair already handled from its lower index
        q = int(pf // nfpc)
        a_e, s_e = face_of(order[e], vset)
        a_q, s_q = face_of(order[q], vset)
        # inside = the element that sees the face on its HIGH side when
        # exactly one does (the classic contract); otherwise keep e
        # inside and record in_side
        if s_e == 1 or s_q != 1:
            ein, eout = e, q
            a_in, s_in, a_out, s_out = a_e, s_e, a_q, s_q
        else:
            ein, eout = q, e
            a_in, s_in, a_out, s_out = a_q, s_q, a_e, s_e
        tw = _face_twist_code(order[ein], order[eout], a_in, s_in,
                              a_out, s_out, ffaces, dim, ein, eout)
        fin.append(ein)
        fout.append(eout)
        fax.append(a_in)
        fis.append(s_in)
        foa.append(a_out)
        fos.append(s_out)
        ftw.append(tw)
    faces = Faces(inside=np.asarray(fin, np.int32),
                  outside=np.asarray(fout, np.int32),
                  axis=np.asarray(fax, np.int32),
                  in_side=np.asarray(fis, np.int32),
                  out_axis=np.asarray(foa, np.int32),
                  out_side=np.asarray(fos, np.int32),
                  twist=np.asarray(ftw, np.int32))
    bfaces = BoundaryFaces(elem=np.asarray(bel, np.int32),
                           axis=np.asarray(bax, np.int32),
                           side=np.asarray(bsd, np.int32))
    return _mesh_from_frames(points, order, faces, bfaces, dim, tol)


def _face_twist_code(ord_in, ord_out, a_in, s_in, a_out, s_out, ffaces,
                     dim, ein, eout) -> int:
    """Tangential isometry code of a matched face pair (Faces.twist).

    Inside-face corners are indexed by their tangential bits
    ``k = b0 * 2 + b1`` (natural tangential-axis order, last fastest,
    matching _frame_faces); the shared vertices induce a corner map into
    the outside face whose bit form must be an isometry of the square
    (segment in 2D): ``c = flip(swap(b))``.  Encodes
    ``swap*4 + flip1*2 + flip0`` (2D: just flip).  Raises for
    non-isometric pairings (degenerate cells)."""
    vin = [int(ord_in[c]) for c in ffaces[(a_in, s_in)]]
    vout = [int(ord_out[c]) for c in ffaces[(a_out, s_out)]]
    pos = {v: k for k, v in enumerate(vout)}
    pi = [pos[v] for v in vin]
    if dim == 2:
        return 0 if pi[0] == 0 else 1
    bits = [(pi[k] >> 1, pi[k] & 1) for k in range(4)]
    c00 = bits[0]
    d01 = (bits[1][0] ^ c00[0], bits[1][1] ^ c00[1])
    d10 = (bits[2][0] ^ c00[0], bits[2][1] ^ c00[1])
    exp11 = (c00[0] ^ d10[0] ^ d01[0], c00[1] ^ d10[1] ^ d01[1])
    if bits[3] != exp11 or sorted((d01, d10)) != [(0, 1), (1, 0)]:
        raise ValueError(
            f"cells {ein} and {eout} meet with a non-isometric face "
            "corner pairing (degenerate cell)")
    swap = 1 if d10 == (0, 1) else 0
    flip0, flip1 = c00
    return swap * 4 + flip1 * 2 + flip0


def _mesh_from_frames(points, order, faces, bfaces, dim, tol) -> Mesh:
    """Geometry tail of from_cell_vertices: per-element affine fit or Q1
    corners from the frame-ordered corner coordinates, disjoint unit
    parametric charts, physical conformity check."""
    n = order.shape[0]
    # --- geometry from the framed corners ---
    corn = points[order]  # (n, 2^dim, dim) bit order
    v0 = corn[:, 0]
    cols = [corn[:, 1 << (dim - 1 - a)] - v0 for a in range(dim)]
    A = np.stack(cols, axis=-1)
    pred = v0[:, None, :] + np.einsum("eab,cb->eca", A, _bits(dim))
    scale = np.abs(A).sum(axis=(1, 2))[:, None, None] + 1e-30
    err = np.abs(pred - corn).max(axis=(1, 2)) / scale.reshape(-1)
    multilinear = bool((err > tol).any())
    lower = np.zeros((n, dim))
    lower[:, 0] = 2.0 * np.arange(n)  # disjoint parametric boxes
    extent = np.ones_like(lower)
    if multilinear:
        m = Mesh(dim=dim, lower=lower, extent=extent, faces=faces,
                 bfaces=bfaces, corners=corn)
        _check_q1_orientation(m, "from_cell_vertices")
    else:
        if np.linalg.det(A).min() <= 0:
            raise ValueError("negative-volume cell (check vertex order)")
        shift = v0 - np.einsum("eab,eb->ea", A, lower)
        m = Mesh(dim=dim, lower=lower, extent=extent, faces=faces,
                 bfaces=bfaces, jac=A, shift=shift)
    # physical conformity: both sides of every face must agree
    # (centroids are twist-invariant, so this also validates faces with
    # non-default charts)
    f = m.faces
    if len(f):
        ctr_in = _face_centroid(m, f.inside, f.axis, f.in_side == 1)
        ctr_out = _face_centroid(m, f.outside, f.out_axis,
                                 f.out_side == 1)
        dev = np.abs(ctr_in - ctr_out).max()
        if dev > 1e-8 * max(1.0, np.abs(points).max()):
            raise ValueError("imported cells disagree on shared faces "
                             f"(max deviation {dev:.2e})")
    return m
