"""Axis-aligned cube meshes as plain connectivity arrays.

Port of ``hpdg_tpu.mesh.structured`` for box meshes (host-side numpy):
a mesh is a set of static arrays — per-element ``lower``/``extent``
boxes plus precomputed interior and boundary face lists — built once on
the host.  First-class general geometry is layered on top as mesh data:
per-element affine maps (``jac``/``shift``) or genuinely trilinear Q1
corner interpolation (``corners``), see ``mesh/geometry.py``; the
parametric boxes stay the topology carrier.  The native C++ face matcher
waits for a later item of the port (ROADMAP).

Interior faces are stored with the convention: the *inside* element is on
the low side of the face, so the unit normal (pointing inside->outside)
is always +e_axis.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from hpdg_tpu_torch import native


@dataclass(frozen=True)
class Faces:
    """Interior faces.  Normal = +e_axis, inside on the low side.

    ``nc_code`` encodes non-conforming (hanging-node) faces from 2:1
    refinement: 0 = conforming; otherwise
    ``1 + subpos + 2^(dim-1) * coarse_is_outside`` (see
    ``hpdg_tpu.mesh.structured.Faces``).

    General (twist-tolerant) face charts: the defaults encode the
    classic contract above; unstructured imports whose cells meet with
    twisted faces (``geometry.from_cell_vertices``) fill them per face.
    ``in_side`` is the side of the INSIDE element's axis the face is on
    (the shared normal is ``(2*in_side - 1) * e_axis`` in the inside
    chart); ``out_axis``/``out_side`` give the face in the OUTSIDE
    element's chart; ``twist`` is the tangential isometry code mapping
    inside-face coordinates u to outside-face coordinates v: in 2D
    ``twist`` in {0,1} = flip; in 3D ``twist = swap*4 + flip1*2 + flip0``
    with ``(w0, w1) = (u1, u0) if swap else (u0, u1)`` and
    ``v_t = 1 - w_t if flip_t else w_t``.  0 = identity (classic).
    """

    inside: np.ndarray  # (nf,) int32 element index
    outside: np.ndarray  # (nf,) int32
    axis: np.ndarray  # (nf,) int32 normal axis (inside chart)
    nc_code: np.ndarray = None  # (nf,) int32, 0 = conforming
    in_side: np.ndarray = None  # (nf,) int32, default 1 (high)
    out_axis: np.ndarray = None  # (nf,) int32, default = axis
    out_side: np.ndarray = None  # (nf,) int32, default 0 (low)
    twist: np.ndarray = None  # (nf,) int32 isometry code, default 0

    def __post_init__(self):
        nf = len(self.inside)
        if self.nc_code is None:
            object.__setattr__(self, "nc_code",
                               np.zeros(nf, dtype=np.int32))
        if self.in_side is None:
            object.__setattr__(self, "in_side",
                               np.ones(nf, dtype=np.int32))
        if self.out_axis is None:
            object.__setattr__(self, "out_axis",
                               np.asarray(self.axis, np.int32).copy())
        if self.out_side is None:
            object.__setattr__(self, "out_side",
                               np.zeros(nf, dtype=np.int32))
        if self.twist is None:
            object.__setattr__(self, "twist",
                               np.zeros(nf, dtype=np.int32))

    @property
    def is_classic(self) -> bool:
        """True iff every face follows the classic identity contract
        (in high / out low on the same axis, no twist)."""
        return bool(np.all(self.in_side == 1)
                    and np.array_equal(self.out_axis, self.axis)
                    and np.all(self.out_side == 0)
                    and np.all(self.twist == 0))

    def __len__(self):
        return len(self.inside)


def require_classic_faces(mesh, what: str) -> None:
    """Guard for code paths that assume the classic identity face
    contract.  The scalar IPDG pipeline (``assemble.sipg``, the
    sum-factorized apply) handles generalized charts; paths that do not
    thread (in_side, out_axis, out_side, twist) raise here instead of
    silently mis-assembling."""
    if not mesh.faces.is_classic:
        raise NotImplementedError(
            f"{what}: mesh has twisted/generalized face charts "
            "(unstructured import with odd face orientation). "
            "Supported there: assemble.assemble_laplace, "
            "matrixfree.sipg_operator, the assembled matvec and "
            "Krylov solvers.")


@dataclass(frozen=True)
class BoundaryFaces:
    elem: np.ndarray  # (nbf,) int32
    axis: np.ndarray  # (nbf,) int32
    side: np.ndarray  # (nbf,) int32: 0 = low face, 1 = high face

    def __len__(self):
        return len(self.elem)


@dataclass(frozen=True)
class Mesh:
    dim: int
    lower: np.ndarray  # (n, dim) float64 element lower corners
    extent: np.ndarray  # (n, dim) float64 element extents per axis
    faces: Faces
    bfaces: BoundaryFaces
    # refinement hierarchy links (None for a base mesh)
    parent: np.ndarray | None = None  # (n,) int32 index into the parent mesh
    child_pos: np.ndarray | None = None  # (n,) int32 in [0, 2^dim)
    parent_mesh: "Mesh | None" = None  # the mesh ``parent`` indexes into
    # first-class affine geometry: the physical position of a parametric
    # point x inside element e is  shift[e] + jac[e] @ x.  None =
    # axis-aligned boxes (physical == parametric), the default.
    jac: np.ndarray | None = None    # (n, dim, dim) float64
    shift: np.ndarray | None = None  # (n, dim) float64
    # trilinear (isoparametric Q1) geometry: physical corner positions of
    # each element's parametric box, corner index c with bit
    # (c >> (dim-1-a)) & 1 giving the high/low side along axis a (C
    # order, last axis fastest: the convention of refine()'s child_pos).
    # When set, the per-point Jacobian of the multilinear corner
    # interpolation replaces the constant jac/shift map.
    corners: np.ndarray | None = None  # (n, 2^dim, dim) float64

    @property
    def n_elements(self) -> int:
        return self.lower.shape[0]

    @property
    def volumes(self) -> np.ndarray:
        vols = np.prod(self.extent, axis=1)
        if self.corners is not None:
            from hpdg_tpu_torch.mesh import geometry as _geo
            return vols * _geo.mean_detj_q1(self)
        if self.jac is not None:
            vols = vols * np.abs(np.linalg.det(self.jac))
        return vols

    def face_measure(self) -> np.ndarray:
        """Measure of each interior face = measure of the intersection
        (the FINE face for non-conforming pairs): length in 2D, area 3D."""
        ext = np.minimum(self.extent[self.faces.inside],
                         self.extent[self.faces.outside])
        mask = np.ones_like(ext, dtype=bool)
        mask[np.arange(len(self.faces)), self.faces.axis] = False
        return np.where(mask, ext, 1.0).prod(axis=1)

    def bface_measure(self) -> np.ndarray:
        ext = self.extent[self.bfaces.elem]
        mask = np.ones_like(ext, dtype=bool)
        mask[np.arange(len(self.bfaces)), self.bfaces.axis] = False
        return np.where(mask, ext, 1.0).prod(axis=1)

    def centers(self) -> np.ndarray:
        return self.lower + 0.5 * self.extent


def _build_faces(lower: np.ndarray, extent: np.ndarray) -> tuple[Faces, BoundaryFaces]:
    """Match conforming faces by quantized geometric keys (vectorized)."""
    n, dim = lower.shape
    tol = extent.min() * 1e-6
    scale = 1.0 / tol

    ins, outs, axs, ncs = [], [], [], []
    be, ba, bs = [], [], []
    for axis in range(dim):
        tang = [a for a in range(dim) if a != axis]
        # key per (elem, side): (plane coordinate, tangential lower, tangential extent)
        plane_low = lower[:, axis]
        plane_high = lower[:, axis] + extent[:, axis]
        keys = np.zeros((2 * n, 1 + 2 * len(tang)), dtype=np.int64)
        keys[:n, 0] = np.rint(plane_high * scale)  # high face of elem (elem is LOW side)
        keys[n:, 0] = np.rint(plane_low * scale)  # low face of elem (elem is HIGH side)
        for k, a in enumerate(tang):
            col = np.rint(lower[:, a] * scale)
            ecol = np.rint(extent[:, a] * scale)
            keys[:n, 1 + 2 * k] = col
            keys[n:, 1 + 2 * k] = col
            keys[:n, 2 + 2 * k] = ecol
            keys[n:, 2 + 2 * k] = ecol
        uniq, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                                      return_counts=True)
        order = np.argsort(inv, kind="stable")
        # walk groups: count==2 -> interior (one from each half), count==1 -> boundary
        grp_starts = np.concatenate([[0], np.cumsum(counts)])
        two = counts == 2
        # for interior groups the two members are (elem_low from first half, elem_high from second half)
        starts2 = grp_starts[:-1][two]
        m0 = order[starts2]
        m1 = order[starts2 + 1]
        # ensure m_low from first half (high face of low element)
        lo = np.where(m0 < n, m0, m1)
        hi = np.where(m0 < n, m1, m0)
        if len(lo):
            assert (lo < n).all() and (hi >= n).all(), \
                "two coincident faces on the same side"
        ins.append(lo.astype(np.int32))
        outs.append((hi - n).astype(np.int32))
        axs.append(np.full(len(lo), axis, dtype=np.int32))
        ncs.append(np.zeros(len(lo), dtype=np.int32))

        # ---- leftovers: try 2:1 non-conforming matches, else boundary ----
        one = counts == 1
        starts1 = grp_starts[:-1][one]
        mb = order[starts1]
        # record: (entry id, plane key, tang lower keys, tang ext keys)
        plane = keys[mb, 0]
        tlow = keys[mb, 1::2]
        text = keys[mb, 2::2]
        # FLOAT tangential data for probe-key construction: the probe must
        # quantize the float arithmetic (rint((tl - bit*te)*s),
        # rint(2*te*s)), NOT do integer arithmetic on quantized values —
        # rint(2x*s) != 2*rint(x*s) for extents like 1/3, which silently
        # broke valid 2:1 matches
        tlowf = lower[mb % n][:, tang]
        textf = extent[mb % n][:, tang]
        # big-face lookup: (plane, half, lower..., ext...) -> leftover idx
        lookup = {}
        for k in range(len(mb)):
            half = 0 if mb[k] < n else 1
            lookup[(plane[k], half) + tuple(tlow[k]) + tuple(text[k])] = k
        matched = np.zeros(len(mb), dtype=bool)  # matched as the small side
        used_big = np.zeros(len(mb), dtype=bool)  # used as the coarse side
        nt = len(tang)
        for k in range(len(mb)):
            half = 0 if mb[k] < n else 1
            # small face: look for a containing big face on the OTHER half
            # (a big face pairs with up to 2^(dim-1) small faces)
            for sub in range(2**nt):
                bits = [(sub >> (nt - 1 - t)) & 1 for t in range(nt)]
                big_low = tuple(int(np.rint(
                    (tlowf[k, t] - bits[t] * textf[k, t]) * scale))
                    for t in range(nt))
                big_ext = tuple(int(np.rint(2.0 * textf[k, t] * scale))
                                for t in range(nt))
                kk = lookup.get((plane[k], 1 - half) + big_low + big_ext)
                if kk is not None:
                    matched[k] = True
                    used_big[kk] = True
                    small, big = mb[k], mb[kk]
                    if half == 0:  # small is the high face of a low elem
                        e_in, e_out = small, big - n
                        coarse_is_outside = 1
                    else:
                        e_in, e_out = big, small - n
                        coarse_is_outside = 0
                    code = 1 + sub + (2**nt) * coarse_is_outside
                    ins.append(np.array([e_in % n], dtype=np.int32))
                    outs.append(np.array([e_out % n], dtype=np.int32))
                    axs.append(np.array([axis], dtype=np.int32))
                    ncs.append(np.array([code], dtype=np.int32))
                    break
        for k in range(len(mb)):
            if not matched[k] and not used_big[k]:
                be.append(np.array([mb[k] % n], dtype=np.int32))
                ba.append(np.array([axis], dtype=np.int32))
                bs.append(np.array([1 if mb[k] < n else 0], dtype=np.int32))

    faces = Faces(np.concatenate(ins), np.concatenate(outs),
                  np.concatenate(axs), np.concatenate(ncs))
    bfaces = BoundaryFaces(
        np.concatenate(be) if be else np.zeros(0, np.int32),
        np.concatenate(ba) if ba else np.zeros(0, np.int32),
        np.concatenate(bs) if bs else np.zeros(0, np.int32))
    return faces, bfaces


def _validate_unmatched(lower, extent, bfaces: BoundaryFaces, tol: float):
    """Raise if any two opposite-facing "boundary" faces overlap on a
    common plane — that means two elements touch there but the matcher
    could not pair them (4:1 level jump or non-2:1 box input), which
    would otherwise silently turn interior faces into spurious domain
    boundary (wrong physics)."""
    if len(bfaces) == 0:
        return
    dim = lower.shape[1]
    elem, axis, side = bfaces.elem, bfaces.axis, bfaces.side
    plane = lower[elem, axis] + side * extent[elem, axis]
    pkey = np.rint(plane / tol).astype(np.int64)
    tang_axes = [[a for a in range(dim) if a != ax] for ax in range(dim)]
    # group by (axis, quantized plane); only mixed-side groups can hide
    # an unmatched interior pair
    codes = axis.astype(np.int64) * (2**62 // max(dim, 1)) + pkey
    for code in np.unique(codes):
        sel = np.where(codes == code)[0]
        s1 = sel[side[sel] == 1]
        s0 = sel[side[sel] == 0]
        if len(s1) == 0 or len(s0) == 0:
            continue
        ta = tang_axes[int(axis[sel[0]])]
        lo1 = lower[elem[s1]][:, ta]
        hi1 = lo1 + extent[elem[s1]][:, ta]
        lo0 = lower[elem[s0]][:, ta]
        hi0 = lo0 + extent[elem[s0]][:, ta]
        # pairwise tangential-box overlap (high-side faces vs low-side)
        omin = np.maximum(lo1[:, None, :], lo0[None, :, :])
        omax = np.minimum(hi1[:, None, :], hi0[None, :, :])
        bad = np.all(omax - omin > tol, axis=-1)
        if bad.any():
            i, j = np.argwhere(bad)[0]
            raise ValueError(
                "mesh topology: elements "
                f"{int(elem[s1[i]])} and {int(elem[s0[j]])} touch on axis "
                f"{int(axis[sel[0]])} but their faces could not be matched "
                "(only conforming and 2:1 hanging-node faces are "
                "supported; check for >2:1 level jumps or non-2:1 box "
                "sizes, or pass validate=False to skip this check)")


def from_boxes(lower: np.ndarray, extent: np.ndarray, parent=None,
               child_pos=None, parent_mesh=None,
               topology: str = "auto", validate: bool = True,
               jac=None, shift=None, corners=None) -> Mesh:
    """Mesh of axis-aligned boxes.  ``topology``: "auto" (the native C++
    face matcher for 4096 or more elements when ``g++`` is available and
    ``HPDG_NATIVE_TOPOLOGY`` is not "0"; it may order the faces
    differently), "native" (raises without ``g++``), or "python" (the
    numpy matcher).  ``validate`` checks that no unmatched faces look
    interior (overlapping opposite-facing "boundary" faces) and raises
    instead of producing wrong physics."""
    lower = np.asarray(lower, dtype=np.float64)
    extent = np.asarray(extent, dtype=np.float64)
    # quantized face keys divide by extent.min(): non-finite coordinates
    # or degenerate boxes would corrupt the face matching silently
    if not (np.isfinite(lower).all() and np.isfinite(extent).all()):
        raise ValueError("mesh geometry contains non-finite values")
    if extent.size and extent.min() <= 0:
        raise ValueError("mesh elements must have positive extent "
                         f"(min extent = {extent.min()!r})")
    if topology not in ("auto", "native", "python"):
        raise ValueError(f"topology must be 'auto', 'native' or 'python', "
                         f"got {topology!r}")
    use_native = topology == "native" or (
        topology == "auto"
        and os.environ.get("HPDG_NATIVE_TOPOLOGY", "1") != "0"
        and lower.shape[0] >= 4096 and native.available())
    if use_native:
        fi, fo, fa, fn, be, ba, bs = native.build_faces(
            lower, extent, float(extent.min() * 1e-6))
        faces, bfaces = Faces(fi, fo, fa, fn), BoundaryFaces(be, ba, bs)
    else:
        faces, bfaces = _build_faces(lower, extent)
    if validate:
        _validate_unmatched(lower, extent, bfaces, float(extent.min() * 1e-6))
    return Mesh(dim=lower.shape[1], lower=lower, extent=extent, faces=faces,
                bfaces=bfaces, parent=parent, child_pos=child_pos,
                parent_mesh=parent_mesh, jac=jac, shift=shift,
                corners=corners)


def structured(cells, lower=None, upper=None, mask=None) -> Mesh:
    """Structured box mesh with ``cells`` elements per axis.

    ``mask`` (bool array of shape ``cells``) keeps only selected cells.
    Element order is C order over the lattice (last axis fastest), masked
    cells skipped.
    """
    cells = tuple(int(c) for c in cells)
    dim = len(cells)
    lo = np.zeros(dim) if lower is None else np.asarray(lower, dtype=np.float64)
    hi = np.ones(dim) if upper is None else np.asarray(upper, dtype=np.float64)
    h = (hi - lo) / np.asarray(cells)
    idx = np.stack(np.meshgrid(*[np.arange(c) for c in cells], indexing="ij"),
                   axis=-1).reshape(-1, dim)
    if mask is not None:
        keep = np.asarray(mask, dtype=bool).reshape(-1)
        idx = idx[keep]
    lowers = lo[None, :] + idx * h[None, :]
    extents = np.broadcast_to(h, lowers.shape).copy()
    return from_boxes(lowers, extents)


def lshape(n: int) -> Mesh:
    """L-shaped domain [-1,1]^2 minus the open quadrant (0,1)x(-1,0),
    with 2n x 2n base cells (the classic re-entrant corner benchmark)."""
    xs = (np.arange(2 * n) + 0.5) / n - 1.0  # cell centres in (-1, 1)
    cx, cy = np.meshgrid(xs, xs, indexing="ij")
    mask = ~((cx > 0) & (cy < 0))
    return structured((2 * n, 2 * n), lower=(-1.0, -1.0), upper=(1.0, 1.0),
                      mask=mask)


def refine(mesh: Mesh, marks: np.ndarray | None = None) -> Mesh:
    """Uniform (marks=None) refinement: each element splits into 2^dim
    children, renumbered in lattice C order (last axis fastest).  Local
    refinement waits for the port of ``mesh.adaptive``.
    """
    if marks is not None:
        raise NotImplementedError("local refinement lives in mesh.adaptive")
    n, dim = mesh.lower.shape
    nc = 2**dim
    bits = ((np.arange(nc)[:, None] >> np.arange(dim - 1, -1, -1)[None, :]) & 1)
    child_extent = np.repeat(mesh.extent, nc, axis=0) * 0.5
    offset = bits[None, :, :] * (mesh.extent[:, None, :] * 0.5)
    child_lower = (mesh.lower[:, None, :] + offset).reshape(-1, dim)
    parent = np.repeat(np.arange(n, dtype=np.int32), nc)
    child_pos = np.tile(np.arange(nc, dtype=np.int32), n)
    # re-number children in coordinate (lattice C-) order so uniformly
    # refined hierarchies keep the lattice element numbering that the
    # stencil kernel's neighbour strides rely on (ops.uniform_stencil)
    q = np.rint(child_lower / (child_extent.min() * 0.5)).astype(np.int64)
    order = np.lexsort(tuple(q[:, a] for a in range(dim - 1, -1, -1)))
    # children inherit the parent's affine map verbatim (the parametric
    # child box is a subset of the parent box, so the same map applies)
    jac = shift = corners = None
    if mesh.jac is not None:
        jac = np.repeat(mesh.jac, nc, axis=0)[order]
        shift = np.repeat(mesh.shift, nc, axis=0)[order]
    if mesh.corners is not None:
        # a trilinear map restricted to a child sub-box is trilinear with
        # corner values = parent map evaluated at the child's corners
        from hpdg_tpu_torch.mesh import geometry as _geo
        corners = _geo.q1_child_corners(
            mesh.corners, parent, child_pos)[order]
    return from_boxes(child_lower[order], child_extent[order],
                      parent=parent[order], child_pos=child_pos[order],
                      parent_mesh=mesh, jac=jac, shift=shift,
                      corners=corners)


def hierarchy(base: Mesh, levels: int) -> list[Mesh]:
    """Uniformly refined mesh hierarchy [coarsest, ..., finest]."""
    meshes = [base]
    for _ in range(levels):
        meshes.append(refine(meshes[-1]))
    return meshes
