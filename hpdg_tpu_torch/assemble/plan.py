"""Host-side assembly planning: sparsity pattern + face/boundary groups.

Port of ``hpdg_tpu.assemble.plan`` (host-side numpy): all faces are
grouped by (degree_in, degree_out, axis, chart codes) so every group is
one fixed-shape batch, and every contribution is assigned a static
*slot* into the per-(p_row, p_col) block-value arrays up front.

Pattern layout invariant: in bucket (p, p) the first n_p slots are the
diagonal blocks in bucket order (slot of block (r, r) == r); face-driven
off-diagonal blocks follow in group order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg.blockmatrix import BlockPattern


@dataclass(frozen=True)
class FaceGroup:
    p_in: int
    p_out: int
    axis: int
    face_ids: np.ndarray  # indices into mesh.faces
    in_pos: np.ndarray  # bucket positions of inside elements
    out_pos: np.ndarray
    fmeas: np.ndarray  # face measures (of the intersection = fine face)
    inv_h_in: np.ndarray  # 1 / extent[inside, axis]
    inv_h_out: np.ndarray  # 1 / extent[outside, out_axis]
    slot12: np.ndarray  # slots into values[(p_in, p_out)]
    slot21: np.ndarray  # slots into values[(p_out, p_in)]
    # M11 slot == in_pos (diagonal), M22 slot == out_pos.
    nc_code: int = 0  # 0 conforming; else hanging-node sub-face code
    # generalized face charts (mesh.structured.Faces): defaults = the
    # classic identity contract; twisted unstructured imports differ
    in_side: int = 1
    out_axis: int = -1  # -1 sentinel -> same as ``axis``
    out_side: int = 0
    twist: int = 0  # tangential isometry code (Faces.twist)

    def __post_init__(self):
        if self.out_axis < 0:
            object.__setattr__(self, "out_axis", self.axis)

    def tang_maps(self, dim: int):
        """(tang_map_in, tang_map_out) for tensor.face_tables."""
        if self.nc_code == 0:
            return None, None
        nt = dim - 1
        sub = (self.nc_code - 1) % (2**nt)
        coarse_out = (self.nc_code - 1) // (2**nt)
        bits = [(sub >> (nt - 1 - t)) & 1 for t in range(nt)]
        m = tuple((0.5 * b, 0.5) for b in bits)
        return (None, m) if coarse_out else (m, None)

    def twist_map(self, pts: np.ndarray) -> np.ndarray:
        """Outside-chart tangential coordinates of the inside-chart
        face points ``pts`` (nq, dim-1) under this group's twist code
        (Faces.twist encoding)."""
        return apply_twist(pts, self.twist)


def apply_twist(pts: np.ndarray, twist: int) -> np.ndarray:
    """v = g(u) for the Faces.twist isometry encoding: 2D flip in {0,1};
    3D ``swap*4 + flip1*2 + flip0`` (swap tangential axes first, then
    per-axis flips t -> 1-t)."""
    pts = np.asarray(pts)
    nt = pts.shape[1]
    if twist == 0:
        return pts
    if nt == 1:
        return 1.0 - pts if twist else pts
    swap, fl1, fl0 = (twist >> 2) & 1, (twist >> 1) & 1, twist & 1
    w = pts[:, ::-1] if swap else pts
    out = np.empty_like(w)
    out[:, 0] = 1.0 - w[:, 0] if fl0 else w[:, 0]
    out[:, 1] = 1.0 - w[:, 1] if fl1 else w[:, 1]
    return out



@dataclass(frozen=True)
class BoundaryGroup:
    p: int
    axis: int
    side: int  # 0 = low face (normal -e_axis), 1 = high face (+e_axis)
    face_ids: np.ndarray
    pos: np.ndarray  # bucket positions of the boundary elements
    fmeas: np.ndarray
    inv_h: np.ndarray


@dataclass(frozen=True)
class AssemblyPlan:
    basis: DGBasis
    pattern: BlockPattern
    face_groups: tuple
    boundary_groups: tuple


def build_plan(basis: DGBasis) -> AssemblyPlan:
    mesh = basis.mesh
    deg = basis.degrees
    faces = mesh.faces
    nf = len(faces)

    # pattern accumulators: start with the diagonal of every bucket
    rows = {}
    cols = {}
    row_sizes = {p: basis.bucket_size(p) for p in basis.bucket_degrees}
    for p in basis.bucket_degrees:
        n = basis.bucket_size(p)
        rows[(p, p)] = [np.arange(n, dtype=np.int32)]
        cols[(p, p)] = [np.arange(n, dtype=np.int32)]
    counters = {k: row_sizes[k[0]] for k in rows}

    fmeas_all = mesh.face_measure()
    face_groups = []
    if nf:
        # group faces by (deg_in, deg_out, axis, nc_code, chart codes)
        # via ONE int64 key sort — same lexicographic group order as
        # np.unique(axis=0) but ~10x faster at 1e6 faces (no void-dtype
        # comparisons).  The chart codes (in_side/out_axis/out_side/
        # twist) are all 0-defaults on classic meshes, so classic group
        # keys and order are unchanged.
        chart = (((faces.in_side.astype(np.int64) * 16 + faces.out_axis)
                  * 2 + faces.out_side) * 8 + faces.twist)
        key = ((((deg[faces.inside].astype(np.int64) * 256
                  + deg[faces.outside]) * 16 + faces.axis) * 256
                + faces.nc_code) * 512 + chart)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        starts = np.concatenate([[0], np.flatnonzero(np.diff(ks)) + 1,
                                 [nf]])
        for g in range(len(starts) - 1):
            fids = order[starts[g]:starts[g + 1]].astype(np.int32)
            fids.sort()
            kk = int(ks[starts[g]])
            ch = kk % 512
            tw = ch % 8
            oside = (ch // 8) % 2
            oax = (ch // 16) % 16
            iside = ch // 256
            kk //= 512
            ncc = kk % 256
            ax = (kk // 256) % 16
            po = (kk // (256 * 16)) % 256
            pi = kk // (256 * 16 * 256)
            ein = faces.inside[fids]
            eout = faces.outside[fids]
            in_pos = basis.elem_bucket_pos[ein]
            out_pos = basis.elem_bucket_pos[eout]

            def _alloc(key, r, c):
                if key not in rows:
                    rows[key], cols[key] = [], []
                    counters[key] = 0
                start = counters[key]
                rows[key].append(r.astype(np.int32))
                cols[key].append(c.astype(np.int32))
                counters[key] = start + len(r)
                return start + np.arange(len(r), dtype=np.int32)

            slot12 = _alloc((pi, po), in_pos, out_pos)
            slot21 = _alloc((po, pi), out_pos, in_pos)
            face_groups.append(FaceGroup(
                p_in=pi, p_out=po, axis=ax, face_ids=fids,
                in_pos=in_pos, out_pos=out_pos,
                fmeas=fmeas_all[fids],
                inv_h_in=1.0 / mesh.extent[ein, ax],
                inv_h_out=1.0 / mesh.extent[eout, oax],
                slot12=slot12, slot21=slot21, nc_code=ncc,
                in_side=iside, out_axis=oax, out_side=oside, twist=tw,
            ))

    bmeas_all = mesh.bface_measure()
    boundary_groups = []
    if len(mesh.bfaces):
        bkey = ((deg[mesh.bfaces.elem].astype(np.int64) * 16
                 + mesh.bfaces.axis) * 2 + mesh.bfaces.side)
        border = np.argsort(bkey, kind="stable")
        bs_ = bkey[border]
        bstarts = np.concatenate([[0], np.flatnonzero(np.diff(bs_)) + 1,
                                  [len(bs_)]])
        for g in range(len(bstarts) - 1):
            fids = border[bstarts[g]:bstarts[g + 1]].astype(np.int32)
            fids.sort()
            kk = int(bs_[bstarts[g]])
            side = kk % 2
            ax = (kk // 2) % 16
            p = kk // 32
            elems = mesh.bfaces.elem[fids]
            boundary_groups.append(BoundaryGroup(
                p=p, axis=ax, side=side, face_ids=fids,
                pos=basis.elem_bucket_pos[elems],
                fmeas=bmeas_all[fids],
                inv_h=1.0 / mesh.extent[elems, ax],
            ))

    entries = {
        k: (np.concatenate(rows[k]), np.concatenate(cols[k])) for k in rows
    }
    col_sizes = dict(row_sizes)
    pattern = BlockPattern(row_sizes, col_sizes, entries)
    return AssemblyPlan(basis=basis, pattern=pattern,
                        face_groups=tuple(face_groups),
                        boundary_groups=tuple(boundary_groups))


def face_group_tables(basis, fg: FaceGroup, nq1: int):
    """Trace tables for both sides of a face group, with the hanging-node
    sub-face mapping applied to the coarse side (if any).

    Generalized face charts (twisted unstructured imports): the inside
    tables come from face (axis, in_side), the outside tables from
    (out_axis, out_side) with the twist isometry applied as a
    quadrature-point permutation (tensor Gauss rules are closed under
    the face isometries), so column q of BOTH tables refers to the same
    physical point.  ``Dn`` is returned SIGNED along the shared normal
    (pointing inside -> outside) in each element's own chart — the
    classic contract (in high / out low, same axis) keeps both signs +1
    and the tables bit-identical to before.
    """
    dim = basis.mesh.dim
    tm_in, tm_out = fg.tang_maps(dim)
    if fg.nc_code != 0 and fg.twist != 0:
        raise NotImplementedError("hanging-node faces with twisted "
                                  "charts cannot arise from 2:1 "
                                  "refinement of imported meshes")
    fin = tensor.face_tables(fg.p_in, dim, fg.axis, fg.in_side, nq1,
                             family=basis.family, tang_map=tm_in)
    fout = tensor.face_tables(fg.p_out, dim, fg.out_axis, fg.out_side,
                              nq1, family=basis.family, tang_map=tm_out)
    if fg.twist != 0:
        fout = dict(fout)
        pts = fin["points"]
        mapped = fg.twist_map(pts)
        # the tensor rule is closed under the isometry: find the exact
        # column permutation realizing it
        d2 = ((mapped[:, None, :] - fout["points"][None, :, :]) ** 2
              ).sum(-1)
        qmap = d2.argmin(axis=1)
        if not (np.sqrt(d2[np.arange(len(qmap)), qmap]) < 1e-12).all() \
                or len(set(int(q) for q in qmap)) != len(qmap):
            raise AssertionError("face quadrature not closed under the "
                                 "twist isometry")
        for name in ("V", "Dn"):
            fout[name] = fout[name][..., qmap]
        fout["Dall"] = fout["Dall"][..., qmap]
        fout["points"] = mapped
    sgn_in = 2 * fg.in_side - 1
    sgn_out = 1 - 2 * fg.out_side
    if sgn_in < 0:
        fin = dict(fin)
        fin["Dn"] = sgn_in * fin["Dn"]
    if sgn_out < 0:
        fout = dict(fout)
        fout["Dn"] = sgn_out * fout["Dn"]
    return fin, fout


def face_phys_points(basis, fg: FaceGroup, pts: np.ndarray,
                     side: str = "in") -> np.ndarray:
    """Parametric quadrature points of a face group, on the intersection
    (= the fine face for non-conforming pairs).  (nf, nq, dim).

    Lattice-style meshes share one global parametric chart, so the same
    point array serves both sides.  Meshes with PER-ELEMENT charts
    (geometry.from_cell_vertices: disjoint unit boxes, faces paired at
    identity tangential correspondence) need the point expressed in the
    requested side's own chart — ``side`` picks "in" or "out" for those
    faces (conforming only; hanging nodes always live on shared
    charts)."""
    mesh = basis.mesh
    dim = mesh.dim
    ein = mesh.faces.inside[fg.face_ids]
    eout = mesh.faces.outside[fg.face_ids]
    lo = np.maximum(mesh.lower[ein], mesh.lower[eout])
    ext = np.minimum(mesh.extent[ein], mesh.extent[eout])
    lo[:, fg.axis] = mesh.lower[eout][:, fg.axis]  # the face plane
    nq = len(pts)
    x = np.repeat(lo[:, None, :], nq, axis=1)
    tang = [a for a in range(dim) if a != fg.axis]
    for t, a in enumerate(tang):
        x[:, :, a] += pts[None, :, t] * ext[:, a][:, None]
    # per-element-chart faces: parametrically non-adjacent pairs
    adj = np.abs(mesh.lower[ein][:, fg.axis]
                 + mesh.extent[ein][:, fg.axis]
                 - mesh.lower[eout][:, fg.axis]) \
        <= 1e-9 * np.maximum(1.0, mesh.extent[ein][:, fg.axis])
    if not adj.all():
        if fg.nc_code != 0:
            raise ValueError("hanging-node faces need a shared "
                             "parametric chart")
        if side == "in":
            e, ax2, sd2, tpts = ein, fg.axis, fg.in_side, pts
        else:
            e, ax2, sd2 = eout, fg.out_axis, fg.out_side
            tpts = fg.twist_map(pts)
        nlo = mesh.lower[e].copy()
        next_ = mesh.extent[e]
        xn = np.repeat(nlo[:, None, :], nq, axis=1)
        xn[:, :, ax2] += sd2 * next_[:, ax2][:, None]
        for t, a in enumerate(aa for aa in range(dim) if aa != ax2):
            xn[:, :, a] += tpts[None, :, t] * next_[:, a][:, None]
        x = np.where(adj[:, None, None], x, xn)
    return x


def boundary_phys_points(basis, bg: BoundaryGroup,
                         pts: np.ndarray) -> np.ndarray:
    """Parametric quadrature points of a boundary group, (nf, nq, dim)."""
    mesh = basis.mesh
    elems = mesh.bfaces.elem[bg.face_ids]
    lo = mesh.lower[elems].copy()
    if bg.side == 1:
        lo[:, bg.axis] += mesh.extent[elems, bg.axis]
    x = np.repeat(lo[:, None, :], len(pts), axis=1)
    tang = [a for a in range(mesh.dim) if a != bg.axis]
    for t, a in enumerate(tang):
        x[:, :, a] += pts[None, :, t] * mesh.extent[elems, a][:, None]
    return x


def penalty_coef(fg: FaceGroup, penalty: float, pmax: int,
                 scaling: str = "measure") -> np.ndarray:
    """Per-face penalty coefficient c_f such that the penalty term is
    c_f * sum_q w_q [u][v]  (i.e. c_f = mu_f * |f|).

    scaling="measure": mu = sigma p^2 / |f| (the reference convention,
    gausslobattoipdgassembler.hh:167) -> c_f = sigma p^2, constant.
    scaling="normal": mu = sigma p^2 * mean(1/h_normal) of the two
    elements -> c_f = sigma p^2 |f| mean(1/h_n).  Robust on anisotropic
    elements, where the measure convention under-penalizes (the SIPG
    matrix can become indefinite).
    """
    if scaling == "measure":
        return penalty * pmax**2 * np.ones(len(fg.face_ids))
    if scaling == "normal":
        hinv = 0.5 * (fg.inv_h_in + fg.inv_h_out)
        return penalty * pmax**2 * fg.fmeas * hinv
    raise ValueError(scaling)


def boundary_penalty_coef(bg: BoundaryGroup, penalty: float,
                          scaling: str = "measure") -> np.ndarray:
    if scaling == "measure":
        return penalty * bg.p**2 * np.ones(len(bg.face_ids))
    if scaling == "normal":
        return penalty * bg.p**2 * bg.fmeas * bg.inv_h
    raise ValueError(scaling)
