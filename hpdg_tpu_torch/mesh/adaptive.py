"""Local (adaptive) refinement with hanging nodes and 2:1 balance.

Port of ``hpdg_tpu.mesh.adaptive`` for box meshes (host-side numpy):
``refine_local(mesh, marks)`` splits the marked elements into 2^dim
children after closing the marks so that neighbouring elements never
differ by more than one refinement level (2:1 balance).  Every
non-conforming face is then a half-face, which the face matcher of
``mesh.structured`` records in ``Faces.nc_code``.

``unrefine`` merges complete marked sibling groups back into their
parents; ``semicoarsen`` merges element pairs along one axis and
``semicoarsen_chain`` repeats it until the elements are nearly
isotropic.  First-class geometry (``jac``/``shift``/``corners``) is
carried along: children restrict the parent's map exactly, merged
elements take it back.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from hpdg_tpu_torch.mesh.structured import Mesh, from_boxes


def _levels(mesh: Mesh) -> np.ndarray:
    """Refinement level per element, inferred from volumes relative to the
    coarsest element (robust to anisotropic base meshes)."""
    vol = mesh.volumes
    return np.rint(np.log2(vol.max() / vol) / mesh.dim).astype(np.int32)


def close_marks(mesh: Mesh, marks: np.ndarray) -> np.ndarray:
    """Extend the marked set so that refining it keeps 2:1 balance.

    Marking is monotone, so batch fixed-point sweeps over the face list
    reach the same (least) closure as sequential per-face propagation.
    """
    marks = np.asarray(marks, dtype=bool).copy()
    lev = _levels(mesh)
    fi, fo = mesh.faces.inside, mesh.faces.outside
    while True:
        tgt = lev + marks
        bad_o = (tgt[fi] - tgt[fo] > 1) & ~marks[fo]
        bad_i = (tgt[fo] - tgt[fi] > 1) & ~marks[fi]
        if not (bad_o.any() or bad_i.any()):
            return marks
        marks[fo[bad_o]] = True
        marks[fi[bad_i]] = True


def refine_local(mesh: Mesh, marks: np.ndarray) -> Mesh:
    """Refine marked elements (marks closed for 2:1 balance first).

    Unmarked elements keep their box and map to themselves through
    ``parent`` with ``child_pos == -1``; marked elements are replaced by
    their 2^dim children (parent-major, child position in C order).

    A mesh whose elements live in per-element parametric charts
    (``geometry.from_cell_vertices``: disjoint unit boxes) is refused:
    the face matcher works on the parametric boxes and would turn every
    interior face of such a mesh into boundary.
    """
    from hpdg_tpu_torch.mesh import geometry as _geo
    if _geo.has_element_charts(mesh):
        raise ValueError(
            "refine_local: the mesh has per-element parametric charts "
            "(from_cell_vertices import); its faces cannot be re-matched "
            "from the parametric boxes, so refining it would drop them")
    marks = close_marks(mesh, marks)
    n, dim = mesh.lower.shape
    nc = 2**dim
    bits = ((np.arange(nc)[:, None] >> np.arange(dim - 1, -1, -1)[None, :]) & 1)
    # every element contributes 1 (kept) or nc (refined) rows
    counts = np.where(marks, nc, 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    total = int(starts[-1])
    parent = np.repeat(np.arange(n, dtype=np.int32), counts)
    # position within the parent's row group = global row - group start
    local = np.arange(total, dtype=np.int64) - starts[parent]
    refined = marks[parent]
    child_pos = np.where(refined, local, -1).astype(np.int32)
    half = 0.5 * mesh.extent[parent]
    lowers = mesh.lower[parent] + np.where(
        refined[:, None], bits[np.clip(child_pos, 0, nc - 1)] * half, 0.0)
    extents = np.where(refined[:, None], half, mesh.extent[parent])
    jac = shift = corners = None
    if mesh.jac is not None:  # children inherit the parent's affine map
        jac = mesh.jac[parent]
        shift = mesh.shift[parent]
    if mesh.corners is not None:
        # refined rows get the parent trilinear map evaluated at the
        # child corners (exact restriction); kept rows copy verbatim
        corners = mesh.corners[parent].copy()
        ref = np.where(refined)[0]
        if len(ref):
            corners[ref] = _geo.q1_child_corners(
                mesh.corners, parent[ref], child_pos[ref])
    return from_boxes(lowers, extents, parent=parent, child_pos=child_pos,
                      parent_mesh=mesh, jac=jac, shift=shift,
                      corners=corners)


def unrefine(mesh: Mesh, marks: np.ndarray) -> Mesh:
    """Merge marked sibling groups back into their parent elements.

    A group is merged only when ALL of its 2^dim members are marked and
    the mesh has refinement links.  The result lists the kept elements
    first (in order, ``parent`` = the element itself, ``child_pos ==
    -1``), then one element per merged group in parent order (``parent``
    = the group's first member, ``child_pos == -2``); its
    ``parent_mesh`` is ``mesh``, so ``blocks.persist.restrict_to_coarse``
    can carry state across.
    """
    if mesh.parent is None or mesh.parent_mesh is None:
        raise ValueError("unrefine needs refinement links")
    marks = np.asarray(marks, dtype=bool)
    nc = 2**mesh.dim
    pm = mesh.parent_mesh
    sib = np.flatnonzero(mesh.child_pos >= 0)  # members of sibling groups
    pes = mesh.parent[sib]
    size = np.bincount(pes, minlength=pm.n_elements)
    n_marked = np.bincount(pes, weights=marks[sib], minlength=pm.n_elements)
    merge = np.flatnonzero((size == nc) & (n_marked == nc))  # sorted parents
    merged = np.zeros(mesh.n_elements, dtype=bool)
    merged[sib[np.isin(pes, merge)]] = True
    kept = np.flatnonzero(~merged)
    # first member of each merged group: sib is ascending
    uniq, first = np.unique(pes, return_index=True)
    first_member = sib[first[np.searchsorted(uniq, merge)]]
    lowers = np.concatenate([mesh.lower[kept], pm.lower[merge]])
    extents = np.concatenate([mesh.extent[kept], pm.extent[merge]])
    parent = np.concatenate([kept, first_member]).astype(np.int32)
    child_pos = np.concatenate([np.full(len(kept), -1),
                                np.full(len(merge), -2)]).astype(np.int32)
    jac = shift = corners = None
    if mesh.jac is not None:  # siblings share the parent's affine map
        jac = np.concatenate([mesh.jac[kept], mesh.jac[first_member]])
        shift = np.concatenate([mesh.shift[kept], mesh.shift[first_member]])
    if mesh.corners is not None:
        # parent corner c = corner c of the child at position c (the
        # exact inverse of q1_child_corners' restriction)
        member = np.full((pm.n_elements, nc), -1, dtype=np.int64)
        member[pes, mesh.child_pos[sib]] = sib
        kids = member[merge]  # (n_merge, nc) by child position
        corners = np.concatenate([
            mesh.corners[kept],
            mesh.corners[kids, np.arange(nc)[None, :]]])
    return from_boxes(lowers, extents, parent=parent, child_pos=child_pos,
                      parent_mesh=mesh, jac=jac, shift=shift,
                      corners=corners)


def semicoarsen(mesh: Mesh, axis: int):
    """Merge element pairs along ONE axis (semicoarsening): every element
    needs a partner of identical extent adjacent along ``axis``; pairs
    are taken greedily in element order.

    Returns ``(fine_linked, coarse)``: the coarse mesh (pair order, no
    links) and a twin of ``mesh`` whose ``parent``/``child_pos`` (0 low,
    1 high) point into it, for the transfer set-up; ``mesh`` itself is
    not touched.
    """
    n = mesh.n_elements
    tol = mesh.extent.min() * 1e-6
    # pair low/high elements along the axis by quantized geometry keys
    key_lo = np.rint(np.delete(mesh.lower, axis, 1) / tol).astype(np.int64)
    ax_lo = np.rint(mesh.lower[:, axis] / tol).astype(np.int64)
    ax_hi = np.rint((mesh.lower[:, axis] + mesh.extent[:, axis])
                    / tol).astype(np.int64)
    ext_key = np.rint(mesh.extent / tol).astype(np.int64)
    table = {}
    for e in range(n):
        table[(tuple(key_lo[e]), tuple(ext_key[e]), ax_lo[e])] = e
    parent = np.full(n, -1, dtype=np.int32)
    child_pos = np.full(n, -1, dtype=np.int32)
    lows, mates = [], []
    for e in range(n):
        if parent[e] >= 0:
            continue
        mate = table.get((tuple(key_lo[e]), tuple(ext_key[e]), ax_hi[e]))
        if mate is None or parent[mate] >= 0:
            raise ValueError(f"element {e} has no semicoarsening partner "
                             f"along axis {axis}")
        pe = len(lows)
        parent[e], child_pos[e] = pe, 0
        parent[mate], child_pos[mate] = pe, 1
        lows.append(e)
        mates.append(mate)
    lows = np.asarray(lows, dtype=np.int64)
    mates = np.asarray(mates, dtype=np.int64)
    extents = mesh.extent[lows].copy()
    extents[:, axis] *= 2.0
    jac = shift = corners = None
    if mesh.jac is not None:
        jac, shift = mesh.jac[lows], mesh.shift[lows]
    if mesh.corners is not None:
        # coarse corner c: low-side corners from the low mate, high-side
        # from the high mate (exact for hierarchy-compatible Q1)
        nc = 2**mesh.dim
        high = ((np.arange(nc) >> (mesh.dim - 1 - axis)) & 1).astype(bool)
        corners = np.where(high[None, :, None], mesh.corners[mates],
                           mesh.corners[lows])
    coarse = from_boxes(mesh.lower[lows].copy(), extents, jac=jac,
                        shift=shift, corners=corners)
    fine_linked = replace(mesh, parent=parent, child_pos=child_pos,
                          parent_mesh=coarse)
    return fine_linked, coarse


def semicoarsen_chain(mesh: Mesh, max_levels: int = 10) -> list:
    """Semicoarsen the axis with the SMALLEST element extent until the
    mesh is (nearly) isotropic or no axis can halve.  Returns the
    coarse-to-fine mesh list for ``multigrid_solver(meshes=...)``; its
    last entry is a relinked twin of ``mesh``."""
    chain = [mesh]
    cur = mesh
    for _ in range(max_levels):
        hmin = cur.extent.min(axis=0)
        axis = int(np.argmin(hmin))
        if hmin[axis] * 2.0 > hmin.max() * 1.0001:
            break  # isotropic enough
        try:
            fine_linked, coarse = semicoarsen(cur, axis)
        except ValueError:
            break
        chain[-1] = fine_linked
        chain.append(coarse)
        cur = coarse
    return chain[::-1]
