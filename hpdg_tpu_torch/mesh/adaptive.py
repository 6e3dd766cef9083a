"""Local (adaptive) refinement with hanging nodes and 2:1 balance.

Port of ``hpdg_tpu.mesh.adaptive`` for box meshes (host-side numpy):
``refine_local(mesh, marks)`` splits the marked elements into 2^dim
children after closing the marks so that neighbouring elements never
differ by more than one refinement level (2:1 balance).  Every
non-conforming face is then a half-face, which the face matcher of
``mesh.structured`` records in ``Faces.nc_code``.

``unrefine`` and ``semicoarsen`` wait for ROADMAP queue 1, item 18.
"""

from __future__ import annotations

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
    """
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
    return from_boxes(lowers, extents, parent=parent, child_pos=child_pos,
                      parent_mesh=mesh)
