"""State persistence across mesh and degree adaptation.

Port of ``hpdg_tpu.blocks.persist`` (the reference's SavedBasis /
saveDegrees / updateDegrees / interpolateIntoRefinedBasis with the
GridAdaptor underneath); interpolation and restriction work in the
parametric boxes and are geometry-agnostic.

The "persistent grid view" is the old mesh's arrays: a
:class:`SavedState` holds the old basis and the coefficients as one host
numpy vector in element order.  Re-interpolation groups the new elements
on the host by (new degree, old degree, affine map into the old cell)
and evaluates the old polynomial at the new nodes with one
``[n, i] @ [i, j]`` product per group on the target device.
``save_npz``/``load_npz`` write the same arrays as the reference, so
either package reads the other's files.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis import lagrange, tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.mesh import geometry as geo
from hpdg_tpu_torch.mesh.structured import from_boxes


@dataclass(frozen=True)
class SavedState:
    basis: DGBasis
    flat: np.ndarray  # flat coefficient vector (element order)


def save_state(basis: DGBasis, x: dict) -> SavedState:
    return SavedState(basis=basis, flat=bv.to_flat(basis, x))


def _ancestor_chain(new_mesh, old_mesh) -> np.ndarray:
    """Per-new-element ancestor index in old_mesh (walk parent links)."""
    if new_mesh is old_mesh:
        return np.arange(new_mesh.n_elements, dtype=np.int32)
    chain = []
    m = new_mesh
    while m is not None and m is not old_mesh:
        if m.parent is None:
            raise ValueError("new mesh is not a refinement of the saved mesh")
        chain.append(m.parent)
        m = m.parent_mesh
    if m is not old_mesh:
        raise ValueError("saved mesh not found in ancestor chain")
    anc = chain[0]
    for par in chain[1:]:
        anc = par[anc]
    return anc.astype(np.int32)


def _eval_matrix(p_old: int, family_old: str,
                 xref: np.ndarray) -> np.ndarray:
    """``T[i, j]``: old basis function j (degree p_old) at the new nodes
    ``xref`` (old reference coordinates, ``(nl_new, dim)``)."""
    dim = xref.shape[1]
    nodes_o = lagrange.nodes_1d(p_old, family_old)
    mio = tensor.multiindices(p_old, dim)
    T = np.ones((len(xref), len(mio)))
    for a in range(dim):
        T = T * lagrange.lagrange_values(nodes_o, xref[:, a])[mio[:, a], :].T
    return T


def _groups(keys: np.ndarray):
    """Rows of ``keys`` grouped: yields (first row, row ids) per group."""
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    cuts = np.flatnonzero(np.diff(inv[order])) + 1
    for sel in np.split(order, cuts):
        yield sel[0], sel


class _Target:
    """The output bucket dict on the device and the saved coefficients
    there, gathered per old element."""

    def __init__(self, saved: SavedState, new_basis: DGBasis, dtype, device):
        self.device = dev.resolve(device)
        self.dtype = dtype
        self.new = new_basis
        self.old = saved.basis
        self.flat = torch.as_tensor(saved.flat, dtype=dtype,
                                    device=self.device)
        self.out = {p: torch.zeros((new_basis.bucket_size(p),
                                    new_basis.n_local(p)), dtype=dtype,
                                   device=self.device)
                    for p in new_basis.bucket_degrees}

    def coeffs(self, old_elems: np.ndarray, p_old: int) -> torch.Tensor:
        idx = (self.old.offsets[old_elems][:, None]
               + np.arange((p_old + 1) ** self.old.dim)[None, :])
        return self.flat[torch.as_tensor(idx, device=self.device)]

    def matrix(self, T: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(T.T, dtype=self.dtype, device=self.device)

    def put(self, p_new: int, new_elems: np.ndarray, vals: torch.Tensor):
        pos = torch.as_tensor(self.new.elem_bucket_pos[new_elems],
                              dtype=torch.int64, device=self.device)
        self.out[p_new][pos] = vals


def interpolate_to(saved: SavedState, new_basis: DGBasis,
                   dtype=torch.float64, device=None) -> dict:
    """Re-interpolate the saved coefficients into the new basis: degree
    changes on the same mesh and any number of uniform or local
    refinements of the saved mesh (coarsening: :func:`restrict_to_coarse`).
    Returns a bucket dict on ``device``."""
    old = saved.basis
    new_mesh = new_basis.mesh
    anc = _ancestor_chain(new_mesh, old.mesh)
    # affine map of each new element into its ancestor's reference cell
    scale = new_mesh.extent / old.mesh.extent[anc]
    shift = (new_mesh.lower - old.mesh.lower[anc]) / old.mesh.extent[anc]
    # group by (p_new, p_old, quantized map), keys in host f64
    q = np.rint(np.concatenate([scale, shift], axis=1)
                * 2**20).astype(np.int64)
    keys = np.concatenate(
        [new_basis.degrees[:, None], old.degrees[anc][:, None], q], axis=1)
    tgt = _Target(saved, new_basis, dtype, device)
    dim = new_mesh.dim
    for e0, sel in _groups(keys):
        pn, po = int(new_basis.degrees[e0]), int(old.degrees[anc[e0]])
        # the new nodes mapped into the ancestor's reference coordinates
        xo = (shift[e0][None, :] + lagrange.nodes_1d(pn, new_basis.family)[
            tensor.multiindices(pn, dim)] * scale[e0][None, :])
        T = _eval_matrix(po, old.family, xo)
        tgt.put(pn, sel, tgt.coeffs(anc[sel], po) @ tgt.matrix(T))
    return tgt.out


def save_degrees(basis: DGBasis) -> np.ndarray:
    """Snapshot the degree map (saveDegrees)."""
    return basis.degrees.copy()


def degrees_after_refine(old_degrees: np.ndarray, new_mesh) -> np.ndarray:
    """Carry per-element degrees to a refined mesh: children inherit the
    parent's degree (updateDegrees)."""
    if new_mesh.parent is None:
        return old_degrees.copy()
    return old_degrees[new_mesh.parent].astype(np.int32)


def save_npz(path: str, saved: SavedState):
    """Checkpoint a state to disk: element boxes, degree map and
    coefficients, as plain arrays (the reference's file layout).

    That layout has no geometry fields, so a mesh with first-class
    geometry is refused: written this way it would come back from
    :func:`load_npz` as a box mesh, its ``jac``/``shift``/``corners``
    silently dropped."""
    m = saved.basis.mesh
    if geo.has_geometry(m):
        raise ValueError(
            "save_npz: the checkpoint layout (lower, extent, degrees, "
            "flat, family) has no geometry fields; the mesh's "
            "jac/shift/corners would be lost on load")
    np.savez(path, lower=m.lower, extent=m.extent,
             degrees=saved.basis.degrees, flat=saved.flat,
             family=np.array(saved.basis.family))


def load_npz(path: str) -> SavedState:
    with np.load(path) as d:
        mesh = from_boxes(d["lower"], d["extent"])
        basis = DGBasis(mesh, d["degrees"], family=str(d["family"]))
        return SavedState(basis=basis, flat=d["flat"])


def _coarse_sources(fine_mesh, new_mesh):
    """Per coarse element: ``kept[e]``, the fine element it keeps (or -1),
    and ``children[e, c]``, the fine element at child position c of a
    merged group (or -1)."""
    nc = 2**fine_mesh.dim
    n = new_mesh.n_elements
    kept = np.full(n, -1, dtype=np.int64)
    children = np.full((n, nc), -1, dtype=np.int64)
    if new_mesh is fine_mesh.parent_mesh:
        k = np.arange(fine_mesh.n_elements)
        cp = fine_mesh.child_pos
        kept[fine_mesh.parent[cp < 0]] = k[cp < 0]
        children[fine_mesh.parent[cp >= 0], cp[cp >= 0]] = k[cp >= 0]
    elif new_mesh.parent_mesh is fine_mesh and new_mesh.parent is not None:
        # unrefine links forward: recover merged sibling groups through
        # the fine mesh's own parent links
        cp = new_mesh.child_pos
        kept[cp == -1] = new_mesh.parent[cp == -1]
        merged = np.flatnonzero(cp == -2)
        if len(merged):
            if fine_mesh.parent is None:
                raise ValueError("restrict_to_coarse: merged elements but "
                                 "the fine mesh has no parent links")
            fcp = fine_mesh.child_pos
            sib = np.full((fine_mesh.parent_mesh.n_elements, nc), -1,
                          dtype=np.int64)
            k = np.flatnonzero(fcp >= 0)
            sib[fine_mesh.parent[k], fcp[k]] = k
            children[merged] = sib[fine_mesh.parent[new_mesh.parent[merged]]]
    else:
        raise ValueError("new basis must live on the saved mesh's parent "
                         "or on an unrefine() of the saved mesh")
    if np.any((kept < 0) & (children < 0).any(axis=1)):
        raise ValueError("restrict_to_coarse: coarse element without a "
                         "full child set")
    return kept, children


def restrict_to_coarse(saved: SavedState, new_basis: DGBasis,
                       dtype=torch.float64, device=None) -> dict:
    """Interpolate a saved fine-mesh state onto a coarser mesh: each
    coarse node is evaluated in the child that contains it.

    Two layouts are accepted: ``new_basis.mesh is
    saved.basis.mesh.parent_mesh`` (the undo of a ``refine`` or
    ``refine_local`` step; kept elements, ``child_pos == -1``, take an
    identity or degree-change transfer), and ``new_basis.mesh.parent_mesh
    is saved.basis.mesh`` (a mesh from ``mesh.adaptive.unrefine``: kept
    elements ``child_pos == -1``, merged groups ``-2``).  Returns a
    bucket dict on ``device``."""
    old = saved.basis
    fine_mesh = old.mesh
    new_mesh = new_basis.mesh
    dim = fine_mesh.dim
    nc = 2**dim
    kept, children = _coarse_sources(fine_mesh, new_mesh)
    is_kept = kept >= 0
    # group coarse elements by (p_new, kept?, old degrees of the sources)
    src_deg = np.where(is_kept[:, None], old.degrees[kept][:, None],
                       old.degrees[children])
    src_deg[is_kept, 1:] = -1
    keys = np.concatenate([new_basis.degrees[:, None], is_kept[:, None],
                           src_deg], axis=1)
    tgt = _Target(saved, new_basis, dtype, device)
    for e0, elems in _groups(keys):
        pn = int(new_basis.degrees[e0])
        xref = lagrange.nodes_1d(pn, new_basis.family)[
            tensor.multiindices(pn, dim)]  # new nodes in parent coordinates
        if is_kept[e0]:  # identity geometry, maybe a degree change
            po = int(old.degrees[kept[e0]])
            T = _eval_matrix(po, old.family, xref)
            tgt.put(pn, elems, tgt.coeffs(kept[elems], po) @ tgt.matrix(T))
            continue
        # route each node to the child containing it
        bits = (xref >= 0.5).astype(int)
        cidx = np.zeros(len(xref), dtype=int)
        for a in range(dim):
            cidx = cidx * 2 + bits[:, a]
        vals = torch.zeros((len(elems), len(xref)), dtype=dtype,
                           device=tgt.device)
        for c in range(nc):
            sel = np.flatnonzero(cidx == c)
            if not len(sel):
                continue
            po = int(old.degrees[children[e0, c]])
            xc = 2.0 * xref[sel] - bits[sel]  # child-local coordinates
            T = _eval_matrix(po, old.family, xc)
            vals[:, torch.as_tensor(sel, device=tgt.device)] = \
                tgt.coeffs(children[elems, c], po) @ tgt.matrix(T)
        tgt.put(pn, elems, vals)
    return tgt.out
