"""The continuous Gauss-Lobatto Q_k space.

Port of ``hpdg_tpu.basis.cgbasis`` (the reference's ``QkGLNodalBasis``):
a conforming Q_k discretization at any degree k whose interpolation
nodes are the tensor Gauss-Lobatto points, with a per-entity global dof
layout (vertex dofs first, then edge-, face- and cell-interior dofs).

The whole space is ONE weighted gather: ``wdof[(e, l, j)]`` global dof
ids and ``wval`` weights with ``u_local[e, l] = sum_j wval * u[wdof]``.
On a conforming mesh every weight is 1 and the inner width is 1 (an
``index_select`` / ``index_add_`` pair on the basis' device); on a 2:1
hanging-node mesh the hanging nodes carry the Q_k interpolation weights
of the constraining coarse face.  Element-local compute is then the DG
pipeline's on the degree-k companion :class:`DGBasis`.  The tables are
built on the host in numpy, in the reference's order, so they agree with
its tables bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis import lagrange, tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.mesh import geometry as geo


@dataclass(frozen=True)
class CGQkBasis:
    """Continuous Gauss-Lobatto Q_k space over a cube mesh.

    ``wdof``/``wval`` map element-local tensor GL nodes to global true
    dofs (weights resolve hanging-node constraints; width 1 and weight
    1.0 everywhere on conforming meshes).  Global dofs are ordered
    per entity: all vertex dofs, then edge-, face-, cell-interior.
    ``gather`` and ``scatter`` run on ``device``."""

    dg: DGBasis            # uniform degree-k DG companion (local layout)
    degree: int
    n_dofs: int
    wdof: np.ndarray       # (n, (k+1)^dim, K) int32 global dof ids
    wval: np.ndarray       # (n, (k+1)^dim, K) float64 weights (0 = pad)
    entity_dim: np.ndarray  # (n_dofs,) int8 entity dimension per dof
    boundary: np.ndarray   # (n_dofs,) bool: on the domain boundary
    device: torch.device = torch.device("cpu")
    _idx: torch.Tensor = field(init=False, repr=False, compare=False)
    _w: dict = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        idx = self.wdof[:, :, 0] if self.conforming else self.wdof
        object.__setattr__(self, "_idx", torch.as_tensor(
            idx.reshape(-1).astype(np.int64), device=self.device))
        object.__setattr__(self, "_w", {})

    @property
    def mesh(self):
        return self.dg.mesh

    @property
    def dim(self) -> int:
        return self.dg.mesh.dim

    @property
    def conforming(self) -> bool:
        return self.wdof.shape[2] == 1

    def _weights(self, dtype) -> torch.Tensor:
        if dtype not in self._w:
            self._w[dtype] = torch.as_tensor(self.wval, dtype=dtype,
                                             device=self.device)
        return self._w[dtype]

    # ---- the two ops that define the space ----
    def gather(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """Global dof vector (n_dofs,) -> element-local (n, (k+1)^dim)."""
        dtype = dtype or x.dtype
        n, nl, _ = self.wdof.shape
        g = x.index_select(0, self._idx)
        if self.conforming:
            return g.reshape(n, nl).to(dtype)
        return (g.reshape(self.wdof.shape)
                * self._weights(x.dtype)).sum(-1).to(dtype)

    def scatter(self, r_el: torch.Tensor) -> torch.Tensor:
        """Transpose of gather: element-local -> global (n_dofs,)."""
        out = torch.zeros(self.n_dofs, dtype=r_el.dtype, device=r_el.device)
        if self.conforming:
            return out.index_add_(0, self._idx, r_el.reshape(-1))
        contrib = r_el[:, :, None] * self._weights(r_el.dtype)
        return out.index_add_(0, self._idx, contrib.reshape(-1))

    # ---- vectors in the companion DG bucket layout ----
    def prolong(self, x: torch.Tensor, dtype=torch.float64) -> dict:
        """CG dof vector -> DG bucket dict (the coarse-space embedding)."""
        return {self.degree: self.gather(x, dtype=dtype)}

    def restrict(self, r_dg: dict) -> torch.Tensor:
        return self.scatter(r_dg[self.degree])

    def interpolate(self, f) -> np.ndarray:
        """Nodal interpolation of ``f(x)`` (a numpy callable): every TRUE
        dof takes the value of f at its node (hanging nodes have no dof;
        host, f64)."""
        vals = np.asarray(f(self._node_coords()), np.float64).reshape(-1)
        w = self.wval.reshape(len(vals), -1)
        is_true = np.abs(w[:, 0] - 1.0) < 1e-14
        if w.shape[1] > 1:
            is_true &= np.abs(w[:, 1:]).sum(axis=1) == 0.0
        out = np.zeros(self.n_dofs)
        out[self.wdof[:, :, 0].reshape(-1)[is_true]] = vals[is_true]
        return out

    def _node_coords(self) -> np.ndarray:
        return _node_coords(self.dg, self.degree)


def _node_coords(dg: DGBasis, k: int) -> np.ndarray:
    """Physical coordinates of every element-local tensor GL node,
    shape (n, (k+1)^dim, dim), in ELEMENT order."""
    mesh = dg.mesh
    nodes1 = lagrange.nodes_1d(k, dg.family)
    mi = tensor.multiindices(k, mesh.dim)          # (nl, dim)
    ref = nodes1[mi]                               # (nl, dim) in [0,1]^d
    xp = (mesh.lower[:, None, :]
          + ref[None, :, :] * mesh.extent[:, None, :])
    if geo.has_affine(mesh):
        elems = np.arange(mesh.n_elements, dtype=np.int32)
        xp = np.asarray(geo.apply_map(mesh, elems, xp))
    return xp


def cg_basis(mesh, degree: int, family: str = "lobatto",
             device=None) -> CGQkBasis:
    """Build the continuous Q_k space on ``mesh`` (gather and scatter on
    ``device``).  Conforming meshes get the plain node unification; 2:1
    hanging-node meshes additionally constrain hanging nodes by the
    coarse face's Q_k interpolation."""
    device = dev.resolve(device)
    if degree < 1:
        raise ValueError("continuous spaces need degree >= 1")
    nodes1 = lagrange.nodes_1d(degree, family)
    if abs(nodes1[0]) > 1e-12 or abs(nodes1[-1] - 1.0) > 1e-12:
        raise ValueError(f"node family {family!r} has no endpoint nodes; "
                         "a continuous space needs them (use 'lobatto')")
    dg = DGBasis(mesh, np.full(mesh.n_elements, degree, dtype=np.int32),
                 family=family)
    k, dim, n = degree, mesh.dim, mesh.n_elements
    mi = tensor.multiindices(k, dim)               # (nl, dim)
    nl = len(mi)
    coords = _node_coords(dg, k)                   # (n, nl, dim)

    # geometric unification of coincident nodes
    tol = float(mesh.extent.min()) * 1e-8
    keys = np.rint(coords.reshape(-1, dim) / tol).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    vmap = inv.reshape(n, nl)
    nv = len(uniq)

    # entity dimension per unified node: number of element-interior axes
    # of the local multiindex (consistent across sharing elements for
    # TRUE nodes; hanging nodes keep the fine side's view)
    interior = ((mi > 0) & (mi < k)).sum(axis=1).astype(np.int8)  # (nl,)
    ent = np.zeros(nv, dtype=np.int8)
    ent[vmap.reshape(-1)] = np.broadcast_to(interior, (n, nl)).reshape(-1)

    # hanging-node constraints: fine-side nodes on a nonconforming face
    # that are NOT nodes of the coarse element are interpolated from the
    # coarse element's Q_k tensor-Lagrange basis at their position (host
    # loops over the hanging faces, as in the reference)
    constraints: dict[int, list[tuple[int, float]]] = {}
    fa = mesh.faces
    if len(fa.inside) and np.any(fa.nc_code != 0):
        ncf = np.where(fa.nc_code != 0)[0]
        node_sets = [set(map(int, vmap[e])) for e in range(n)]
        half = 2 ** (dim - 1)
        for fi in ncf:
            code = int(fa.nc_code[fi]) - 1
            coarse_out = code // half
            e_in, e_out = int(fa.inside[fi]), int(fa.outside[fi])
            fine = e_in if coarse_out else e_out
            coarse = e_out if coarse_out else e_in
            ax = int(fa.axis[fi])
            # fine-face local nodes: mi[ax] == k on the low side of the
            # face if fine is the inside (low) element, else mi[ax] == 0
            side_val = k if fine == e_in else 0
            locs = np.where(mi[:, ax] == side_val)[0]
            lo_c = mesh.lower[coarse]
            ex_c = mesh.extent[coarse]
            for l in locs:  # noqa: E741
                v = int(vmap[fine, l])
                if v in node_sets[coarse] or v in constraints:
                    continue
                t = (coords[fine, l] - lo_c) / ex_c
                w = np.ones(nl)
                for a in range(dim):
                    w = w * lagrange.lagrange_values(
                        nodes1, np.array([t[a]]))[mi[:, a], 0]
                constraints[v] = [
                    (int(vmap[coarse, c]), float(w[c]))
                    for c in range(nl) if abs(w[c]) > 1e-13]

    def resolve(v, depth=0):
        if v not in constraints:
            return [(v, 1.0)]
        if depth > 10:
            raise RuntimeError("constraint chain too deep (mesh not 2:1?)")
        out: dict[int, float] = {}
        for u, w in constraints[v]:
            for tdof, wt in resolve(u, depth + 1):
                out[tdof] = out.get(tdof, 0.0) + w * wt
        return list(out.items())

    # true dofs, per-entity ordered: entity dim ascending, then position
    hanging = np.zeros(nv, dtype=bool)
    hanging[list(constraints)] = True
    true_nodes = np.flatnonzero(~hanging).astype(np.int64)
    order = np.lexsort(tuple(uniq[true_nodes, a]
                             for a in range(dim - 1, -1, -1))
                       + (ent[true_nodes],))
    true_nodes = true_nodes[order]
    dof_of = -np.ones(nv, dtype=np.int64)
    dof_of[true_nodes] = np.arange(len(true_nodes))

    resolved = {}
    K = 1
    for v in constraints:
        r = [(int(dof_of[t]), w) for t, w in resolve(v)]
        resolved[v] = r
        K = max(K, len(r))

    wdof = np.zeros((n, nl, K), dtype=np.int32)
    wval = np.zeros((n, nl, K))
    td = dof_of[vmap]                              # (n, nl); -1 = hanging
    wdof[:, :, 0] = np.where(td >= 0, td, 0)
    wval[:, :, 0] = (td >= 0).astype(np.float64)
    for e, l in zip(*np.nonzero(td < 0)):  # noqa: E741
        for j, (d, w) in enumerate(resolved[int(vmap[e, l])]):
            wdof[e, l, j] = d
            wval[e, l, j] = w

    n_dofs = len(true_nodes)
    entity_dim = ent[true_nodes].copy()

    # domain-boundary dofs (Dirichlet candidates); a hanging node on the
    # boundary constrains only to boundary dofs
    boundary = np.zeros(n_dofs, dtype=bool)
    bf = mesh.bfaces
    for ax in range(dim):
        for side in (0, 1):
            sel = (bf.axis == ax) & (bf.side == side)
            if not sel.any():
                continue
            locs = np.where(mi[:, ax] == (k if side else 0))[0]
            d = dof_of[vmap[bf.elem[sel]][:, locs]].reshape(-1)
            boundary[d[d >= 0]] = True
    return CGQkBasis(dg=dg, degree=k, n_dofs=n_dofs, wdof=wdof, wval=wval,
                     entity_dim=entity_dim, boundary=boundary, device=device)
