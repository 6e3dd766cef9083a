"""DG-P1 -> CG-P1 transfer and the conforming coarse space.

Port of ``hpdg_tpu.transfer.dgtocg`` (the reference's DG-to-CG transfer
assemblers and the DG->CG coarse path of its multigrid set-up): below
the p=1 DG level, restrict into the continuous Q1 space on the same mesh
(one dof per vertex) and solve there.

For Gauss-Lobatto nodal DG-P1 the element corner nodes coincide with the
vertices, so prolongation is a vertex gather and restriction an
``index_add_`` on the device; the Galerkin coarse matrix is a dense
vertex matrix summed on the host in numpy (the reference's ``np.add.at``
order, so it agrees bitwise), uploaded once and factored (Cholesky, f64)
on the device of the DG matrix.

The vertices are unified by the PARAMETRIC element boxes.  On a mesh
whose elements live in charts of their own (``geometry
.from_cell_vertices``) no two elements share a box corner, so
:func:`dg_to_cg_transfer` refuses such meshes with ``ValueError``
(the reference silently unifies nothing there and its "CG" coarse space
is the whole discontinuous P1 space).  :func:`cg_qk_coarse_solver`
unifies by physical node positions and serves every mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg.blockmatrix import BlockSparseMatrix
from hpdg_tpu_torch.mesh import geometry as geo


def _host_values(A: BlockSparseMatrix) -> dict:
    return {k: v.detach().cpu().double().numpy() for k, v in A.values.items()}


def _device_of(A: BlockSparseMatrix) -> torch.device:
    return next(iter(A.values.values())).device


@dataclass(frozen=True)
class DGtoCGTransfer:
    basis: DGBasis  # uniform degree-1 DG basis
    vertices: np.ndarray  # (nv, dim)
    vmap: np.ndarray  # (n_elements, 2^dim) vertex id per local corner
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    def _index(self, device) -> torch.Tensor:
        if device not in self._cache:
            self._cache[device] = torch.as_tensor(
                self.vmap.reshape(-1).astype(np.int64), device=device)
        return self._cache[device]

    def prolong(self, x_cg: torch.Tensor, dtype=torch.float64) -> dict:
        """CG vertex vector (nv,) -> DG-P1 bucketed vector."""
        vals = x_cg.index_select(0, self._index(x_cg.device))
        return {1: vals.reshape(self.vmap.shape).to(dtype)}

    def restrict(self, r_dg: dict) -> torch.Tensor:
        """Transpose: scatter-add DG corner values onto vertices."""
        r = r_dg[1]
        return torch.zeros(self.n_vertices, dtype=r.dtype,
                           device=r.device).index_add_(
            0, self._index(r.device), r.reshape(-1))

    def galerkin_dense(self, A: BlockSparseMatrix) -> np.ndarray:
        """A_cg = R^T A R as a dense (nv, nv) host matrix (the CG coarse
        problem is small by construction)."""
        nv = self.n_vertices
        Acg = np.zeros((nv, nv))
        hv = _host_values(A)
        for (pr, pc), (rows, cols) in A.pattern.entries.items():
            assert pr == 1 and pc == 1
            vals = hv[(pr, pc)]
            vr = self.vmap[self.basis.bucket_elems[pr][rows]]  # (nnz, 2^d)
            vc = self.vmap[self.basis.bucket_elems[pc][cols]]
            bs = vals.shape[1]
            for i in range(bs):
                for j in range(bs):
                    np.add.at(Acg, (vr[:, i], vc[:, j]), vals[:, i, j])
        return Acg


def _refuse_element_charts(mesh):
    if geo.has_element_charts(mesh):
        raise ValueError("dg_to_cg_transfer unifies vertices by the "
                         "parametric element boxes, and this mesh has "
                         "per-element charts (from_cell_vertices): no two "
                         "elements share a box corner, so the CG-P1 space "
                         "would be the whole DG-P1 space; use the CG-Q_k "
                         "route (cg_qk_coarse_solver), which unifies "
                         "physical node positions")


def dg_to_cg_transfer(basis: DGBasis):
    """Conforming meshes get the plain vertex gather; hanging-node meshes
    route to the constrained (nonconforming) variant automatically."""
    if basis.bucket_degrees != (1,):
        raise ValueError("DG->CG transfer needs a uniform degree-1 basis")
    mesh = basis.mesh
    _refuse_element_charts(mesh)
    if mesh.faces.nc_code is not None and mesh.faces.nc_code.max(initial=0):
        return dg_to_cg_transfer_nc(basis)
    dim = mesh.dim
    mi = tensor.multiindices(1, dim)  # corner multiindices, C order
    corners = (mesh.lower[:, None, :]
               + mi[None, :, :] * mesh.extent[:, None, :])  # (n, 2^d, dim)
    tol = mesh.extent.min() * 1e-6
    keys = np.rint(corners / tol).astype(np.int64).reshape(-1, dim)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    vmap = inv.reshape(mesh.n_elements, 2**dim).astype(np.int32)
    vertices = uniq * tol
    return DGtoCGTransfer(basis=basis, vertices=vertices, vmap=vmap)


@dataclass(frozen=True)
class DGtoCGTransferNC:
    """DG-P1 <-> constrained CG-P1 on a hanging-node mesh.

    CG dofs are the NON-hanging vertices; a hanging vertex's value is the
    Q1 interpolation of the coarse face that contains it (constraint
    chains resolved to true dofs).  Per element corner, a padded weight
    list over CG dofs encodes the transfer."""

    basis: DGBasis
    n_dofs: int
    wdof: np.ndarray     # (n, 2^dim, K) int32 CG dof ids
    wval: np.ndarray     # (n, 2^dim, K) weights (0 on padding)
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_vertices(self) -> int:  # the conforming variant's name
        return self.n_dofs

    def _tables(self, dtype, device):
        """(flat dof ids, weights) on ``device``."""
        if (dtype, device) not in self._cache:
            self._cache[(dtype, device)] = (
                torch.as_tensor(self.wdof.reshape(-1).astype(np.int64),
                                device=device),
                torch.as_tensor(self.wval, dtype=dtype, device=device))
        return self._cache[(dtype, device)]

    def prolong(self, x_cg: torch.Tensor, dtype=torch.float64) -> dict:
        idx, w = self._tables(x_cg.dtype, x_cg.device)
        g = x_cg.index_select(0, idx).reshape(self.wdof.shape)
        return {1: (g * w).sum(-1).to(dtype)}

    def restrict(self, r_dg: dict) -> torch.Tensor:
        r = r_dg[1]  # (n, 2^dim)
        idx, w = self._tables(r.dtype, r.device)
        return torch.zeros(self.n_dofs, dtype=r.dtype,
                           device=r.device).index_add_(
            0, idx, (r[:, :, None] * w).reshape(-1))

    def galerkin_dense(self, A: BlockSparseMatrix) -> np.ndarray:
        nd = self.n_dofs
        Acg = np.zeros((nd, nd))
        K = self.wdof.shape[2]
        hv = _host_values(A)
        for (pr, pc), (rows, cols) in A.pattern.entries.items():
            vals = hv[(pr, pc)]
            relems = self.basis.bucket_elems[pr][rows]
            celems = self.basis.bucket_elems[pc][cols]
            bs = vals.shape[1]
            for i in range(bs):
                for j in range(bs):
                    for ki in range(K):
                        for kj in range(K):
                            w = (self.wval[relems, i, ki]
                                 * self.wval[celems, j, kj])
                            np.add.at(Acg,
                                      (self.wdof[relems, i, ki],
                                       self.wdof[celems, j, kj]),
                                      w * vals[:, i, j])
        return Acg


def dg_to_cg_transfer_nc(basis: DGBasis) -> DGtoCGTransferNC:
    """Build the constrained CG-P1 transfer on a 2:1 hanging-node mesh
    (host numpy; every vertex is tested against every element box, as
    in the reference)."""
    if basis.bucket_degrees != (1,):
        raise ValueError("DG->CG transfer needs a uniform degree-1 basis")
    mesh = basis.mesh
    _refuse_element_charts(mesh)
    dim = mesh.dim
    n = mesh.n_elements
    nc = 2**dim
    mi = tensor.multiindices(1, dim)
    corners = (mesh.lower[:, None, :]
               + mi[None, :, :] * mesh.extent[:, None, :])  # (n, 2^d, dim)
    tol = float(mesh.extent.min() * 1e-6)
    keys = np.rint(corners / tol).astype(np.int64).reshape(-1, dim)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    vmap = inv.reshape(n, nc)
    verts = uniq.astype(np.float64) * tol
    nv = len(verts)

    # hanging vertices: contained in some element's closed box but not
    # one of its corners -> constrained by that element's Q1 interpolation
    constraints = {}  # vertex id -> list[(vertex id, weight)]
    lo = mesh.lower
    hi = mesh.lower + mesh.extent
    corner_sets = [set(map(int, vmap[e])) for e in range(n)]
    for v in range(nv):
        inside = np.where(np.all(verts[v] >= lo - tol, axis=1)
                          & np.all(verts[v] <= hi + tol, axis=1))[0]
        for e in inside:
            if v in corner_sets[e]:
                continue
            t = (verts[v] - lo[e]) / mesh.extent[e]
            w = np.ones(nc)
            for a in range(dim):
                w = w * np.where(mi[:, a] == 1, t[a], 1.0 - t[a])
            constraints[v] = [(int(vmap[e, c]), float(w[c]))
                              for c in range(nc) if abs(w[c]) > 1e-14]
            break

    def resolve(v, depth=0):
        if v not in constraints:
            return [(v, 1.0)]
        if depth > 10:
            raise RuntimeError("constraint chain too deep (mesh not 2:1?)")
        out = {}
        for u, w in constraints[v]:
            for t, wt in resolve(u, depth + 1):
                out[t] = out.get(t, 0.0) + w * wt
        return list(out.items())

    true_ids = {}
    for v in range(nv):
        if v not in constraints:
            true_ids[v] = len(true_ids)
    resolved = {v: [(true_ids[t], w) for t, w in resolve(v)]
                for v in range(nv)}
    K = max(len(lst) for lst in resolved.values())
    wdof = np.zeros((n, nc, K), dtype=np.int32)
    wval = np.zeros((n, nc, K))
    for e in range(n):
        for c in range(nc):
            for k, (d, w) in enumerate(resolved[int(vmap[e, c])]):
                wdof[e, c, k] = d
                wval[e, c, k] = w
    return DGtoCGTransferNC(basis=basis, n_dofs=len(true_ids),
                            wdof=wdof, wval=wval)


def cg_qk_galerkin_dense(cgb, basis: DGBasis,
                         A: BlockSparseMatrix) -> np.ndarray:
    """``A_cg = R^T A R`` for the continuous Q_k space ``cgb``
    (``basis.cgbasis.CGQkBasis``) under a uniform degree-k DG matrix
    whose GL nodes coincide with the CG nodes (host dense).  Weighted
    gathers cover hanging-node constraints."""
    (k,) = basis.bucket_degrees
    assert k == cgb.degree
    nd = cgb.n_dofs
    Acg = np.zeros((nd, nd))
    K = cgb.wdof.shape[2]
    hv = _host_values(A)
    for (pr, pc), (rows, cols) in A.pattern.entries.items():
        vals = hv[(pr, pc)]
        relems = basis.bucket_elems[pr][rows]
        celems = basis.bucket_elems[pc][cols]
        bs = vals.shape[1]
        for ki in range(K):
            wr = cgb.wval[relems, :, ki]          # (nnz, bs)
            dr = cgb.wdof[relems, :, ki]
            for kj in range(K):
                wc = cgb.wval[celems, :, kj]
                dc = cgb.wdof[celems, :, kj]
                wv = (wr[:, :, None] * wc[:, None, :]) * vals
                nz = wv != 0.0
                np.add.at(Acg, (np.broadcast_to(dr[:, :, None],
                                                (len(wv), bs, bs))[nz],
                                np.broadcast_to(dc[:, None, :],
                                                (len(wv), bs, bs))[nz]),
                          wv[nz])
    return Acg


def _dense_solver(Acg: np.ndarray, dtype, device):
    """``f -> Acg^{-1} f`` on ``device``: the f64 Cholesky factor of the
    symmetrized host matrix, computed on ``device`` (a dense inverse
    where it is not SPD), kept in ``dtype``."""
    Ad = torch.from_numpy(Acg).to(device)
    Ad = 0.5 * (Ad + Ad.T)
    L, info = torch.linalg.cholesky_ex(Ad)
    if int(info) == 0:
        Lc = L.to(dtype)
        return lambda f: torch.cholesky_solve(f[:, None].to(dtype), Lc)[:, 0]
    inv = torch.linalg.inv(Ad).to(dtype)
    return lambda f: inv @ f.to(dtype)


def cg_qk_coarse_solver(basis: DGBasis, A: BlockSparseMatrix,
                        dtype=torch.float64):
    """Coarse solve through the continuous Q_k space at the SAME degree
    as the (uniform-degree) DG level: restrict through the
    node-coincidence gather, dense-solve on the CG dofs, prolong, on the
    device of ``A``."""
    from hpdg_tpu_torch.basis.cgbasis import cg_basis
    (k,) = basis.bucket_degrees
    device = _device_of(A)
    cgb = cg_basis(basis.mesh, k, family=basis.family, device=device)
    solve = _dense_solver(cg_qk_galerkin_dense(cgb, basis, A), dtype,
                          device)

    def coarse_solve(b: dict) -> dict:
        return {k: cgb.gather(solve(cgb.scatter(b[k])), dtype=dtype)}

    return coarse_solve


def cg_coarse_solver(basis: DGBasis, A: BlockSparseMatrix,
                     dtype=torch.float64):
    """Coarse solve through the CG-P1 space on the device of ``A``:
    restrict, dense-solve on the vertices, prolong (a direct solve where
    the reference's C++ original runs a geometric MG on the CG matrix).
    Uniform degree-k levels with k > 1 route to the CG-Q_k variant
    (:func:`cg_qk_coarse_solver`)."""
    if basis.bucket_degrees != (1,) and len(basis.bucket_degrees) == 1:
        return cg_qk_coarse_solver(basis, A, dtype=dtype)
    T = dg_to_cg_transfer(basis)
    solve = _dense_solver(T.galerkin_dense(A), dtype, _device_of(A))

    def coarse_solve(b: dict) -> dict:
        return T.prolong(solve(T.restrict(b)), dtype=dtype)

    return coarse_solve
