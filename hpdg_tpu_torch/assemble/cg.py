"""Assembly and matrix-free operators on the continuous Q_k space.

Port of ``hpdg_tpu.assemble.cg``.  Every element-local kernel (the
batched stiffness blocks, the sum-factorized bulk apply) is the DG one
on the degree-k companion basis, and CG-ness is exactly
``A_cg = R^T A_local R`` with R the (weighted) gather of
:class:`~hpdg_tpu_torch.basis.cgbasis.CGQkBasis`: assembled as a scalar
sparse matrix (host numpy fold and dedup, values on the basis' device)
or applied matrix-free (gather, bulk apply, scatter).

Dirichlet conditions are imposed the CG way (boundary-dof elimination:
unit rows/columns), not by Nitsche penalties: the space is conforming.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.cgbasis import CGQkBasis
from hpdg_tpu_torch.mesh import geometry as geo


# ---------------------------------------------------------------- local
def cg_local_stiffness(cg: CGQkBasis, diffusion=None,
                       dtype=torch.float64) -> torch.Tensor:
    """Element-local bulk stiffness blocks ``(n, nl, nl)`` on the
    basis' device (the batched einsum of the DG bulk term)."""
    from hpdg_tpu_torch.assemble.sipg import bulk_tensor_blocks
    mesh, dim, p = cg.mesh, cg.dim, cg.degree
    J = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                  device=cg.device)
    vt = tensor.volume_tables(p, dim, p + 2, family=cg.dg.family)
    G, w = vt["G"], vt["weights"]
    ext = mesh.extent
    detJ = np.prod(ext, axis=1)
    invh2 = detJ[:, None] / ext ** 2
    if diffusion is None and not geo.has_affine(mesh):
        S = np.einsum("q,aiq,ajq->aij", w, G, G)
        return torch.einsum("ea,aij->eij", J(invh2), J(S))
    elems = np.arange(mesh.n_elements, dtype=np.int32)
    xp = (mesh.lower[:, None, :] + vt["points"][None, :, :]
          * ext[:, None, :])
    k = (diffusion(J(geo.apply_map(mesh, elems, xp))).to(dtype)
         if diffusion is not None else None)
    if geo.has_affine(mesh):
        k = J(geo.effective_tensor(mesh, elems, k, xp))
    if k.dim() == 4:  # (n, q, dim, dim) tensor medium
        cof = detJ[:, None, None] / (ext[:, :, None] * ext[:, None, :])
        return bulk_tensor_blocks(
            k * J(w)[None, :, None, None] * J(cof)[:, None], J(G))
    kw = k * J(w)[None, :]
    return torch.einsum("eq,ea,aiq,ajq->eij", kw, J(invh2), J(G), J(G))


def cg_local_mass(cg: CGQkBasis, weight=None,
                  dtype=torch.float64) -> torch.Tensor:
    """Element-local mass blocks ``(n, nl, nl)`` at full 2p quadrature."""
    from hpdg_tpu_torch.assemble.mass import assemble_mass
    M = assemble_mass(cg.dg, weight=weight, dtype=dtype, device=cg.device)
    return M.values[(cg.degree, cg.degree)][:cg.mesh.n_elements]


# ------------------------------------------------------------- assembled
@dataclass(frozen=True)
class CGSparseMatrix:
    """Scalar sparse matrix in deduplicated COO (host index arrays,
    values on the device); the SpMV is a gather of ``x`` at ``cols``, a
    product and one ``index_add_`` at ``rows``."""

    n: int
    rows: np.ndarray     # (nnz,) int32, sorted
    cols: np.ndarray     # (nnz,) int32
    vals: torch.Tensor   # (nnz,)
    _ix: tuple = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        d = self.vals.device
        object.__setattr__(self, "_ix", (
            torch.as_tensor(self.rows.astype(np.int64), device=d),
            torch.as_tensor(self.cols.astype(np.int64), device=d)))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        rows, cols = self._ix
        contrib = self.vals * x.index_select(0, cols)
        return torch.zeros(self.n, dtype=contrib.dtype,
                           device=contrib.device).index_add_(0, rows, contrib)

    def todense(self) -> np.ndarray:
        A = np.zeros((self.n, self.n))
        np.add.at(A, (self.rows, self.cols),
                  self.vals.detach().cpu().double().numpy())
        return A


def _scatter_blocks(cg: CGQkBasis, blocks, dirichlet: bool,
                    dtype) -> CGSparseMatrix:
    """Fold element-local blocks through the weighted gather on both
    sides, ``A[wdof[e,i,ki], wdof[e,j,kj]] += wval*wval*blocks[e,i,j]``,
    then deduplicate (host numpy f64).  Dirichlet: boundary rows/cols
    dropped, unit diagonal added."""
    n, nl, K = cg.wdof.shape
    wd = cg.wdof.astype(np.int64)
    wv = cg.wval
    rows = np.broadcast_to(wd[:, :, :, None, None], (n, nl, K, nl, K))
    cols = np.broadcast_to(wd[:, None, None, :, :], (n, nl, K, nl, K))
    w = (wv[:, :, :, None, None] * wv[:, None, None, :, :])
    vals = (blocks.detach().cpu().double().numpy()[:, :, None, :, None]
            * w)
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    vals = vals.reshape(-1)
    keep = vals != 0.0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if dirichlet:
        bnd = cg.boundary
        keep = ~(bnd[rows] | bnd[cols])
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        bidx = np.where(bnd)[0]
        rows = np.concatenate([rows, bidx])
        cols = np.concatenate([cols, bidx])
        vals = np.concatenate([vals, np.ones(len(bidx))])
    key = rows * cg.n_dofs + cols
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(len(uniq))
    np.add.at(acc, inv, vals)
    return CGSparseMatrix(n=cg.n_dofs,
                          rows=(uniq // cg.n_dofs).astype(np.int32),
                          cols=(uniq % cg.n_dofs).astype(np.int32),
                          vals=torch.as_tensor(acc, dtype=dtype,
                                               device=cg.device))


def assemble_cg_laplace(cg: CGQkBasis, diffusion=None,
                        dirichlet: bool = False,
                        dtype=torch.float64) -> CGSparseMatrix:
    """Continuous Q_k stiffness matrix (the conforming counterpart of
    ``assemble_laplace``: no face terms, continuity lives in the dof
    map)."""
    return _scatter_blocks(cg, cg_local_stiffness(cg, diffusion,
                                                  torch.float64),
                           dirichlet, dtype)


def assemble_cg_mass(cg: CGQkBasis, weight=None, dirichlet: bool = False,
                     dtype=torch.float64) -> CGSparseMatrix:
    return _scatter_blocks(cg, cg_local_mass(cg, weight, torch.float64),
                           dirichlet, dtype)


# ------------------------------------------------------------ matrix-free
def cg_laplace_operator(cg: CGQkBasis, diffusion=None,
                        dirichlet: bool = False, dtype=torch.float64):
    """Matrix-free CG stiffness apply on the basis' device: gather ->
    sum-factorized bulk Laplacian (``matrixfree.sumfact
    .laplace_bulk_operator``) -> scatter, with Dirichlet dofs held at
    identity."""
    from hpdg_tpu_torch.matrixfree.sumfact import laplace_bulk_operator
    p = cg.degree
    bulk = laplace_bulk_operator(cg.dg, diffusion=diffusion, dtype=dtype,
                                 device=cg.device)
    free = torch.as_tensor(~cg.boundary, device=cg.device)

    def apply(x):
        xi = torch.where(free, x, 0.0) if dirichlet else x
        y = cg.scatter(bulk({p: cg.gather(xi, dtype=dtype)})[p])
        if dirichlet:
            y = torch.where(free, y, x)
        return y

    return apply


def cg_l2_functional(cg: CGQkBasis, f, dirichlet: bool = False,
                     dtype=torch.float64) -> torch.Tensor:
    """Load vector (f, v) on the CG space; Dirichlet rows zeroed."""
    from hpdg_tpu_torch.assemble.rhs import l2_functional
    b = cg.scatter(l2_functional(cg.dg, f, dtype=dtype,
                                 device=cg.device)[cg.degree])
    if dirichlet:
        b = torch.where(torch.as_tensor(cg.boundary, device=cg.device),
                        0.0, b)
    return b
