"""Batched (weighted) mass matrix assembly.

Port of ``hpdg_tpu.assemble.mass``: the BuildingBlocks::mass analog and
the lumped Gauss-Lobatto collocation mass.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import quadrature
from hpdg_tpu_torch.assemble.plan import AssemblyPlan
from hpdg_tpu_torch.assemble.rhs import volume_detj
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg.blockmatrix import (BlockPattern,
                                               BlockSparseMatrix,
                                               zeros_values)
from hpdg_tpu_torch.mesh import geometry as geo


def blockdiag_pattern(basis: DGBasis) -> BlockPattern:
    sizes = {p: basis.bucket_size(p) for p in basis.bucket_degrees}
    entries = {
        (p, p): (np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32))
        for p, n in sizes.items()
    }
    return BlockPattern(sizes, sizes, entries)


def assemble_mass(basis: DGBasis, weight=None, quad_order=None,
                  dtype=torch.float64, plan: AssemblyPlan | None = None,
                  device=None) -> BlockSparseMatrix:
    """Block-diagonal (weighted) mass matrix.

    If ``plan`` is given, the mass blocks are placed in the plan's full
    skeleton pattern (zero off-diagonal blocks) so the result can be
    added to a stiffness matrix.
    """
    device = dev.resolve(device)
    mesh = basis.mesh
    dim = mesh.dim
    pattern = plan.pattern if plan is not None else blockdiag_pattern(basis)
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    vals = zeros_values(pattern, dim, dtype=dtype, device=device)
    for p in basis.bucket_degrees:
        order = quad_order if quad_order is not None else 2 * p
        nq1 = max(2, -(-(order + 3) // 2))
        vt = tensor.volume_tables(p, dim, nq1, family=basis.family)
        V, w = vt["V"], vt["weights"]
        elems = basis.bucket_elems[p]
        xp = (mesh.lower[elems][:, None, :]
              + vt["points"][None, :, :] * mesh.extent[elems][:, None, :])
        detq = J(volume_detj(mesh, elems, xp))  # per-point on Q1 meshes
        if weight is None and not geo.is_trilinear(mesh):
            M0 = J(np.einsum("iq,q,jq->ij", V, w, V))
            blocks = detq[:, :1, None] * M0[None]
        else:
            kw = J(w)[None, :] * detq
            if weight is not None:
                kw = weight(J(geo.apply_map(mesh, elems, xp))).to(dtype) * kw
            blocks = torch.einsum("eq,iq,jq->eij", kw, J(V), J(V))
        n = basis.bucket_size(p)
        vals[(p, p)][:n] += blocks
    return BlockSparseMatrix(pattern, dim, vals)


def lumped_mass(basis: DGBasis, dtype=torch.float64, device=None) -> dict:
    """Diagonal Gauss-Lobatto collocation mass vector.

    Uses the (p+1)-point GL rule collocated with the nodal basis, so the
    mass matrix is exactly diagonal: m_i = detJ(node_i) * prod_a w_{i_a},
    for general geometry too.  Returns a bucketed block vector.
    """
    device = dev.resolve(device)
    mesh = basis.mesh
    out = {}
    for p in basis.bucket_degrees:
        if basis.family != "lobatto":
            raise NotImplementedError("lumped mass needs collocation nodes")
        nodes, w1 = quadrature.gauss_lobatto(p + 1)
        mi = tensor.multiindices(p, basis.dim)
        wloc = np.prod(w1[mi], axis=1)  # (nl,)
        elems = basis.bucket_elems[p]
        detJ = np.prod(mesh.extent[elems], axis=1)[:, None]  # (n, 1)
        if geo.has_geometry(mesh):
            xp = (mesh.lower[elems][:, None, :]
                  + nodes[mi][None, :, :] * mesh.extent[elems][:, None, :])
            detJ = detJ * geo.detj_phys(mesh, elems, xp)  # (n, nl)
        out[p] = torch.as_tensor(detJ * wloc[None, :], dtype=dtype,
                                 device=device)
    return out
