"""Right-hand-side functionals: the L2 load vector on box meshes.

Port of ``hpdg_tpu.assemble.rhs.l2_functional`` (BuildingBlocks::
l2Functional analog).  The Dirichlet-data functional and curved
geometry wait for later items of ROADMAP queue 1.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis


def l2_functional(basis: DGBasis, f, quad_order=None, dtype=torch.float64,
                  device=None) -> dict:
    """b_i = ∫ f phi_i, as a bucketed block vector.

    ``f`` is a vectorized callable on tensors of physical points
    (..., dim).  Default quadrature: Gauss-Legendre exact to order 2p+2.
    """
    device = dev.resolve(device)
    mesh = basis.mesh
    dim = mesh.dim
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    out = {}
    for p in basis.bucket_degrees:
        order = quad_order if quad_order is not None else 2 * p + 2
        nq1 = max(1, (order + 2) // 2)
        vt = tensor.volume_tables(p, dim, nq1, family=basis.family,
                                  quad_family="legendre")
        V, w = vt["V"], vt["weights"]
        elems = basis.bucket_elems[p]
        ext = mesh.extent[elems]
        detJ = np.prod(ext, axis=1)[:, None]
        x = (mesh.lower[elems][:, None, :]
             + vt["points"][None, :, :] * ext[:, None, :])
        fv = f(as_t(x)).to(dtype)
        fw = fv * as_t(w)[None, :] * as_t(detJ)
        out[p] = torch.einsum("eq,iq->ei", fw, as_t(V))
    return out
