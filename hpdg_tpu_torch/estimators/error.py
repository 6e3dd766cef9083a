"""Discretization-error norms against a known exact solution.

Port of ``hpdg_tpu.estimators.error``: batched Gauss
quadrature of ``||u_h - u||`` per degree bucket, summed globally on the
device of ``x``.  The exact solution is a callable on a tensor of
physical points ``(..., dim)`` (on that device, in f64).
Geometry-aware: points, volume elements and gradients go through the
mesh's affine or trilinear map.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.mesh import geometry as geo


def _bucket(basis: DGBasis, x: dict, p: int, quad_inc: int):
    """Tables of bucket p at the Gauss rule, its physical points, the
    volume element per element and point, the extents and (on meshes
    with geometry, else None) the inverse Jacobians, as f64 tensors on
    x's device."""
    vt = tensor.volume_tables(p, basis.dim, p + 1 + quad_inc,
                              family=basis.family, quad_family="legendre")
    mesh = basis.mesh
    elems = basis.bucket_elems[p]
    lo, ext = mesh.lower[elems], mesh.extent[elems]
    xp = lo[:, None, :] + vt["points"][None, :, :] * ext[:, None, :]
    J = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                  device=x[p].device)
    det, Ji = np.prod(ext, axis=1)[:, None], None
    if geo.has_geometry(mesh):
        Ji, dA = geo.pullback_factors(mesh, elems, xp)
        det, Ji = det * dA, J(Ji)
    return vt, J, J(geo.apply_map(mesh, elems, xp)), J(det), J(ext), Ji


def l2_error(basis: DGBasis, x: dict, u_exact, quad_inc: int = 3):
    """sqrt(int (u_h - u)^2) as a 0-d f64 tensor on x's device."""
    total = 0.0
    for p in basis.bucket_degrees:
        vt, J, xq, det, _, _ = _bucket(basis, x, p, quad_inc)
        uh = x[p].double() @ J(vt["V"])
        total = total + (det * J(vt["weights"])[None, :]
                         * (uh - u_exact(xq)) ** 2).sum()
    return torch.sqrt(total)


def h1_seminorm_error(basis: DGBasis, x: dict, grad_exact,
                      quad_inc: int = 3):
    """sqrt(sum_E int_E |grad u_h - grad u|^2), the broken H1 seminorm,
    as a 0-d f64 tensor on x's device; ``grad_exact`` maps points
    ``(..., dim)`` to gradients ``(..., dim)``."""
    total = 0.0
    for p in basis.bucket_degrees:
        vt, J, xq, det, ext, Ji = _bucket(basis, x, p, quad_inc)
        # physical gradient: reference derivative over the extent per
        # axis (times J^-1 on meshes with geometry)
        gh = torch.einsum("ei,aiq->eqa", x[p].double(),
                          J(vt["G"])) / ext[:, None, :]
        if Ji is not None:
            gh = torch.einsum("eqb,eqba->eqa", gh, Ji)
        total = total + (det * J(vt["weights"])[None, :]
                         * ((gh - grad_exact(xq)) ** 2).sum(dim=-1)).sum()
    return torch.sqrt(total)
