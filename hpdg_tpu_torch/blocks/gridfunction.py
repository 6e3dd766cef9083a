"""Discrete grid functions: point evaluation of DG fields.

Port of ``hpdg_tpu.blocks.gridfunction`` (the reference's grid-function
layer): evaluate a coefficient vector, and its gradient, at arbitrary
physical points of a box mesh.  The points are located and the 1D
Lagrange tables evaluated on the host in numpy; the contraction with the
coefficients runs on the device of ``x``, batched per degree bucket.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch.basis import lagrange, tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis


def locate(mesh, pts: np.ndarray, chunk: int = 4096) -> np.ndarray:
    """Element id containing each point (ties -> lowest id; -1 if
    outside)."""
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    out = np.full(len(pts), -1, dtype=np.int64)
    lo = mesh.lower
    hi = mesh.lower + mesh.extent
    eps = mesh.extent.min() * 1e-12
    for s in range(0, len(pts), chunk):
        P = pts[s:s + chunk]  # (m, dim)
        inside = np.all((P[:, None, :] >= lo[None] - eps)
                        & (P[:, None, :] <= hi[None] + eps), axis=2)
        hit = inside.argmax(axis=1)
        ok = inside[np.arange(len(P)), hit]
        out[s:s + chunk] = np.where(ok, hit, -1)
    return out


def evaluate(basis: DGBasis, x: dict, pts: np.ndarray,
             gradient: bool = False):
    """Values (and optionally gradients) of the DG field at the points.

    Returns (m,) values, or (values, (m, dim) gradients), as host numpy
    f64.
    """
    mesh = basis.mesh
    dim = mesh.dim
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    elems = locate(mesh, pts)
    if (elems < 0).any():
        raise ValueError("points outside the mesh")
    vals = np.zeros(len(pts))
    grads = np.zeros((len(pts), dim)) if gradient else None
    for p in basis.bucket_degrees:
        sel = np.flatnonzero(basis.degrees[elems] == p)
        if not len(sel):
            continue
        e = elems[sel]
        h = mesh.extent[e]
        xr = (pts[sel] - mesh.lower[e]) / h                  # (k, dim)
        nodes = lagrange.nodes_1d(p, basis.family)
        mi = tensor.multiindices(p, dim)                     # (bs, dim)
        # per-axis values / derivatives at each point: (k, dim, p+1)
        lv = np.stack([lagrange.lagrange_values(nodes, xr[:, a]).T
                       for a in range(dim)], axis=1)
        tabs = [np.prod(lv[:, np.arange(dim), mi], axis=-1)]  # (k, bs)
        if gradient:
            ld = np.stack([lagrange.lagrange_derivatives(nodes, xr[:, a]).T
                           for a in range(dim)], axis=1)
            for a in range(dim):
                f = np.where(np.arange(dim)[None, None, :] == a,
                             ld[:, np.arange(dim), mi],
                             lv[:, np.arange(dim), mi])
                tabs.append(np.prod(f, axis=-1) / h[:, a:a + 1])
        xp = x[p]
        coef = xp[torch.as_tensor(basis.elem_bucket_pos[e], dtype=torch.int64,
                                  device=xp.device)].double()
        phi = torch.as_tensor(np.stack(tabs), device=xp.device)
        out = torch.einsum("tkb,kb->tk", phi, coef).cpu().numpy()
        vals[sel] = out[0]
        if gradient:
            grads[sel] = out[1:].T
    return (vals, grads) if gradient else vals
