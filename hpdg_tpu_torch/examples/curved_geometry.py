"""Poisson SIPG on a genuinely CURVED (trilinear Q1) domain.

Port of ``examples/curved_geometry.py``: the annulus quarter (2D) or the
quarter hollow cylinder (3D) is meshed by mapping a structured lattice
through polar coordinates and sampling the map at the element corners
(``geometry.isoparametric``); every operator then consumes the per-point
Jacobians.  A manufactured solution with non-zero Dirichlet data shows
the convergence rate under uniform refinement; the map is re-sampled on
each level, so the geometry converges with the mesh.

    python -m hpdg_tpu_torch.examples.curved_geometry --n 6 --p 2 --levels 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import mesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.estimators.error import l2_error
from hpdg_tpu_torch.examples.meshes import annulus_quarter, cylinder_quarter
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.mesh import geometry as geo
from hpdg_tpu_torch.solvers import smoothers
from hpdg_tpu_torch.solvers.cg import pcg

PENALTY = 4.0


def u_exact(x):
    """sin(pi x) sin(pi y) [cos(pi z)]: -Laplace u = dim pi^2 u."""
    u = torch.sin(torch.pi * x[..., 0]) * torch.sin(torch.pi * x[..., 1])
    return u * torch.cos(torch.pi * x[..., 2]) if x.shape[-1] == 3 else u


def run(n: int = 6, p: int = 2, levels: int = 2, dim: int = 2,
        device=None) -> list:
    """One record per level: ``basis``, the solution ``x``, the PCG
    ``info``, the domain ``volume`` (exact: 3 pi / 4), the nodal
    root-mean-square error ``nodal_err`` and the L2 error ``l2_err``
    against the manufactured solution."""
    device = dev.resolve(device)
    phi = annulus_quarter if dim == 2 else cylinder_quarter
    mp = mesh.structured((n,) * dim)  # parametric lattice
    records = []
    for lvl in range(levels):
        if lvl:
            mp = mesh.refine(mp)
        m = geo.isoparametric(mp, phi)
        basis = DGBasis(m, np.full(m.n_elements, p))
        A = api.laplace(basis, penalty=PENALTY, dirichlet=True,
                        penalty_scaling="normal", device=device)
        b = api.l2_functional(
            basis, lambda x: dim * torch.pi ** 2 * u_exact(x),
            quad_order=2 * p + 4, device=device)
        bd = api.dirichlet_data(basis, u_exact, penalty=PENALTY,
                                penalty_scaling="normal", device=device)
        b = {q: b[q] + bd[q] for q in b}
        M = smoothers.block_jacobi_preconditioner(A)
        x, info = pcg(lambda v: bm.matvec(A, v), b, precond=M, tol=1e-12,
                      maxiter=4000)
        ui = api.interpolate(basis, u_exact, device=device)
        nodal = float(torch.sqrt(torch.mean((x[p] - ui[p]) ** 2)))
        records.append(dict(level=lvl, basis=basis, x=x, info=info,
                            volume=float(m.volumes.sum()), nodal_err=nodal,
                            l2_err=float(l2_error(basis, x, u_exact))))
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    prev = None
    for r in run(args.n, args.p, args.levels, args.dim, args.device):
        print(f"level {r['level']}: {r['basis'].mesh.n_elements} curved "
              f"elements, volume {r['volume']:.6f} (exact "
              f"{3 * np.pi / 4:.6f}), nodal err {r['nodal_err']:.3e}"
              + (f", ratio {prev / r['nodal_err']:.1f}x" if prev else ""))
        prev = r["nodal_err"]


if __name__ == "__main__":
    main()
