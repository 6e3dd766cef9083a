"""Poisson SIPG on a general (affine-element) domain.

Port of ``examples/affine_geometry.py``: the same solver stack on a
sheared parallelogram domain (one global affine map) and on a twisted 3D
column (per-element affinized smooth map).

    python -m hpdg_tpu_torch.examples.affine_geometry --case shear --n 12 --p 2
    python -m hpdg_tpu_torch.examples.affine_geometry --case twist --n 6 --p 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import mesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.mesh import geometry as geo
from hpdg_tpu_torch.solvers import smoothers
from hpdg_tpu_torch.solvers.cg import pcg

SHEAR = np.array([[1.0, 0.5], [0.0, 1.0]])


def twisted_column(x):
    th = 0.6 * x[..., 2]
    c, s = np.cos(th), np.sin(th)
    return np.stack([c * x[..., 0] - s * x[..., 1],
                     s * x[..., 0] + c * x[..., 1], x[..., 2]], -1)


def run(case: str = "shear", n: int = 12, p: int = 2, device=None) -> dict:
    """Solve -Laplace u = 1 with zero Dirichlet data; returns ``basis``,
    ``x``, the PCG ``info``, the domain ``volume`` and the relative
    residual ``rel_residual`` of the returned iterate."""
    device = dev.resolve(device)
    if case == "shear":
        m = geo.affine_image(mesh.structured((n, n)), SHEAR)
    elif case == "twist":
        m = geo.affinize(mesh.structured((n, n, n)), twisted_column)
    else:
        raise ValueError(f"unknown case {case!r}")
    basis = DGBasis(m, np.full(m.n_elements, p))
    A = api.laplace(basis, penalty=4.0, dirichlet=True,
                    penalty_scaling="normal", device=device)
    b = api.l2_functional(basis, lambda x: torch.ones_like(x[..., 0]),
                          device=device)
    M = smoothers.block_jacobi_preconditioner(A)
    x, info = pcg(lambda v: bm.matvec(A, v), b, precond=M, tol=1e-10,
                  maxiter=800)
    rel = float(bv.norm(bv.sub(b, bm.matvec(A, x))) / bv.norm(b))
    return dict(basis=basis, x=x, info=info,
                volume=float(np.sum(m.volumes)), rel_residual=rel)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="shear", choices=("shear", "twist"))
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    r = run(args.case, args.n, args.p, args.device)
    print(f"case={args.case}: {r['basis'].mesh.n_elements} affine elements, "
          f"domain volume {r['volume']:.4f}, solved to rel residual "
          f"{r['rel_residual']:.2e} in {r['info']['iterations']} PCG "
          f"iterations")


if __name__ == "__main__":
    main()
