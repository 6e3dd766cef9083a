"""Poisson SIPG with hp-multigrid, 2D or 3D.

Port of ``examples/poisson.py``: -Δu = f on the unit square or cube
with u = prod sin(pi x_a), Dirichlet boundaries, SIPG (penalty 2), the
assembled hp-multigrid, and the L2 error against u.

    python -m hpdg_tpu_torch.examples.poisson --dim 2 --n 16 --p 3 \
        --tol 1e-8 --vtu out.vtu [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import mesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.blocks.plot import write_vtu
from hpdg_tpu_torch.estimators import l2_error
from hpdg_tpu_torch.utils import parse_cli


def run(dim: int = 2, n: int = 16, p: int = 2, tol: float = 1e-8,
        vtu: str | None = None, device=None) -> dict:
    """Solve; returns ``basis``, ``x``, ``info`` and ``l2_error``."""
    device = dev.resolve(device)
    m = mesh.structured((n,) * dim)
    basis = DGBasis(m, np.full(m.n_elements, p))

    def u(x):
        out = 1.0
        for a in range(dim):
            out = out * torch.sin(torch.pi * x[..., a])
        return out

    f = lambda x: dim * torch.pi**2 * u(x)  # noqa: E731
    A = api.laplace(basis, penalty=2.0, dirichlet=True, device=device)
    b = api.l2_functional(basis, f, device=device)
    x, info = api.solve_linear(basis, A, b, tol=tol, maxiter=100)
    err = float(l2_error(basis, x, u))
    print(f"solved in {info['iterations']} V-cycles; L2 error = {err:.3e}")
    if vtu:
        write_vtu(vtu, basis, x)
        print("wrote", vtu)
    return dict(basis=basis, x=x, info=info, l2_error=err)


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    return run(cfg.get_path("dim", 2), cfg.get_path("n", 16),
               cfg.get_path("p", 2), cfg.get_path("tol", 1e-8),
               cfg.get_path("vtu"), cfg.get_path("device"))


if __name__ == "__main__":
    main()
