"""Membrane obstacle problem via TNNMG (BASELINE config 5).

Port of ``examples/obstacle.py``: -Δu = -8 on (-1, 1)^2 with u >= psi.

    python -m hpdg_tpu_torch.examples.obstacle --n 8 --p 2 \
        --obstacle -0.15 [--device cpu]
"""

from __future__ import annotations

import numpy as np

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import mesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.utils import parse_cli


def run(n: int = 8, p: int = 2, psi: float = -0.15,
        vtu: str | None = None, device=None) -> dict:
    """Solve; returns ``basis``, ``x`` and the TNNMG ``info``."""
    device = dev.resolve(device)
    m = mesh.structured((n, n), lower=(-1, -1), upper=(1, 1))
    basis = DGBasis(m, np.full(m.n_elements, p))
    A = api.laplace(basis, penalty=2.0, dirichlet=True, device=device)
    b = api.l2_functional(basis, lambda x: -8.0 + 0.0 * x[..., 0],
                          device=device)
    lo, up = api.constant_bounds(basis, lower=psi, device=device)
    x, info = api.solve_obstacle(basis, A, b, lo, up, tol=1e-10, maxiter=80)
    print(f"TNNMG: {info['iterations']} iterations, "
          f"final correction {info['correction'][-1]:.2e}, "
          f"truncated dofs at convergence: {info['truncated'][-1]}")
    if vtu:
        from hpdg_tpu_torch.blocks.plot import write_vtu
        write_vtu(vtu, basis, x)
    return dict(basis=basis, x=x, info=info)


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    return run(cfg.get_path("n", 8), cfg.get_path("p", 2),
               cfg.get_path("obstacle", -0.15), cfg.get_path("vtu"),
               cfg.get_path("device"))


if __name__ == "__main__":
    main()
