"""Implicit-Euler heat equation with hp-multigrid per step.

Port of ``examples/heat.py``: the full implicit system (M + dt A) of
the heat operator is solved with the assembled multigrid each step
(``models.HeatProblem``), and the M-norm of the state must not grow.

    python -m hpdg_tpu_torch.examples.heat --n 16 --p 2 --dt 0.01 \
        --steps 10 [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import mesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.linalg import blockmatrix as bm, blockvector as bv
from hpdg_tpu_torch.models import HeatProblem
from hpdg_tpu_torch.utils import parse_cli


def run(n: int = 16, p: int = 2, dt: float = 0.01, steps: int = 10,
        device=None) -> list:
    """March ``steps`` implicit-Euler steps from a Gaussian bump;
    returns the M-norms squared, one per step."""
    device = dev.resolve(device)
    m = mesh.structured((n, n))
    basis = DGBasis(m, np.full(m.n_elements, p))
    prob = HeatProblem(basis, dt=dt, device=device)
    u = api.interpolate(basis, lambda x: torch.exp(
        -50 * ((x[..., 0] - 0.5) ** 2 + (x[..., 1] - 0.5) ** 2)),
        device=device)
    energy0 = float(bv.dot(u, bm.matvec(prob.M, u)))
    out = []
    for k in range(steps):
        u, info = prob.advance(u)
        l2sq = float(bv.dot(u, bm.matvec(prob.M, u)))
        print(f"t={dt * (k + 1):.3f}: ||u||_M^2 = {l2sq:.6f} "
              f"(mg iters {info['iterations']})")
        assert l2sq <= energy0 + 1e-10, "heat flow must dissipate"
        out.append(l2sq)
    return out


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    return run(cfg.get_path("n", 16), cfg.get_path("p", 2),
               cfg.get_path("dt", 0.01), cfg.get_path("steps", 10),
               cfg.get_path("device"))


if __name__ == "__main__":
    main()
