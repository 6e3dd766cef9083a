"""3D linear elasticity hp-DG with h+p multigrid (BASELINE config 4).

Port of ``examples/elasticity.py`` (``models.ElasticityProblem`` on a
refined cube).  The reference's ``--sharded`` branch (curved-domain
elasticity over all devices) needs the sharded elasticity operator,
ROADMAP queue 1, item 21b, and raises until then.

    python -m hpdg_tpu_torch.examples.elasticity --n 2 --levels 1 --p 2 \
        [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import mesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockmatrix as bm, blockvector as bv
from hpdg_tpu_torch.models import ElasticityProblem
from hpdg_tpu_torch.utils import parse_cli


def run(n: int = 2, levels: int = 1, p: int = 2, device=None) -> dict:
    """Solve; returns ``ndof``, ``info`` and the final ``residual``."""
    device = dev.resolve(device)
    meshes = mesh.hierarchy(mesh.structured((n, n, n)), levels)
    basis = DGBasis(meshes[-1], np.full(meshes[-1].n_elements, p))
    prob = ElasticityProblem(basis, mu=1.0, lam=1.0, penalty=4.0,
                             device=device)

    def force(x):
        f0 = 3 * torch.pi**2 * (torch.sin(torch.pi * x[..., 0])
                                * torch.sin(torch.pi * x[..., 1])
                                * torch.sin(torch.pi * x[..., 2]))
        z = torch.zeros_like(f0)
        return torch.stack([f0, z, z], dim=-1)

    b = prob.rhs(force)
    x, info = prob.solve(b, tol=1e-8, meshes=meshes)
    r = float(bv.norm(bv.sub(b, bm.matvec(prob.A, x))))
    print(f"elasticity: {3 * basis.ndof} dofs, {info['iterations']} "
          f"V-cycles, residual {r:.2e}")
    return dict(ndof=3 * basis.ndof, info=info, residual=r)


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    if cfg.get_path("sharded", 0):
        raise NotImplementedError("--sharded needs the port's sharded "
                                  "elasticity (ROADMAP queue 1, item 21b)")
    return run(cfg.get_path("n", 2), cfg.get_path("levels", 1),
               cfg.get_path("p", 2), cfg.get_path("device"))


if __name__ == "__main__":
    main()
