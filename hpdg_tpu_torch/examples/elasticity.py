"""3D linear elasticity hp-DG with h+p multigrid (BASELINE config 4).

Port of ``examples/elasticity.py`` (``models.ElasticityProblem`` on a
refined cube).  With ``--sharded 1`` a curved-domain elasticity problem
then runs through the sharded p-multigrid-preconditioned CG
(``parallel.elasticity``) over a one-process group of ``--shards``
shards (default 8, the reference's 8 devices): the wavy isoparametric
mesh on (2 shards, 4) cells, p=2.

    python -m hpdg_tpu_torch.examples.elasticity --n 2 --levels 1 --p 2 \
        [--sharded 1 --shards 8] [--device cpu]
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


def run_sharded(shards: int = 8, device=None) -> dict:
    """Curved-domain elasticity through the sharded pmg-PCG (25
    iterations); returns ``ndev``, ``ndof`` and the relative residual
    ``rel``."""
    from hpdg_tpu_torch.mesh import geometry as geo
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.parallel.elasticity import (
        build_sharded_elasticity_pmg, elasticity_pmg_pcg_solve)
    group = ShardGroup(shards, device=dev.resolve(device))
    ndev = group.ndev
    cells = (2 * ndev, 4)

    def wavy(xx):
        xx = np.asarray(xx, np.float64)
        return np.stack(
            [xx[..., 0] + 0.06 * np.sin(np.pi * xx[..., 1]),
             xx[..., 1] + 0.05 * np.sin(np.pi * xx[..., 0] / 2)], -1)

    gm = geo.isoparametric(mesh.structured(cells), wavy)
    pmg = build_sharded_elasticity_pmg(
        cells, 2, mu=1.0, lam=1.5, penalty=8.0, dirichlet=True,
        penalty_scaling="normal", gmesh=gm, group=group)
    fine = pmg.levels[-1]
    rng = np.random.default_rng(0)
    b = rng.standard_normal((fine.n_global, fine.bs))
    bsh = torch.as_tensor(group.local_rows(b, fine.n_local),
                          dtype=torch.float64, device=group.device)
    _, rel = elasticity_pmg_pcg_solve(pmg, bsh, iters=25)
    rel = float(rel)
    ndof = fine.n_global * fine.bs
    print(f"sharded curved elasticity: {ndev} devices, {ndof} dofs, "
          f"rel residual {rel:.2e}")
    return dict(ndev=ndev, ndof=ndof, rel=rel)


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    out = run(cfg.get_path("n", 2), cfg.get_path("levels", 1),
              cfg.get_path("p", 2), cfg.get_path("device"))
    if cfg.get_path("sharded", 0):
        out["sharded"] = run_sharded(int(cfg.get_path("shards", 8)),
                                     cfg.get_path("device"))
    return out


if __name__ == "__main__":
    main()
