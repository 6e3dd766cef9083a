"""Multi-shard hp Poisson: sharded mixed-degree SIPG and the sharded hp
p-multigrid.

Port of ``examples/parallel_poisson.py``: a random {2, 3} degree map
(seed 1887) on a structured mesh, slab-partitioned over the shards of a
one-process group (``--shards``, default one per visible card; cut to a
divisor of ``cells[0]``), V-cycle-preconditioned CG with group psums,
and an optional checkpoint of the sharded state.

    python -m hpdg_tpu_torch.examples.parallel_poisson --cells 16,8 \
        --degrees 2,3 --iters 25 --shards 8 [--checkpoint DIR] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import mesh as hmesh
from hpdg_tpu_torch.assemble import l2_functional
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.parallel.comm import ShardGroup
from hpdg_tpu_torch.parallel.hp import (build_hp_sharded_pmg,
                                        hp_pmg_pcg_solve, hp_norm)
from hpdg_tpu_torch.utils import parse_cli


def run(cells=(16, 8), degs=(2, 3), iters: int = 25, shards=None,
        checkpoint: str = "", device=None) -> dict:
    """Solve; returns ``x`` (sharded), ``rel``, ``pmg`` and ``basis``."""
    group0 = ShardGroup(1, device=device)
    ndev = int(shards) if shards else max(torch.cuda.device_count(), 1)
    while cells[0] % ndev:
        ndev -= 1
    group = ShardGroup(ndev, device=group0.device)
    kind = "cpu" if group.device.type == "cpu" else "gpu"
    print(f"devices: {ndev} x {kind}")

    rng = np.random.default_rng(1887)
    n = int(np.prod(cells))
    degrees = rng.choice(list(degs), size=n)
    gbasis = DGBasis(hmesh.structured(cells), degrees)
    print(f"mesh {tuple(cells)}, degrees {sorted(set(degrees.tolist()))}, "
          f"{gbasis.ndof} dofs")

    pmg = build_hp_sharded_pmg(cells, degrees, group=group, penalty=2.0,
                               dirichlet=True, penalty_scaling="normal")
    fine = pmg.levels[-1]
    b = fine.scatter_global(
        l2_functional(gbasis, lambda x: torch.ones_like(x[..., 0]),
                      device=group.device), gbasis)
    x, rel = hp_pmg_pcg_solve(pmg, b, iters=iters)
    print(f"sharded MG-PCG: rel residual {float(rel):.2e} "
          f"after {iters} iterations; |x| = {float(hp_norm(x, group)):.6f}")
    if checkpoint:
        from hpdg_tpu_torch.utils.checkpoint import save_solver_state
        save_solver_state(checkpoint, x, degrees, iteration=iters,
                          cells=cells)
        print(f"checkpointed sharded state to {checkpoint}")
    return dict(x=x, rel=float(rel), pmg=pmg, basis=gbasis)


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    cells = tuple(int(c) for c in
                  str(cfg.get_path("cells", "16,8")).split(","))
    degs = [int(d) for d in str(cfg.get_path("degrees", "2,3")).split(",")]
    return run(cells, degs, int(cfg.get_path("iters", 25)),
               cfg.get_path("shards"), cfg.get_path("checkpoint", ""),
               cfg.get_path("device"))


if __name__ == "__main__":
    main()
