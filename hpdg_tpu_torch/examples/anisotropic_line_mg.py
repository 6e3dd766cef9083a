"""Anisotropic diffusion on stretched cells: line-smoothed multigrid.

Port of ``examples/anisotropic_line_mg.py``.  On stretched elements the
strong coupling runs along the short axis; element-block smoothers leave
the along-line error modes undamped and multigrid degrades.  This solves
3D SIPG Poisson on 4:1-stretched cells twice, element-block GS against
line smoothing (exact batched block-Thomas solves along the short axis,
``solvers.lines``), and prints both convergence histories.  With
``--sharded 1`` the same problem runs through the sharded hp-multigrid
(``parallel.hp.build_hp_sharded_hmg``, semicoarsening the line axis,
h-levels first) over a one-process group of ``--shards`` shards
(default one per visible card), Chebyshev over block Jacobi against
Chebyshev over the sharded line preconditioner.

    python -m hpdg_tpu_torch.examples.anisotropic_line_mg --cells 8,2,2 \
        --p 2 --cycles 8 [--sharded 1 --shards 8] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import mesh as hmesh
from hpdg_tpu_torch.assemble import assemble_laplace, l2_functional
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockmatrix as bm, blockvector as bv
from hpdg_tpu_torch.utils import parse_cli

KW = dict(penalty=6.0, dirichlet=True, penalty_scaling="normal")


def rhs(basis, dtype=torch.float64, device=None):
    return l2_functional(
        basis, lambda x: 3 * torch.pi**2 * torch.sin(torch.pi * x[..., 0])
        * torch.sin(torch.pi * x[..., 1]) * torch.sin(torch.pi * x[..., 2]),
        dtype=dtype, device=device)


def run_serial(cells=(8, 2, 2), p: int = 2, cycles: int = 8,
               device=None) -> dict:
    """``{smoother: (rate per cycle, relative residual history)}`` for
    ``gs`` and ``line``, ``cycles`` V-cycles each from zero."""
    from hpdg_tpu_torch.solvers.multigrid import multigrid_solver
    device = dev.resolve(device)
    basis = DGBasis(hmesh.structured(cells),
                    np.full(int(np.prod(cells)), p))
    A = assemble_laplace(basis, **KW, device=device)
    b = rhs(basis, device=device)
    nb = float(bv.norm(b))
    out = {}
    for smoother, damp in [("gs", 1.0), ("line", 1.0)]:
        step, _ = multigrid_solver(basis, A, smoother=smoother,
                                   jacobi_damping=damp)
        x = bv.zeros_like(b)
        hist = []
        for _ in range(cycles):
            x = step(x, b)
            hist.append(float(bv.norm(bv.sub(b, bm.matvec(A, x)))) / nb)
        rate = (hist[-1] / hist[0]) ** (1.0 / (len(hist) - 1))
        print(f"serial {smoother:>4}: rate/cycle {rate:.3f}  "
              f"history {['%.1e' % h for h in hist]}")
        out[smoother] = (rate, hist)
    return out


def run_sharded(cells=(16, 8, 8), p: int = 2, cycles: int = 8, shards=None,
                device=None) -> dict:
    """``{smoother: (rate per cycle, history)}`` for ``cheb`` and
    ``line`` through the sharded hierarchy."""
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.parallel.hp import build_hp_sharded_hmg, hp_norm
    device = dev.resolve(device)
    ndev = int(shards) if shards else max(torch.cuda.device_count(), 1)
    group = ShardGroup(ndev, device=device)
    n = int(np.prod(cells))
    # semicoarsen the stretched (line) axis down to isotropy
    lax = int(np.argmax(cells))
    chain = [tuple(cells)]
    while chain[0][lax] > 2 * min(cells):
        c = list(chain[0])
        c[lax] //= 2
        chain.insert(0, tuple(c))
    gbasis = DGBasis(hmesh.structured(cells), np.full(n, p))
    b_dict = rhs(gbasis, device=device)
    out = {}
    for smoother in ("cheb", "line"):
        pmg = build_hp_sharded_hmg(cells, np.full(n, p), cells_chain=chain,
                                   h_first=True, smoother=smoother,
                                   dtype=torch.float64, group=group, **KW)
        fine = pmg.levels[-1]
        print(f"sharded {smoother:>4}: device grid {fine.device_grid}")
        b = fine.scatter_global(b_dict, gbasis)
        x = {q: torch.zeros_like(v) for q, v in b.items()}
        nb = float(hp_norm(b, group))
        hist = []
        for _ in range(cycles):
            x = pmg.step(x, b)
            r = {q: b[q] - v for q, v in fine.apply(x).items()}
            hist.append(float(hp_norm(r, group)) / nb)
        rate = (hist[-1] / hist[0]) ** (1.0 / (len(hist) - 1))
        print(f"sharded {smoother:>4}: rate/cycle {rate:.3f}  "
              f"history {['%.1e' % h for h in hist]}")
        out[smoother] = (rate, hist)
    return out


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    cells = tuple(int(c) for c in
                  str(cfg.get_path("cells", "8,2,2")).split(","))
    p = int(cfg.get_path("p", 2))
    cycles = int(cfg.get_path("cycles", 8))
    if int(cfg.get_path("sharded", 0)):
        return run_sharded(cells, p, cycles, cfg.get_path("shards"),
                           cfg.get_path("device"))
    return run_serial(cells, p, cycles, cfg.get_path("device"))


if __name__ == "__main__":
    main()
