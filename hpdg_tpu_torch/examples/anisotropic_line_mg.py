"""Anisotropic diffusion on stretched cells: line-smoothed multigrid.

Port of ``examples/anisotropic_line_mg.py``.  On stretched elements the
strong coupling runs along the short axis; element-block smoothers leave
the along-line error modes undamped and multigrid degrades.  This solves
3D SIPG Poisson on 4:1-stretched cells twice, element-block GS against
line smoothing (exact batched block-Thomas solves along the short axis,
``solvers.lines``), and prints both convergence histories.  The
reference's ``--sharded`` branch needs the port's parallel layer
(ROADMAP queue 1, item 21) and raises until then.

    python -m hpdg_tpu_torch.examples.anisotropic_line_mg --cells 8,2,2 \
        --p 2 --cycles 8 [--device cpu]
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


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    cells = tuple(int(c) for c in
                  str(cfg.get_path("cells", "8,2,2")).split(","))
    p = int(cfg.get_path("p", 2))
    cycles = int(cfg.get_path("cycles", 8))
    if int(cfg.get_path("sharded", 0)):
        raise NotImplementedError("--sharded needs the port's parallel "
                                  "layer (ROADMAP queue 1, item 21)")
    return run_serial(cells, p, cycles, cfg.get_path("device"))


if __name__ == "__main__":
    main()
