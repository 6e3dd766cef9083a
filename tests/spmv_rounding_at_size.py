"""The rounding of the block SpMV on the obstacle problem of the
sharded-TNNMG check (128^2 at p=3, f32, f = 1, upper obstacle 0.01,
penalty 2, "normal" scaling, Dirichlet), on one CUDA card.

The serial fused TNNMG runs twice, once with ``blockmatrix.matvec`` (K2
on the card) and once with every SpMV replaced by ``plain_matvec`` (the
gather, ``bmm`` and ``index_add_`` route), and the sharded TNNMG once,
each to tol 1e-6 (the serial ones at most 560 iterations).  The script
prints each run's iterations and last energy, the iterates' largest
differences and, for each iterate x, its energy 0.5 x.Ax - b.x in f64
(the f64 matrix) and in f32 by both SpMV routes, and the error of
``A32 x`` by each route against ``A64 x``: its mean, its rms and its
inner product with x (the shift it gives x.Ax).

Run on a card from the repo root:

    python3 tests/spmv_rounding_at_size.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpdg_tpu_torch import mesh as hmesh  # noqa: E402
from hpdg_tpu_torch.assemble import assemble_laplace, l2_functional  # noqa: E402
from hpdg_tpu_torch.basis.dgbasis import DGBasis  # noqa: E402
from hpdg_tpu_torch.linalg import blockmatrix as bm  # noqa: E402
from hpdg_tpu_torch.linalg import blockvector as bv  # noqa: E402
from hpdg_tpu_torch.parallel.comm import ShardGroup  # noqa: E402
from hpdg_tpu_torch.parallel.hp import build_hp_sharded_pmg  # noqa: E402
from hpdg_tpu_torch.parallel.obstacle import solve_tnnmg_sharded  # noqa: E402
from hpdg_tpu_torch.solvers import smoothers  # noqa: E402
from hpdg_tpu_torch.solvers.tnnmg import solve_tnnmg  # noqa: E402

N2, P, PENALTY, SCALING = 128, 3, 2.0, "normal"


def use(matvec):
    """Route every assembled SpMV of the TNNMG through ``matvec``."""
    bm.matvec = matvec
    smoothers.matvec = matvec


def energy(matvec, A, b, x) -> float:
    return float(0.5 * bv.dot(x, matvec(A, x)) - bv.dot(b, x))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    k2 = bm.matvec
    cells, degrees = (N2, N2), np.full(N2 * N2, P)
    basis = DGBasis(hmesh.structured(cells), degrees)
    kw = dict(penalty=PENALTY, dirichlet=True, penalty_scaling=SCALING,
              device=dev)
    A32 = assemble_laplace(basis, dtype=torch.float32, **kw)
    A64 = assemble_laplace(basis, dtype=torch.float64, **kw)
    b32, b64 = (l2_functional(basis, lambda x: torch.ones_like(x[..., 0]),
                              dtype=dt, device=dev)
                for dt in (torch.float32, torch.float64))
    lo = {q: torch.full_like(v, -torch.inf) for q, v in b32.items()}
    up = {q: torch.full_like(v, 0.01) for q, v in b32.items()}

    xs = {}
    for name, matvec in (("K2", k2), ("plain", bm.plain_matvec)):
        use(matvec)
        xs[name], info = solve_tnnmg(A32, b32, basis, lo, up, tol=1e-6,
                                     maxiter=560, fused=True)
        print(f"serial TNNMG, {name} SpMV: {info['iterations']} iterations, "
              f"last energy {info['energy'][-1]:.9e}", flush=True)
    use(k2)
    pmg = build_hp_sharded_pmg(cells, degrees, group=ShardGroup(8, dev),
                               penalty=PENALTY, dirichlet=True,
                               dtype=torch.float32, coarse_cg_iters=3,
                               penalty_scaling=SCALING)
    fine = pmg.levels[-1]
    bs, los, ups = (fine.scatter_global(v, basis) for v in (b32, lo, up))
    x_sh, info = solve_tnnmg_sharded(pmg, bs, los, ups, tol=1e-6,
                                     maxiter=120)
    xs["sharded"] = fine.gather_global(x_sh, basis)
    print(f"sharded TNNMG: {info['iterations']} iterations, last energy "
          f"{info['energy'][-1]:.9e}", flush=True)

    names = list(xs)
    for i, a in enumerate(names):
        for c in names[i + 1:]:
            d = max(float((xs[a][q] - xs[c][q]).abs().max()) for q in xs[a])
            print(f"max |x_{a} - x_{c}| = {d:.3e}")
    for name, x in xs.items():
        x64 = {q: v.double() for q, v in x.items()}
        y64 = k2(A64, x64)
        xf = torch.cat([v.flatten() for v in x64.values()])
        line = [f"x_{name}: energy f64 {energy(k2, A64, b64, x64):.9e}"]
        for route, matvec in (("K2", k2), ("plain", bm.plain_matvec)):
            y = matvec(A32, x)
            err = torch.cat([(y[q].double() - y64[q]).flatten() for q in y])
            line.append(f"{route}: energy f32 {energy(matvec, A32, b32, x):.9e}"
                        f", A32 x - A64 x mean {float(err.mean()):.3e} rms "
                        f"{float(err.pow(2).mean().sqrt()):.3e} x.err "
                        f"{float(xf @ err):.3e}")
        print("; ".join(line), flush=True)


if __name__ == "__main__":
    main()
