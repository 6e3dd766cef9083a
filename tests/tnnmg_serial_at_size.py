"""The serial TNNMG of the reference and of the port on the obstacle
problem of the sharded-TNNMG check (n^2 at degree p, f32, f = 1, upper
obstacle 0.01, penalty 2, "normal" scaling, Dirichlet): both run the same
fixed number of iterations, the port once on the reference's assembled
matrix and right-hand side and once on its own, and the script prints
each run's energy and correction every 10 iterations and its iterate
and energy difference from the reference.

Run on the CPU from the repo root (slow at the default 128^2 p=3: the
reference's eager JAX calls take most of it):

    JAX_PLATFORMS=cpu python tests/tnnmg_serial_at_size.py [n] [p] [its]
"""

import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpdg_tpu import mesh as rmesh  # noqa: E402
from hpdg_tpu.assemble import assemble_laplace as r_laplace  # noqa: E402
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis  # noqa: E402
from hpdg_tpu.blocks.api import l2_functional as r_l2  # noqa: E402
from hpdg_tpu.solvers.tnnmg import solve_tnnmg as r_solve  # noqa: E402

from hpdg_tpu_torch import convert  # noqa: E402
from hpdg_tpu_torch import mesh as tmesh  # noqa: E402
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace  # noqa: E402
from hpdg_tpu_torch.assemble import l2_functional as t_l2  # noqa: E402
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis  # noqa: E402
from hpdg_tpu_torch.linalg import blockmatrix as t_bm  # noqa: E402
from hpdg_tpu_torch.linalg import blockvector as t_bv  # noqa: E402
from hpdg_tpu_torch.solvers.tnnmg import solve_tnnmg as t_solve  # noqa: E402


def main(n=128, p=3, its=40):
    cells = (n, n)
    deg = np.full(n * n, p)
    rb = RBasis(rmesh.structured(cells), deg)
    tb = TBasis(tmesh.structured(cells), deg)
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
    RA = r_laplace(rb, dtype=jnp.float32, **kw)
    TA = t_laplace(tb, dtype=torch.float32, device="cpu", **kw)
    pat = RA.pattern
    RA_t, RA64 = (convert.block_sparse_matrix(
        pat.row_sizes, pat.col_sizes, pat.entries,
        {k: np.asarray(v, dt) for k, v in RA.values.items()}, RA.dim,
        device="cpu", block_shape=RA.block_shape)
        for dt in (np.float32, np.float64))
    da = max(float(np.abs(np.asarray(RA.values[k])
                          - TA.values[k].numpy()).max()) for k in RA.values)
    print(f"{n}^2 p={p} ({rb.ndof} dofs, f32): assembled matrices differ "
          f"by {da:.3e}", flush=True)
    rbv = r_l2(rb, lambda x: jnp.ones_like(x[..., 0]), dtype=jnp.float32)
    tbv = t_l2(tb, lambda x: torch.ones_like(x[..., 0]), dtype=torch.float32,
               device="cpu")
    rbv_t = convert.bucket_dict({q: np.asarray(v) for q, v in rbv.items()},
                                device="cpu")
    b64 = convert.bucket_dict({q: np.asarray(v, np.float64)
                               for q, v in rbv.items()}, device="cpu")

    def energy64(x):
        x = convert.bucket_dict(x, dtype=torch.float64, device="cpu")
        return float(0.5 * t_bv.dot(x, t_bm.matvec(RA64, x))
                     - t_bv.dot(b64, x))

    out = {}
    for name, solve, A, basis, b, like in (
            ("reference", r_solve, RA, rb, rbv, jnp.full_like),
            ("port on the reference's A, b", t_solve, RA_t, tb, rbv_t,
             torch.full_like),
            ("port on its own A, b", t_solve, TA, tb, tbv, torch.full_like)):
        lo = {q: like(v, -np.inf) for q, v in b.items()}
        up = {q: like(v, 0.01) for q, v in b.items()}
        t = time.perf_counter()
        x, info = solve(A, b, basis, lo, up, tol=1e-6, maxiter=its)
        x = {q: np.asarray(v) for q, v in x.items()}
        print(f"{name}: {info['iterations']} its in "
              f"{time.perf_counter() - t:.1f} s, energy "
              f"{info['energy'][-1]:.9e}; energy every 10 its "
              f"{[f'{e:.6e}' for e in info['energy'][::10]]}; correction "
              f"every 10 its {[f'{c:.3e}' for c in info['correction'][::10]]}"
              f", last {info['correction'][-1]:.3e}; energy of the final "
              f"iterate in f64 {energy64(x):.9e}", flush=True)
        out[name] = x, info
    xr, hr = out["reference"]
    scale = max(float(np.abs(v).max()) for v in xr.values())
    for name in list(out)[1:]:
        xt, ht = out[name]
        err = max(float(np.abs(xr[q] - xt[q]).max()) for q in xr)
        de = abs(hr["energy"][-1] - ht["energy"][-1])
        print(f"{name} vs reference: iterate difference {err:.3e} of max "
              f"{scale:.3e}; energy difference {de:.3e} "
              f"({de / abs(hr['energy'][-1]):.3e} relative)", flush=True)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
