"""The sharded elasticity p-multigrid of the reference and of the port
under both penalty scalings, on the curved mesh of ``chip_smoke.py``
phase 16b at n^3 (13b's quarter hollow cylinder, p=2, mu 1, lam 1,
penalty 4, Dirichlet, Chebyshev smoothing, 8 shards): for each scaling
the script prints both packages' per-level rho estimates and the
port's relative residual after ``its`` pmg-PCG iterations, verified by
the serial f64 operator.  The pmg's block-Jacobi blocks take the
"measure" scaling whatever the operator's (the reference's
``elasticity_dinv_mul``), which in 3D under "normal" shows as low rho
estimates and a stalled solve.

Run on the CPU from the repo root:

    JAX_PLATFORMS=cpu python tests/elasticity_pmg_scaling.py [n] [its]
"""

import inspect
import os
import sys
import time
from dataclasses import replace
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
os.environ["HPDG_NATIVE_TOPOLOGY"] = "0"  # the reference's Python matcher
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpdg_tpu import mesh as rmesh  # noqa: E402
from hpdg_tpu.mesh import geometry as rgeo  # noqa: E402
from hpdg_tpu.parallel import elasticity as rel  # noqa: E402

from hpdg_tpu_torch import mesh as tmesh  # noqa: E402
from hpdg_tpu_torch.assemble import l2_functional_vec  # noqa: E402
from hpdg_tpu_torch.basis.dgbasis import DGBasis  # noqa: E402
from hpdg_tpu_torch.examples.meshes import cylinder_quarter  # noqa: E402
from hpdg_tpu_torch.matrixfree.elasticity import (  # noqa: E402
    elasticity_operator)
from hpdg_tpu_torch.mesh import geometry as tgeo  # noqa: E402
from hpdg_tpu_torch.parallel import elasticity as tel  # noqa: E402
from hpdg_tpu_torch.parallel.comm import ShardGroup  # noqa: E402

import chip_smoke  # noqa: E402


def curved(hm, geo, n):
    """13b's mesh at n^3 in C-lattice order (``chip_smoke.py`` 16b)."""
    mf = geo.isoparametric(hm.structured((max(n // 4, 1),) * 3),
                           cylinder_quarter)
    for _ in range(2):
        mf = hm.refine(mf)
    order = chip_smoke._lattice_order(mf, (n,) * 3)
    return replace(hm.structured((n,) * 3), corners=mf.corners[order])


def main(n: int = 8, its: int = 40):
    p, cells = 2, (n,) * 3
    kw = dict(mu=1.0, lam=1.0, penalty=4.0, dirichlet=True)
    gr, gt = curved(rmesh, rgeo, n), curved(tmesh, tgeo, n)
    basis = DGBasis(gt, np.full(gt.n_elements, p))
    b = l2_functional_vec(basis, chip_smoke._elasticity_force,
                          device="cpu")[p]
    for scaling in ("measure", "normal"):
        t = time.perf_counter()
        R = rel.build_sharded_elasticity_pmg(
            cells, p, devices=jax.devices(), gmesh=gr,
            penalty_scaling=scaling, **kw)
        run = inspect.getclosurevars(R.step).nonlocals["run"]
        r_lmax = inspect.getclosurevars(run).nonlocals["lmaxs"]
        T = tel.build_sharded_elasticity_pmg(
            cells, p, group=ShardGroup(8, "cpu"), gmesh=gt,
            penalty_scaling=scaling, **kw)
        serial = elasticity_operator(basis, penalty_scaling=scaling,
                                     device="cpu", **kw)
        x, rel_res = tel.elasticity_pmg_pcg_solve(T, b, iters=its)
        verified = float((b - serial({p: x})[p]).norm() / b.norm())
        print(f"{scaling}: rho estimates reference "
              f"{[round(v, 6) for v in r_lmax]}, port "
              f"{[round(v, 6) for v in T.lmaxs]}; port pmg-PCG {its} "
              f"iterations: recursive {float(rel_res):.3e}, verified "
              f"{verified:.3e} ({time.perf_counter() - t:.1f} s)",
              flush=True)


if __name__ == "__main__":
    torch.set_num_threads(8)
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
