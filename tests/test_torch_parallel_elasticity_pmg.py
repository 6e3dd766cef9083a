"""Port vs reference: the sharded elasticity multigrid of
``parallel/elasticity.py`` (``build_sharded_elasticity_pmg``), in f64 on
the 8 virtual CPU devices against a one-process group of 8 shards.

* one V-cycle with ``h_levels`` 0 and 1, box and curved meshes,
  Chebyshev and vertex-patch smoothing (2D, and 3D on the box with one
  h-level), at 1e-11, and the per-level rho estimates at 1e-12;
* ``elasticity_pmg_pcg_solve`` and ``solve_sharded_elasticity_pmg``
  after a fixed count at 1e-10.

Each reference hierarchy is built once and its V-cycle compiled under
``jax.jit``.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu.parallel import elasticity as rel

from hpdg_tpu_torch.parallel import elasticity as tel
from hpdg_tpu_torch.parallel.comm import ShardGroup

from test_torch_parallel_comm import rel_err
from test_torch_parallel_elasticity import meshes

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    # the reference's native topology builds its library in place (R10)
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


@functools.lru_cache(maxsize=None)
def pmg_pair(kind, h_levels, smoother, cells=(16, 2)):
    p = 2
    kw = dict(mu=1.0, lam=1.5, penalty=8.0, dirichlet=True,
              penalty_scaling="normal", coarse_cg_iters=5,
              h_levels=h_levels, smoother=smoother)
    gr, gt = meshes(cells, kind)
    R = rel.build_sharded_elasticity_pmg(cells, p, devices=jax.devices(),
                                         gmesh=gr, **kw)
    T = tel.build_sharded_elasticity_pmg(cells, p, group=ShardGroup(8, CPU),
                                         gmesh=gt, **kw)
    return R, T


PMG_CASES = [("box", 0, "cheb", (16, 2)), ("box", 1, "patch", (16, 2)),
             ("tri", 0, "cheb", (16, 2)), ("tri", 1, "cheb", (16, 2)),
             ("box", 1, "patch", (16, 2, 2))]


@pytest.mark.parametrize(
    "kind,h_levels,smoother,cells", PMG_CASES,
    ids=[f"{k}-h{h}-{s}" + ("-3d" if len(c) == 3 else "")
         for k, h, s, c in PMG_CASES])
def test_sharded_elasticity_pmg_vcycle(kind, h_levels, smoother, cells):
    R, T = pmg_pair(kind, h_levels, smoother, cells)
    assert len(T.levels) == len(R.levels) == 2 + h_levels
    assert [(lv.cells, lv.p) for lv in T.levels] == \
        [(lv.cells, lv.p) for lv in R.levels]
    # the reference keeps its rho estimates in the V-cycle's closure
    run = inspect.getclosurevars(R.step).nonlocals["run"]
    want = inspect.getclosurevars(run).nonlocals["lmaxs"]
    np.testing.assert_allclose(T.lmaxs, want, rtol=1e-12, atol=0)
    fine = R.levels[-1]
    b = np.random.default_rng(3).standard_normal((fine.n_global, fine.bs))
    B = jax.device_put(jnp.asarray(b), fine.sharding)
    zr = jax.jit(R.step)(jnp.zeros_like(B), B)
    zt = T.step(torch.zeros(b.shape, dtype=torch.float64),
                torch.as_tensor(b))
    assert rel_err(zr, zt) <= 1e-11


def test_sharded_elasticity_pmg_pcg_and_cycles():
    R, T = pmg_pair("box", 0, "cheb")
    fine = R.levels[-1]
    b = np.random.default_rng(5).standard_normal((fine.n_global, fine.bs))
    B = jax.device_put(jnp.asarray(b), fine.sharding)
    xr, rr = rel.elasticity_pmg_pcg_solve(R, B, iters=2)
    xt, rt = tel.elasticity_pmg_pcg_solve(T, torch.as_tensor(b), iters=2)
    assert rel_err(xr, xt) <= 1e-10
    assert abs(float(rr) - float(rt)) <= 1e-10 * float(rr)
    xr, nr = rel.solve_sharded_elasticity_pmg(R, B, cycles=2)
    xt, nt = tel.solve_sharded_elasticity_pmg(T, torch.as_tensor(b),
                                              cycles=2)
    assert rel_err(xr, xt) <= 1e-10
    assert abs(float(nr) - float(nt)) <= 1e-10 * float(nr)
