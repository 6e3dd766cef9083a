"""Port vs reference: ``parallel.adaptive.sharded_adaptive_solve``, in
f64 on the 8 virtual CPU devices against a one-process group of 8
shards.

* block-Jacobi PCG under the ``planes``, ``balanced``, ``morton`` and
  ``inherit`` partitions and in ``hp_mode``: the meshes and degree maps
  of every cycle exactly, the info lists (element counts, balance and
  plan reuse exactly; eta 1e-10; residuals 1e-10 absolute), the final x
  at 1e-9;
* the ``mg-pcg`` solver, which builds ``build_hp_sharded_pmg(gmesh=...)``
  on the first mesh and ``build_hp_sharded_hmg_general`` on the
  refinement history after: the meshes exactly, eta 1e-10, the
  residuals 1e-8, the final x at 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.parallel import adaptive as radp

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.parallel import adaptive as tadp
from hpdg_tpu_torch.parallel.comm import ShardGroup

from test_torch_parallel_hp import rel_err

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    # the reference's native topology builds its library in place (R10)
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def group(n=8):
    return ShardGroup(n, CPU)


ADAPT_CASES = {
    "planes": dict(partition="planes"),
    "balanced": dict(partition="balanced"),
    "morton": dict(partition="morton"),
    "inherit": dict(partition="inherit"),
    "hp_mode": dict(hp_mode=True),
}


@pytest.mark.parametrize("case", list(ADAPT_CASES))
def test_sharded_adaptive_solve_modes(case):
    kw = dict(cycles=2, frac=0.3, penalty=2.0, penalty_scaling="normal",
              cg_iters=60, **ADAPT_CASES[case])
    m0r, m0t = rmesh.structured((16, 2)), tmesh.structured((16, 2))
    mr, dr, xr, ir = radp.sharded_adaptive_solve(
        m0r, np.full(32, 2), lambda x: jnp.ones_like(x[..., 0]),
        devices=jax.devices(), **kw)
    mt, dt, xt, it = tadp.sharded_adaptive_solve(
        m0t, np.full(32, 2), lambda x: torch.ones_like(x[..., 0]),
        group=group(), **kw)
    np.testing.assert_array_equal(mr.lower, mt.lower)
    np.testing.assert_array_equal(mr.extent, mt.extent)
    np.testing.assert_array_equal(dr, dt)
    for key in ("n_elements", "balance", "plan_reuse"):
        assert ir[key] == it[key], key
    assert len(ir["plan_seconds"]) == len(it["plan_seconds"])
    np.testing.assert_allclose(it["eta"], ir["eta"], rtol=1e-10)
    np.testing.assert_allclose(it["residual"], ir["residual"], rtol=0,
                               atol=1e-10)
    assert rel_err(xr, xt) <= 1e-9
    if case == "planes":
        assert it["n_elements"][-1] > it["n_elements"][0]


def test_adaptive_mg_pcg_solver():
    kw = dict(cycles=2, frac=0.3, penalty=2.0, penalty_scaling="normal",
              cg_iters=6, solver="mg-pcg")
    mr, dr, xr, ir = radp.sharded_adaptive_solve(
        rmesh.structured((16, 2)), np.full(32, 2),
        lambda x: jnp.ones_like(x[..., 0]), devices=jax.devices(), **kw)
    mt, dt, xt, it = tadp.sharded_adaptive_solve(
        tmesh.structured((16, 2)), np.full(32, 2),
        lambda x: torch.ones_like(x[..., 0]), group=group(), **kw)
    np.testing.assert_array_equal(mr.lower, mt.lower)
    np.testing.assert_array_equal(dr, dt)
    assert ir["n_elements"] == it["n_elements"]
    assert ir["balance"] == it["balance"]
    np.testing.assert_allclose(it["eta"], ir["eta"], rtol=1e-10)
    np.testing.assert_allclose(it["residual"], ir["residual"], rtol=1e-8)
    assert rel_err(xr, xt) <= 1e-9
