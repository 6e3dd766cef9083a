"""Port vs reference: the sharded hp-multigrid hierarchies of
``parallel/hp.py``, in f64 on the 8 virtual CPU devices against a
one-process group of 8 shards.

* ``build_hp_sharded_pmg`` + ``hp_pmg_pcg_solve``: the iterate and the
  relative residual after a fixed iteration count at 1e-10;
* ``build_hp_sharded_hmg``: the level degree maps exactly, one V-cycle
  at 1e-10 for the default chain and a (4, 2) device grid, and a
  fixed-iteration PCG on the default chain (the h-first orderings, the
  line smoother and the general-mesh hierarchies are in
  ``test_torch_parallel_hmg.py``);
* ``_child_T_matrices``, ``_coarsen_degree_map`` and ``_geo_T`` tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu.parallel import hp as rhp

from hpdg_tpu_torch import convert
from hpdg_tpu_torch.parallel import hp as thp
from hpdg_tpu_torch.parallel.comm import ShardGroup

from test_torch_parallel_hp import KW, rand_sharded, rel_err

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


def vcycle_pair(R, T, seed):
    b = rand_sharded(R.levels[-1], seed)
    zr = jax.jit(R.step)({p: jnp.zeros_like(jnp.asarray(v))
                          for p, v in b.items()},
                         {p: jnp.asarray(v) for p, v in b.items()})
    bt = convert.sharded(b, T.levels[-1].group)
    zt = T.step({p: torch.zeros_like(v) for p, v in bt.items()}, bt)
    return zr, zt


def assert_same_maps(R, T):
    assert len(R.levels) == len(T.levels)
    for a, b in zip(R.degree_maps, T.degree_maps):
        np.testing.assert_array_equal(a, b)
    for lr, lt in zip(R.levels, T.levels):
        assert lr.m_own == lt.m_own and lr.cells == lt.cells


def test_pmg_pcg_fixed_iterations():
    cells = (16, 2)
    deg = np.random.default_rng(20).choice([1, 2], size=32)
    R = rhp.build_hp_sharded_pmg(cells, deg, devices=jax.devices(),
                                 coarse_cg_iters=5, **KW)
    T = thp.build_hp_sharded_pmg(cells, deg, group=group(),
                                 coarse_cg_iters=5, **KW)
    assert_same_maps(R, T)
    b = rand_sharded(R.levels[-1], 21)
    xr, rr = rhp.hp_pmg_pcg_solve(R, {p: jnp.asarray(v)
                                      for p, v in b.items()}, iters=3)
    xt, rt = thp.hp_pmg_pcg_solve(T, convert.sharded(b, T.levels[-1].group),
                                  iters=3)
    assert rel_err(xr, xt) <= 1e-10
    assert abs(float(rr) - float(rt)) <= 1e-10 * float(rr)


HMG_CASES = {
    "default": dict(cells=(16, 4), degs=[1, 2], kw=dict(h_levels=1)),
    "grid42": dict(cells=(16, 8), degs=[1, 2],
                   kw=dict(h_levels=1, device_grid=(4, 2))),
}


@pytest.mark.parametrize("case", list(HMG_CASES))
def test_hmg_vcycle(case):
    c = HMG_CASES[case]
    cells = c["cells"]
    deg = np.random.default_rng(24).choice(c["degs"],
                                           size=int(np.prod(cells)))
    R = rhp.build_hp_sharded_hmg(cells, deg, devices=jax.devices(),
                                 coarse_cg_iters=4, cheb_degree=3,
                                 **c["kw"], **KW)
    T = thp.build_hp_sharded_hmg(cells, deg, group=group(),
                                 coarse_cg_iters=4, cheb_degree=3,
                                 **c["kw"], **KW)
    assert_same_maps(R, T)
    zr, zt = vcycle_pair(R, T, 25)
    assert rel_err(zr, zt) <= 1e-10
    if case == "default":
        b = rand_sharded(R.levels[-1], 26)
        xr, rr = rhp.hp_pmg_pcg_solve(R, {p: jnp.asarray(v)
                                          for p, v in b.items()}, iters=2)
        xt, rt = thp.hp_pmg_pcg_solve(
            T, convert.sharded(b, T.levels[-1].group), iters=2)
        assert rel_err(xr, xt) <= 1e-10
        assert abs(float(rr) - float(rt)) <= 1e-10 * float(rr)


def test_hmg_refusals():
    with pytest.raises(ValueError, match="cannot h-coarsen"):
        thp.build_hp_sharded_hmg((8, 4), np.ones(32), h_levels=2,
                                 group=group())
    with pytest.raises(ValueError, match="cells_chain"):
        thp.build_hp_sharded_hmg((8, 4), np.ones(32),
                                 cells_chain=[(4, 4), (8, 2)],
                                 group=group())


def test_transfer_tables():
    for pc, pf, dim, halve in [(2, 1, 2, (True, True)),
                               (3, 3, 3, (True, False, True)),
                               (1, 1, 2, (False, True))]:
        for a, b in zip(rhp._child_T_matrices(pc, pf, dim, halve,
                                              jnp.float64),
                        thp._child_T_matrices(pc, pf, dim, halve)):
            np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-15)
    deg = np.random.default_rng(27).choice([1, 2, 3, 4], size=64)
    for rule in ("max", "min"):
        np.testing.assert_array_equal(
            rhp._coarsen_degree_map(deg, (8, 8), (4, 4), rule),
            thp._coarsen_degree_map(deg, (8, 8), (4, 4), rule))
    np.testing.assert_allclose(
        np.asarray(rhp._geo_T(2, 2, [0.5, 0.5], [0.5, 0.0], "lobatto",
                              jnp.float64)),
        thp._geo_T(2, 2, [0.5, 0.5], [0.5, 0.0], "lobatto"),
        rtol=0, atol=1e-15)
