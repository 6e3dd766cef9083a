"""Port vs reference: the solvers of the sharded layer and the l1
smoothers, in f64 on the 8 virtual CPU devices against a one-process
group of 8 shards (the adaptive loop is in
``test_torch_parallel_adaptive.py``).

* ``parallel.obstacle.solve_tnnmg_sharded``: the history columns
  (truncated counts exactly, corrections/damping 1e-8), the energy at
  1e-10 relative and the iterate at 1e-9 after a fixed iteration count;
* ``solvers.smoothers.l1_shifts``/``l1_jacobi_step``/
  ``l1_projected_jacobi_step``: one step each at 1e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks.api import l2_functional as r_l2
from hpdg_tpu.parallel import hp as rhp
from hpdg_tpu.parallel import obstacle as robs
from hpdg_tpu.solvers import smoothers as rsm

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble import l2_functional as t_l2
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.parallel import hp as thp
from hpdg_tpu_torch.parallel import obstacle as tobs
from hpdg_tpu_torch.parallel.comm import ShardGroup
from hpdg_tpu_torch.solvers import smoothers as tsm

from test_torch_parallel_hp import KW, rel_err

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


# ------------------------------------------------------------------ TNNMG
def test_sharded_tnnmg_matches_reference():
    cells = (16, 2)
    deg = np.random.default_rng(30).choice([1, 2], size=32)
    R = rhp.build_hp_sharded_pmg(cells, deg, devices=jax.devices(),
                                 coarse_cg_iters=3, **KW)
    T = thp.build_hp_sharded_pmg(cells, deg, group=group(),
                                 coarse_cg_iters=3, **KW)
    rb = RBasis(rmesh.structured(cells), deg)
    tb = TBasis(tmesh.structured(cells), deg)
    fr, ft = R.levels[-1], T.levels[-1]
    b_r = r_l2(rb, lambda x: jnp.ones_like(x[..., 0]))
    b_t = t_l2(tb, lambda x: torch.ones_like(x[..., 0]), device=CPU)
    lo_r = {q: jnp.full_like(v, -jnp.inf) for q, v in b_r.items()}
    up_r = {q: jnp.full_like(v, 0.01) for q, v in b_r.items()}
    lo_t = {q: torch.full_like(v, -torch.inf) for q, v in b_t.items()}
    up_t = {q: torch.full_like(v, 0.01) for q, v in b_t.items()}
    kw = dict(tol=0.0, maxiter=4, pre_sweeps=2, inner_cg_iters=2)
    xr, hr = robs.solve_tnnmg_sharded(
        R, fr.scatter_global(b_r, rb), fr.scatter_global(lo_r, rb),
        fr.scatter_global(up_r, rb), **kw)
    xt, ht = tobs.solve_tnnmg_sharded(
        T, ft.scatter_global(b_t, tb), ft.scatter_global(lo_t, tb),
        ft.scatter_global(up_t, tb), **kw)
    assert hr["iterations"] == ht["iterations"] == 4
    assert hr["truncated"] == ht["truncated"]
    assert max(ht["truncated"]) > 0
    np.testing.assert_allclose(ht["correction"], hr["correction"],
                               rtol=1e-8)
    np.testing.assert_allclose(ht["damping"], hr["damping"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(ht["energy"], hr["energy"], rtol=1e-10)
    assert rel_err(xr, xt) <= 1e-9


# ----------------------------------------------------------- l1 smoothers
def test_l1_smoothers_match_reference():
    cells = (4, 4)
    deg = np.random.default_rng(31).choice([1, 2], size=16)
    rb = RBasis(rmesh.structured(cells), deg)
    tb = TBasis(tmesh.structured(cells), deg)
    Ar = r_laplace(rb, **KW)
    At = t_laplace(tb, **KW, device=CPU)
    # ghost couplings of a two-slab split along axis 0
    shard = (np.arange(16) // 4 >= 2).astype(int)
    ghost = {}
    for (pr, pc), (rows, cols) in Ar.pattern.entries.items():
        er = rb.bucket_elems[pr][rows]
        ec = rb.bucket_elems[pc][cols]
        ghost[(pr, pc)] = np.nonzero(shard[er] != shard[ec])[0]
    sr = rsm.l1_shifts(Ar, ghost)
    st = tsm.l1_shifts(At, ghost)
    assert rel_err(sr, st) <= 1e-13
    assert max(float(np.abs(np.asarray(v)).max()) for v in sr.values()) > 0
    rng = np.random.default_rng(32)
    x = {p: rng.standard_normal((rb.bucket_size(p), (p + 1) ** 2))
         for p in rb.bucket_degrees}
    b = {p: rng.standard_normal(v.shape) for p, v in x.items()}
    J = lambda d: {p: jnp.asarray(v) for p, v in d.items()}  # noqa: E731
    T = lambda d: convert.bucket_dict(d, device=CPU)  # noqa: E731
    yr = rsm.l1_jacobi_step(Ar, sr, omega=0.8)(J(x), J(b))
    yt = tsm.l1_jacobi_step(At, st, omega=0.8)(T(x), T(b))
    assert rel_err(yr, yt) <= 1e-13
    lo = {p: -0.3 * np.ones_like(v) for p, v in x.items()}
    up = {p: 0.2 * np.ones_like(v) for p, v in x.items()}
    yr = rsm.l1_projected_jacobi_step(Ar, sr, J(lo), J(up))(J(x), J(b))
    yt = tsm.l1_projected_jacobi_step(At, st, T(lo), T(up))(T(x), T(b))
    assert rel_err(yr, yt) <= 1e-13
