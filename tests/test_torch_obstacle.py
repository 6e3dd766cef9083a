"""Port vs reference: the obstacle pipeline (BASELINE config 5) and the
building-block API, in f64 unless stated.

* ``truncated_matrix`` at 1e-15 (and it keeps the pattern object);
* three ``projected_block_gs_step`` steps at 1e-12;
* one ``parametric_cycle`` on a renewed truncated hierarchy with
  h-levels at 1e-11;
* ``solve_tnnmg``: the default path, ``truncate_hierarchy`` and the
  vector-valued elasticity contact — iteration counts and truncated
  counts equal, energies at rtol 1e-10, x at 1e-10;
* ``api.solve_obstacle`` against ``tests/golden.npz`` (c5);
* the fused loop against the stepwise one: equal in f64; in f32 both
  stall and the counts differ by at most 2 from the reference's;
* ``solve_obstacle_verified`` at 8^2 p=2: verified, the reference's
  truncated count, x within 1e-7 of the reference's;
* the feasibility and complementarity checks refuse NaN (the
  reference's R4);
* ``api.solve_linear`` by every method, and the refusals.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble.elasticity import assemble_elasticity as r_elast
from hpdg_tpu.assemble.elasticity import l2_functional_vec as r_l2v
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks import api as rapi
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.solvers import multigrid as rmg
from hpdg_tpu.solvers import smoothers as rsm
from hpdg_tpu.solvers import tnnmg as rtn

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import api as tapi
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.solvers import multigrid as tmg
from hpdg_tpu_torch.solvers import smoothers as tsm
from hpdg_tpu_torch.solvers import tnnmg as ttn

from test_torch_galerkin import assert_close, jx, to_port

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
GOLDEN = os.path.join(os.path.dirname(__file__), "golden.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def problem(n, p):
    """The membrane-into-obstacle problem of tests/test_obstacle.py on
    n^2 at degree p: (reference basis, port basis, reference matrix,
    port matrix, b, lo, up) with b/lo/up as numpy bucket dicts."""
    rm = rmesh.structured((n, n), lower=(-1, -1), upper=(1, 1))
    tm = tmesh.structured((n, n), lower=(-1, -1), upper=(1, 1))
    deg = np.full(rm.n_elements, p)
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    RA = rapi.laplace(rb, penalty=2.0, dirichlet=True)
    b = rapi.l2_functional(rb, lambda x: -8.0 + 0.0 * x[..., 0])
    lo, up = rapi.constant_bounds(rb, lower=-0.2)
    npd = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return rb, tb, RA, to_port(RA), npd(b), npd(lo), npd(up)


def tt(x, dtype=None):
    return convert.bucket_dict(x, dtype=dtype, device=CPU)


def max_diff(want, got):
    return max(float(np.abs(np.asarray(want[k])
                            - got[k].detach().cpu().numpy()).max())
               for k in want)


def test_truncated_matrix_matches_reference():
    rb, tb, RA, TA, *_ = problem(4, 2)
    rng = np.random.default_rng(5)
    free = {p: rng.random((rb.bucket_size(p), rb.n_local(p))) > 0.3
            for p in rb.bucket_degrees}
    want = rtn.truncated_matrix(RA, jx(free))
    got = ttn.truncated_matrix(TA, tt(free))
    assert got.pattern is TA.pattern
    assert_close({k: np.asarray(v) for k, v in want.values.items()},
                 got.values, 1e-15)


@pytest.mark.parametrize("n,p", [(3, 2), (4, 1)])
def test_projected_block_gs_steps_match_reference(n, p):
    rb, tb, RA, TA, b, lo, up = problem(n, p)
    rstep = jax.jit(rtn.projected_block_gs_step(RA, rb, jx(lo), jx(up)))
    tstep = ttn.projected_block_gs_step(TA, tb, tt(lo), tt(up))
    xr, xt = jx({k: np.zeros_like(v) for k, v in b.items()}), \
        tt({k: np.zeros_like(v) for k, v in b.items()})
    for _ in range(3):
        xr, xt = rstep(xr, jx(b)), tstep(xt, tt(b))
        assert_close(xr, xt, 1e-12)
    assert all(bool((xt[k] >= tt(lo)[k]).all()) for k in xt)


def test_parametric_cycle_matches_reference():
    """One cycle on the truncated hierarchy p2 4^2 -> p1 4^2 -> p1 2^2,
    renewed from a truncated fine matrix; the renewal keeps every
    level's pattern object."""
    rms = rmesh.hierarchy(rmesh.structured((2, 2)), 1)
    tms = tmesh.hierarchy(tmesh.structured((2, 2)), 1)
    deg = np.full(rms[-1].n_elements, 2)
    rb, tb = RBasis(rms[-1], deg), TBasis(tms[-1], deg)
    RA = rapi.laplace(rb, penalty=2.0, dirichlet=True)
    TA = to_port(RA)
    rng = np.random.default_rng(11)
    free = {p: rng.random((rb.bucket_size(p), rb.n_local(p))) > 0.25
            for p in rb.bucket_degrees}
    rhs = {p: rng.standard_normal(f.shape) * f for p, f in free.items()}
    x0 = {p: rng.standard_normal(f.shape) for p, f in free.items()}

    rdata = rmg.setup_hierarchy(rb, RA, meshes=list(rms))
    rdata.renew(rtn.truncated_matrix(RA, jx(free)))
    rcyc = jax.jit(rmg.parametric_cycle(rdata))
    want = rcyc(rdata.matrices,
                [rsm.inverse_diagonal_blocks(M) for M in rdata.matrices],
                jx(x0), jx(rhs))

    tdata = tmg.setup_hierarchy(tb, TA, meshes=list(tms))
    patterns = [M.pattern for M in tdata.matrices]
    tdata.renew(ttn.truncated_matrix(TA, tt(free)))
    assert [M.pattern for M in tdata.matrices] == patterns
    assert all(a is b for a, b in zip(patterns,
                                      [M.pattern for M in tdata.matrices]))
    assert len(tdata.matrices) == 3
    tcyc = tmg.parametric_cycle(tdata)
    got = tcyc(tdata.matrices,
               [tsm.inverse_diagonal_blocks(M) for M in tdata.matrices],
               tt(x0), tt(rhs))
    assert_close(want, got, 1e-11)


def assert_same_run(hr, ht, xr, xt, x_tol=1e-10):
    assert ht["iterations"] == hr["iterations"]
    assert ht["truncated"] == hr["truncated"]
    np.testing.assert_allclose(ht["energy"], hr["energy"], rtol=1e-10)
    assert ht.get("stalled", False) == hr.get("stalled", False)
    assert max_diff(xr, xt) <= x_tol


@pytest.fixture(scope="module")
def c5():
    """The golden c5 problem (4^2 p=2) and the reference's default-path
    solve of it."""
    rb, tb, RA, TA, b, lo, up = problem(4, 2)
    xr, hr = rtn.solve_tnnmg(RA, jx(b), rb, jx(lo), jx(up), tol=1e-10,
                             maxiter=40)
    return rb, tb, RA, TA, b, lo, up, xr, hr


def test_solve_tnnmg_default_matches_reference(c5):
    rb, tb, RA, TA, b, lo, up, xr, hr = c5
    xt, ht = ttn.solve_tnnmg(TA, tt(b), tb, tt(lo), tt(up), tol=1e-10,
                             maxiter=40)
    assert max(ht["truncated"]) > 0
    assert_same_run(hr, ht, xr, xt)


def test_solve_tnnmg_truncated_hierarchy_matches_reference():
    rb, tb, RA, TA, b, lo, up = problem(3, 2)
    kw = dict(tol=1e-10, maxiter=40, truncate_hierarchy=True)
    xr, hr = rtn.solve_tnnmg(RA, jx(b), rb, jx(lo), jx(up), **kw)
    xt, ht = ttn.solve_tnnmg(TA, tt(b), tb, tt(lo), tt(up), **kw)
    assert_same_run(hr, ht, xr, xt)
    en = ht["energy"]
    assert all(e2 <= e1 + 1e-10 for e1, e2 in zip(en, en[1:]))


def test_solve_tnnmg_elasticity_contact_matches_reference():
    """Vector-valued contact of tests/test_obstacle.py:97-126: u_y >=
    -0.05, u_x free, component-major blocks, 5+5 smoothing steps."""
    rm = rmesh.structured((4, 4), lower=(-1, -1), upper=(1, 1))
    tm = tmesh.structured((4, 4), lower=(-1, -1), upper=(1, 1))
    rb, tb = RBasis(rm, np.full(16, 2)), TBasis(tm, np.full(16, 2))
    RA = r_elast(rb, mu=1.0, lam=1.0, penalty=6.0, dirichlet=True)
    TA = to_port(RA)
    b = {k: np.asarray(v) for k, v in r_l2v(rb, lambda x: jnp.stack(
        [jnp.zeros_like(x[..., 0]), -8.0 + 0.0 * x[..., 0]], -1)).items()}
    nl = 9
    lo = {2: np.concatenate([np.full((16, nl), -np.inf),
                             np.full((16, nl), -0.05)], axis=1)}
    up = {2: np.full((16, 2 * nl), np.inf)}
    kw = dict(tol=1e-9, maxiter=80)
    rstep, _ = rmg.multigrid_solver(rb, RA, pre_steps=5, post_steps=5)
    xr, hr = rtn.solve_tnnmg(RA, jx(b), rb, jx(lo), jx(up), mg_step=rstep,
                             **kw)
    tstep, _ = tmg.multigrid_solver(tb, TA, pre_steps=5, post_steps=5)
    xt, ht = ttn.solve_tnnmg(TA, tt(b), tb, tt(lo), tt(up), mg_step=tstep,
                             **kw)
    assert max(ht["truncated"]) > 0
    assert_same_run(hr, ht, xr, xt)
    assert bool((xt[2][:, nl:] >= -0.05 - 1e-9).all())


def test_api_solve_obstacle_matches_golden():
    """The port alone (its own assembly, load and bounds) against the
    golden c5 history, with the bounds of tests/test_golden.py:75-86."""
    gold = np.load(GOLDEN)
    m = tmesh.structured((4, 4), lower=(-1, -1), upper=(1, 1))
    bo = TBasis(m, np.full(16, 2))
    A = tapi.laplace(bo, penalty=2.0, dirichlet=True, device=CPU)
    b = tapi.l2_functional(bo, lambda x: -8.0 + 0.0 * x[..., 0], device=CPU)
    lo, up = tapi.constant_bounds(bo, lower=-0.2, device=CPU)
    x, info = tapi.solve_obstacle(bo, A, b, lo, up, tol=1e-10, maxiter=40)
    en = np.asarray(info["energy"])
    assert len(en) == len(gold["c5_energy"])
    assert np.allclose(en, gold["c5_energy"], rtol=1e-8)
    assert np.allclose(tbv.to_flat(bo, x), gold["c5_final"], atol=1e-8)


def test_fused_matches_stepwise_f64(c5):
    rb, tb, RA, TA, b, lo, up, _, _ = c5
    kw = dict(tol=1e-8, maxiter=30, stall_window=3)
    xr, hr = rtn.solve_tnnmg(RA, jx(b), rb, jx(lo), jx(up), **kw)
    xs, hs = ttn.solve_tnnmg(TA, tt(b), tb, tt(lo), tt(up), **kw)
    xf, hf = ttn.solve_tnnmg(TA, tt(b), tb, tt(lo), tt(up), fused=True,
                             **kw)
    assert hf == hs
    assert max_diff({k: v.numpy() for k, v in xs.items()}, xf) == 0.0
    assert_same_run(hr, hf, xr, xf)


def test_fused_matches_stepwise_f32(c5):
    """f32 to the correction floor: both paths stop by the stall rule;
    the port's two paths agree exactly, and the count is within 2 of the
    reference's (rounding in another order moves the stall)."""
    rb, tb, RA, TA, b, lo, up, _, _ = c5
    kw = dict(tol=0.0, maxiter=60, stall_window=3)
    RA32 = rbm.BlockSparseMatrix(
        RA.pattern, RA.dim,
        {k: jnp.asarray(v, jnp.float32) for k, v in RA.values.items()},
        RA.block_shape)
    j32 = lambda d: {k: jnp.asarray(v, jnp.float32)  # noqa: E731
                     for k, v in d.items()}
    _, hr = rtn.solve_tnnmg(RA32, j32(b), rb, j32(lo), j32(up), **kw)
    TA32 = to_port(RA32)
    f32 = torch.float32
    xs, hs = ttn.solve_tnnmg(TA32, tt(b, f32), tb, tt(lo, f32),
                             tt(up, f32), **kw)
    xf, hf = ttn.solve_tnnmg(TA32, tt(b, f32), tb, tt(lo, f32),
                             tt(up, f32), fused=True, **kw)
    assert hf == hs and all(torch.equal(xs[k], xf[k]) for k in xs)
    assert hr.get("stalled") and hf.get("stalled")
    assert abs(hf["iterations"] - hr["iterations"]) <= 2


def test_solve_obstacle_verified_matches_reference():
    rb, tb, RA, TA, b, lo, up = problem(8, 2)
    kw = dict(tol=1e-8, maxiter=30, max_outer=6)
    xr, ir = rtn.solve_obstacle_verified(RA, jx(b), rb, jx(lo), jx(up), **kw)
    xt, it = ttn.solve_obstacle_verified(TA, tt(b), tb, tt(lo), tt(up),
                                         **kw)
    assert it["verified"] and it["feasible"]
    assert it["free_residual"] <= 1e-8
    assert it["complementarity"] <= 1e-8
    assert it["truncated"] == ir["truncated"] > 0
    assert max(float(np.abs(xt[k] - np.asarray(xr[k])).max())
               for k in xr) <= 1e-7
    (run,) = it["runs"]
    assert run["verified"] and run["truncated"] == it["truncated"]
    assert run["steps"] == [o["steps"] for o in it["outer"]]


def test_feasibility_check_refuses_nan():
    lo = {2: np.full((2, 3), -0.2)}
    up = {2: np.full((2, 3), np.inf)}
    x = {2: np.zeros((2, 3))}
    assert ttn.check_feasible(x, lo, up)[0]
    x[2][0, 0] = -0.3
    assert not ttn.check_feasible(x, lo, up)[0]
    for val in (np.nan, np.inf):
        x[2][0, 0] = val
        assert not ttn.check_feasible(x, lo, up)[0]
    # a NaN where both bounds are infinite, in the second bucket
    lo[1], up[1] = np.full((1, 2), -np.inf), np.full((1, 2), np.inf)
    x = {2: np.zeros((2, 3)), 1: np.array([[0.0, np.nan]])}
    assert not ttn.check_feasible(x, lo, up)[0]


def test_complementarity_refuses_nan():
    lo = {2: np.full((1, 3), -0.2)}
    x = {2: np.array([[-0.2, -0.2, 0.1]])}
    free = {2: np.array([[False, False, True]])}
    r = {2: np.array([[0.5, 0.25, 0.0]])}  # lambda = -r <= 0: wrong sign
    assert ttn.complementarity(r, x, lo, free, 1e-10, 1.0) == 0.5
    r[2][0, 1] = np.nan
    assert ttn.complementarity(r, x, lo, free, 1e-10, 1.0) == np.inf
    r = {2: np.array([[-0.5, -0.25, np.nan]])}  # NaN on a free dof only
    assert ttn.complementarity(r, x, lo, free, 1e-10, 1.0) == 0.0


@pytest.mark.parametrize("method", ["multigrid", "cg+mg", "mf", "onchip"])
def test_solve_linear_matches_reference(method):
    n, p = (4, 2) if method != "mf" else (4, 4)
    rm, tm = rmesh.structured((n, n)), tmesh.structured((n, n))
    deg = np.full(rm.n_elements, p)
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    RA = rapi.laplace(rb, penalty=2.0, dirichlet=True)
    b = rapi.l2_functional(rb, lambda x: jnp.sin(np.pi * x[..., 0])
                           * jnp.sin(np.pi * x[..., 1]))
    bt = tt({k: np.asarray(v) for k, v in b.items()})
    kw = dict(tol=1e-10, maxiter=60, method=method)
    xt, it = tapi.solve_linear(tb, to_port(RA), bt, **kw)
    if method == "onchip":
        assert it["verified"] and it["rel_residual"] <= 1e-10
    else:
        xr, ir = rapi.solve_linear(rb, RA, b, **kw)
        assert it["iterations"] == int(ir["iterations"])
        scale = max(float(np.abs(np.asarray(v)).max()) for v in xr.values())
        assert max_diff(xr, xt) <= 1e-9 * scale


def test_refusals():
    """``api.mass`` and ``api.dirichlet_data`` answer as the reference
    does; the solver options the port does not have still raise."""
    m = tmesh.structured((2, 2))
    bo = TBasis(m, np.full(4, 1))
    ro = RBasis(rmesh.structured((2, 2)), np.full(4, 1))
    assert_close(rapi.mass(ro).values, tapi.mass(bo, device=CPU).values,
                 1e-13)
    assert_close(
        rapi.dirichlet_data(ro, lambda x: 1.0 + x[..., 0] * x[..., 1]),
        tapi.dirichlet_data(bo, lambda x: 1.0 + x[..., 0] * x[..., 1],
                            device=CPU), 1e-13)
    A = tapi.laplace(bo, dirichlet=True, device=CPU)
    b = tbv.zeros(bo, device=CPU)
    lo, up = tapi.constant_bounds(bo, lower=-1.0, device=CPU)
    with pytest.raises(ValueError):
        ttn.solve_tnnmg(A, b, bo, lo, up, fused=True,
                        truncate_hierarchy=True)
    if not torch.cuda.is_available():
        # entry points run on the card unless asked for the CPU
        x = tbv.zeros(bo, device=CPU)
        for fn in (lambda: tapi.laplace(bo),
                   lambda: tapi.constant_bounds(bo),
                   lambda: tapi.l2_functional(bo, lambda x: x[..., 0]),
                   lambda: tapi.local_norm(bo, x),
                   lambda: tapi.global_error(bo, x),
                   lambda: tapi.interpolate(bo, lambda x: x[..., 0])):
            with pytest.raises(RuntimeError, match="device"):
                fn()
