"""Port vs reference: the problem presets of ``models.py`` and the six
ported examples, in f64 on the CPU.

* ``PoissonProblem`` (with a tensor medium too), ``HeatProblem``,
  ``ElasticityProblem`` and ``ObstacleProblem``: matrices and right-hand
  sides at 1e-12, solutions at 1e-9 of max|x| with the same iteration
  counts, and the reference tests' own checks (L2 error, dissipation,
  residual, feasibility, the matrix-free operator);
* ``hpdg_tpu_torch.examples.{poisson,heat,elasticity,obstacle,
  anisotropic_line_mg,unstructured_cg}`` at the sizes of the reference's
  example tests: every printed line agrees with the reference script's,
  integers exactly and reported numbers to their printed digits
  (residuals at roundoff level only by being below 1e-8); the
  ``--sharded`` branches of ``elasticity`` and ``anisotropic_line_mg``
  run on a one-process shard group (held against the reference in
  ``test_torch_parallel_elasticity.py`` and
  ``test_torch_parallel_examples.py``).
"""

import os
import re
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu import models as rmodels
from hpdg_tpu.assemble import pullback_diffusion as r_pull
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks import api as rapi
from hpdg_tpu.linalg import blockmatrix as rbm

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch import models as tmodels
from hpdg_tpu_torch.assemble import pullback_diffusion as t_pull
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import api as tapi
from hpdg_tpu_torch.estimators import l2_error
from hpdg_tpu_torch.examples import (anisotropic_line_mg, elasticity, heat,
                                     obstacle, poisson, unstructured_cg)
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.linalg import blockvector as tbv

from test_torch_galerkin import assert_close

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def pair(cells, p, **kw):
    rm, tm = rmesh.structured(cells, **kw), tmesh.structured(cells, **kw)
    deg = np.full(rm.n_elements, p)
    return RBasis(rm, deg), TBasis(tm, deg)


def sol(x, lib):
    return lib.sin(lib.pi * x[..., 0]) * lib.sin(lib.pi * x[..., 1])


def test_poisson_problem_preset():
    rb, tb = pair((8, 8), 2)
    rp, tp = rmodels.PoissonProblem(rb), tmodels.PoissonProblem(tb,
                                                                device=CPU)
    assert_close(rp.A.values, tp.A.values, 1e-12)
    f = lambda x, lib: 2 * lib.pi**2 * sol(x, lib)  # noqa: E731
    rbv_, tbv_ = rp.rhs(lambda x: f(x, jnp)), tp.rhs(lambda x: f(x, torch))
    assert_close(rbv_, tbv_, 1e-12)
    rx, rinfo = rp.solve(rbv_, tol=1e-9)
    tx, tinfo = tp.solve(tbv_, tol=1e-9)
    assert tinfo["iterations"] == rinfo["iterations"]
    assert_close(rx, tx, 1e-9)
    assert float(l2_error(tb, tx, lambda x: sol(x, torch))) < 1e-3
    v = tbv.random(tb, device=CPU)
    d = tbv.sub(tp.operator()(v), tbm.matvec(tp.A, v))
    assert float(tbv.norm(d)) < 1e-10
    # Dirichlet data and the f32-chain route of api.solve_linear
    g = lambda x: x[..., 0] - 2 * x[..., 1]  # noqa: E731
    assert_close(rp.rhs(lambda x: 0 * x[..., 0], g),
                 tp.rhs(lambda x: 0 * x[..., 0], g), 1e-12)
    xo, info = tp.solve(tbv_, method="onchip", tol=1e-9)
    assert info["verified"] and info["rel_residual"] <= 1e-9
    assert_close(rx, xo, 1e-6)


def test_poisson_problem_tensor_diffusion():
    S = np.array([[1.0, 0.4], [0.0, 1.0]])
    rb, tb = pair((6, 6), 2)
    rp = rmodels.PoissonProblem(rb, penalty=4.0, diffusion=r_pull(S))
    tp = tmodels.PoissonProblem(tb, penalty=4.0, diffusion=t_pull(S),
                                device=CPU)
    assert_close(rp.A.values, tp.A.values, 1e-12)
    rx, rinfo = rp.solve(rp.rhs(lambda x: jnp.ones_like(x[..., 0])),
                         tol=1e-10, maxiter=80)
    b = tp.rhs(lambda x: torch.ones_like(x[..., 0]))
    tx, tinfo = tp.solve(b, tol=1e-10, maxiter=80)
    assert tinfo["iterations"] == rinfo["iterations"]
    assert_close(rx, tx, 1e-9)
    r = tbv.sub(b, tbm.matvec(tp.A, tx))
    assert float(tbv.norm(r)) / float(tbv.norm(b)) < 1e-8
    y1, y2 = tp.operator()(tx), tbm.matvec(tp.A, tx)
    assert max(float((y1[p] - y2[p]).abs().max()) for p in y1) < 1e-11


def test_heat_problem_preset():
    rb, tb = pair((6, 6), 2)
    rp = rmodels.HeatProblem(rb, dt=0.01)
    tp = tmodels.HeatProblem(tb, dt=0.01, device=CPU)
    assert_close(rp.S.values, tp.S.values, 1e-12)
    bump = lambda x, lib: lib.exp(  # noqa: E731
        -30 * ((x[..., 0] - 0.5) ** 2 + (x[..., 1] - 0.5) ** 2))
    ru = rapi.interpolate(rb, lambda x: bump(x, jnp))
    tu = tapi.interpolate(tb, lambda x: bump(x, torch), device=CPU)
    assert_close(ru, tu, 1e-14)
    e0 = float(tbv.dot(tu, tbm.matvec(tp.M, tu)))
    for _ in range(3):
        ru, rinfo = rp.advance(ru)
        tu, tinfo = tp.advance(tu)
        assert tinfo["iterations"] == rinfo["iterations"]
        assert_close(ru, tu, 1e-10)
        e = float(tbv.dot(tu, tbm.matvec(tp.M, tu)))
        assert e <= e0 + 1e-12
        e0 = e


@pytest.mark.parametrize("kw", ["meshes", "dgcg"])
def test_heat_problem_with_solver_options(kw):
    """``mg_kwargs`` (a port option, default None as in the reference)
    reach the preset's cycle: with h-levels or the DG->CG coarse solve,
    each step equals the reference's ``loop_solve`` over
    ``multigrid_solver(S, **mg_kwargs)``."""
    from hpdg_tpu.solvers.cg import loop_solve as r_loop
    from hpdg_tpu.solvers.multigrid import multigrid_solver as r_mg
    rms = rmesh.hierarchy(rmesh.structured((2, 2)), 2)
    tms = tmesh.hierarchy(tmesh.structured((2, 2)), 2)
    deg = np.full(rms[-1].n_elements, 2)
    rb, tb = RBasis(rms[-1], deg), TBasis(tms[-1], deg)
    rkw, tkw = ((dict(meshes=rms), dict(meshes=tms)) if kw == "meshes"
                else (dict(coarse="dgcg"), dict(coarse="dgcg")))
    rp = rmodels.HeatProblem(rb, dt=0.01)
    tp = tmodels.HeatProblem(tb, dt=0.01, mg_kwargs=tkw, device=CPU)
    rstep, _ = r_mg(rb, rp.S, **rkw)
    ru = rapi.interpolate(rb, lambda x: jnp.sin(3 * x[..., 0]) + x[..., 1])
    tu = tapi.interpolate(tb, lambda x: torch.sin(3 * x[..., 0]) + x[..., 1],
                          device=CPU)
    for _ in range(2):
        ru, rinfo = r_loop(rstep, ru, rbm.matvec(rp.M, ru),
                           matvec_fn=lambda v: rbm.matvec(rp.S, v),
                           tol=1e-10, maxiter=40)
        tu, tinfo = tp.advance(tu)
        assert tinfo["iterations"] == rinfo["iterations"]
        assert_close(ru, tu, 1e-10)


def test_elasticity_problem_preset():
    rb, tb = pair((4, 4), 2)
    rp = rmodels.ElasticityProblem(rb, penalty=6.0)
    tp = tmodels.ElasticityProblem(tb, penalty=6.0, device=CPU)
    assert_close(rp.A.values, tp.A.values, 1e-12)
    force = lambda x, lib: lib.stack([lib.ones_like(x[..., 0]),  # noqa: E731
                                      lib.zeros_like(x[..., 0])], -1)
    rbv_ = rp.rhs(lambda x: force(x, jnp))
    tbv_ = tp.rhs(lambda x: force(x, torch))
    assert_close(rbv_, tbv_, 1e-12)
    rx, rinfo = rp.solve(rbv_, tol=1e-8)
    tx, tinfo = tp.solve(tbv_, tol=1e-8)
    assert tinfo["iterations"] == rinfo["iterations"]
    assert_close(rx, tx, 1e-9)
    r = float(tbv.norm(tbv.sub(tbv_, tbm.matvec(tp.A, tx))))
    assert r < 1e-6 * max(1.0, float(tbv.norm(tbv_)))


def test_obstacle_problem_preset():
    rb, tb = pair((4, 4), 2, lower=(-1, -1), upper=(1, 1))
    rp, tp = rmodels.ObstacleProblem(rb), tmodels.ObstacleProblem(
        tb, device=CPU)
    assert_close(rp.A.values, tp.A.values, 1e-12)
    rbv_ = rapi.l2_functional(rb, lambda x: -8.0 + 0 * x[..., 0])
    tbv_ = tapi.l2_functional(tb, lambda x: -8.0 + 0 * x[..., 0],
                              device=CPU)
    rx, rinfo = rp.solve(rbv_, lower=-0.2, tol=1e-9, maxiter=60)
    tx, tinfo = tp.solve(tbv_, lower=-0.2, tol=1e-9, maxiter=60)
    assert tinfo["iterations"] == rinfo["iterations"]
    assert list(tinfo["truncated"]) == list(rinfo["truncated"])
    assert max(tinfo["truncated"]) > 0
    assert_close(rx, tx, 1e-9)
    for p in tx:
        assert bool((tx[p] >= -0.2 - 1e-9).all())


def test_presets_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid")
    _, tb = pair((2, 2), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.PoissonProblem(tb)


# ---------------------------------------------------------------- examples
NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def reference_lines(name, argv, capsys):
    old = sys.argv
    sys.argv = [name] + argv
    try:
        runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


def assert_same_report(want: list, got: list):
    """Line by line: the words equal, integers equal, printed floats to
    their printed digits (values below 1e-8 only both below it)."""
    assert len(got) == len(want), (want, got)
    for a, b in zip(want, got):
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        for x, y in zip(NUM.findall(a), NUM.findall(b)):
            fx, fy = float(x), float(y)
            if abs(fx) < 1e-8:
                assert abs(fy) < 1e-8, (a, b)
            elif re.fullmatch(r"[-+]?\d+", x):
                assert x == y, (a, b)
            else:
                digits = len(re.sub(r"[eE].*|[-+.]", "", x).lstrip("0"))
                assert abs(fx - fy) <= 1.01 * 10.0 ** (-digits + 1) * abs(fx) \
                    + 1e-300, (a, b)


EXAMPLE_CASES = [
    ("poisson.py", poisson, ["--n", "6", "--p", "2"]),
    ("heat.py", heat, ["--n", "6", "--steps", "2"]),
    ("elasticity.py", elasticity, ["--n", "2", "--levels", "1", "--p", "1"]),
    ("obstacle.py", obstacle, ["--n", "4"]),
    ("anisotropic_line_mg.py", anisotropic_line_mg, ["--cycles", "5"]),
    ("unstructured_cg.py", unstructured_cg, []),
]


@pytest.mark.parametrize("name,mod,argv", EXAMPLE_CASES,
                         ids=[c[0][:-3] for c in EXAMPLE_CASES])
def test_example_reports_match_reference(name, mod, argv, capsys):
    want = reference_lines(name, argv, capsys)
    mod.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert_same_report(want, got)


@pytest.mark.parametrize("mod", [elasticity, anisotropic_line_mg])
def test_sharded_example_branches_wait_for_item_21(mod):
    if mod is elasticity:
        # the sharded elasticity is ported: the branch runs (one shard
        # here; 8 against the reference in test_torch_parallel_elasticity)
        out = mod.main(["--sharded", "1", "--shards", "1", "--n", "2",
                        "--p", "1", "--device", "cpu"])
        assert out["sharded"]["ndev"] == 1
        assert out["sharded"]["rel"] < 1e-6
        return
    out = mod.main(["--sharded", "1", "--cells", "8,4,4", "--p", "1",
                    "--cycles", "2", "--shards", "2", "--device", "cpu"])
    assert set(out) == {"cheb", "line"}
    assert all(np.isfinite(h).all() and h[-1] < 1.0
               for _, h in out.values())
