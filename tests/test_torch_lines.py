"""Port vs reference: the line smoother and the ``line``/``dgcg``
branches of the assembled multigrid, in f64 (and f32 where stated).

* ``build_lines``: the line tables BITWISE, along every axis of 2D and
  3D boxes and on a hanging-node mesh;
* ``line_tridiag_factor``: the line tables and per-bucket maps bitwise,
  ``Sinv``/``W``/``U`` at 1e-12, for scalar mixed-degree problems (the
  hp padding) and elasticity blocks (``ncomp``);
* ``line_solve`` at 1e-12 (f64) and 1e-6 (f32), and exact on a
  single-line mesh; ``line_jacobi_step`` at 1e-12;
* one cycle of ``multigrid_solver(smoother="line")`` and of
  ``coarse="dgcg"`` at 1e-11: 2D, 3D, one and two stretched axes,
  elasticity blocks, a hanging-node mesh;
* the line smoother's contraction beats GS on 4:1 cells; the
  penalty-damped hierarchy (``assemble_penalty_only``) as the reference
  tests it.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.assemble.elasticity import assemble_elasticity as r_elast
from hpdg_tpu.assemble.sipg import assemble_penalty_only as r_pen
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.solvers import lines as rl
from hpdg_tpu.solvers import multigrid as rmg

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble import l2_functional as t_l2
from hpdg_tpu_torch.assemble.sipg import assemble_penalty_only as t_pen
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.solvers import cg as tcg
from hpdg_tpu_torch.solvers import lines as tl
from hpdg_tpu_torch.solvers import multigrid as tmg

from test_torch_galerkin import assert_close, jx, rand_vec, to_port

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
LAPLACE = dict(penalty=6.0, dirichlet=True, penalty_scaling="normal")
ELAST = dict(mu=1.0, lam=1.5, penalty=8.0, dirichlet=True,
             penalty_scaling="normal")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def tt(x):
    return convert.bucket_dict(x, device=CPU)


@functools.lru_cache(maxsize=None)
def mesh_pair(case):
    if case == "hang2":
        marks = np.array([True, False, False, True, False, False])
        return (radapt.refine_local(rmesh.structured((3, 2)), marks),
                tadapt.refine_local(tmesh.structured((3, 2)), marks))
    cells, upper = {"s2": ((6, 2), None), "s3": ((8, 2, 2), None),
                    "t3": ((4, 4, 2), None), "e2": ((8, 4), (1.0, 0.0625)),
                    "one": ((6, 1), None)}[case]
    return (rmesh.structured(cells, upper=upper),
            tmesh.structured(cells, upper=upper))


@functools.lru_cache(maxsize=None)
def problem(case, kind, degree):
    """Reference and port: bases and matrices (degree: an int, or
    "mixed" for seeded degrees in 1..3)."""
    rm, tm = mesh_pair(case)
    deg = (np.random.default_rng(3).choice([1, 2, 3], rm.n_elements)
           if degree == "mixed" else np.full(rm.n_elements, degree))
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    RA = (r_laplace(rb, **LAPLACE) if kind == "laplace"
          else r_elast(rb, **ELAST))
    return rb, tb, RA, to_port(RA)


@pytest.mark.parametrize("case,axis", [("s2", 0), ("s2", 1), ("s3", 0),
                                       ("s3", 1), ("s3", 2), ("hang2", 0),
                                       ("hang2", 1)])
def test_build_lines_bitwise(case, axis):
    rm, tm = mesh_pair(case)
    want, got = rl.build_lines(rm, axis), tl.build_lines(tm, axis)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


FACTORS = [("s2", "laplace", "mixed", 0), ("s3", "laplace", 2, 0),
           ("hang2", "laplace", 2, 1), ("e2", "elast", 2, 1),
           ("one", "laplace", 2, 0)]


@functools.lru_cache(maxsize=None)
def factors(case, kind, degree, axis):
    rb, tb, RA, TA = problem(case, kind, degree)
    return (rl.line_tridiag_factor(RA, rb, axis=axis),
            tl.line_tridiag_factor(TA, tb, axis=axis))


@pytest.mark.parametrize("case,kind,degree,axis", FACTORS)
def test_line_tridiag_factor(case, kind, degree, axis):
    rf, tf = factors(case, kind, degree, axis)
    assert tf["B"] == rf["B"] and tf["dims"] == rf["dims"]
    np.testing.assert_array_equal(tf["lines"], rf["lines"])
    assert tf["maps"].keys() == rf["maps"].keys()
    for p in rf["maps"]:
        for a, b in zip(rf["maps"][p], tf["maps"][p]):
            np.testing.assert_array_equal(b, a)
    for name in ("Sinv", "W", "U"):
        scale = np.abs(rf[name]).max()
        assert np.abs(tf[name] - rf[name]).max() <= 1e-12 * scale, name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case,kind,degree,axis", FACTORS)
def test_line_solve(case, kind, degree, axis, dtype):
    rb, tb, RA, TA = problem(case, kind, degree)
    rf, tf = factors(case, kind, degree, axis)
    r = rand_vec(rb, 11, RA.block_shape[0])
    want = rl.line_solve(rf)(jx(r))
    got = tl.line_solve(tf, dtype=dtype, device=CPU)(
        convert.bucket_dict(r, dtype=dtype, device=CPU))
    for p in got:
        assert got[p].dtype == dtype
    assert_close(want, got, 1e-12 if dtype == torch.float64 else 1e-6)
    if case == "one":  # one line: the line part IS the operator
        x = tl.line_solve(tf, device=CPU)(tt(r))
        assert_close(r, tbm.matvec(TA, x), 1e-10)


@pytest.mark.parametrize("case,kind,degree,axis", FACTORS[1:2] + FACTORS[3:])
def test_line_jacobi_step(case, kind, degree, axis):
    rb, tb, RA, TA = problem(case, kind, degree)
    ncomp = RA.block_shape[0]
    x, b = rand_vec(rb, 1, ncomp), rand_vec(rb, 2, ncomp)
    want = rl.line_jacobi_step(RA, rb, axis=axis, omega=0.8)(jx(x), jx(b))
    got = tl.line_jacobi_step(TA, tb, axis=axis, omega=0.8)(tt(x), tt(b))
    assert_close(want, got, 1e-12)


def one_cycle(rstep, tstep, rb, ncomp, tol=1e-11):
    x, b = rand_vec(rb, 5, ncomp), rand_vec(rb, 6, ncomp)
    want = jax.jit(rstep)(jx(x), jx(b))
    got = tstep(tt(x), tt(b))
    assert_close(want, got, tol)


@pytest.mark.parametrize("case,kind,degree,kw", [
    ("s3", "laplace", 2, dict(jacobi_damping=1.0)),        # one short axis
    ("t3", "laplace", 2, dict(jacobi_damping=1.0)),        # two: ADI
    ("s2", "laplace", "mixed", dict(jacobi_damping=0.8)),  # hp padding
    ("e2", "elast", 2, dict(jacobi_damping=1.0)),          # ncomp = 2
    ("hang2", "laplace", 2, dict(jacobi_damping=1.0,
                                 coarse="dense"))])
def test_line_smoothed_cycle(case, kind, degree, kw):
    rb, tb, RA, TA = problem(case, kind, degree)
    rstep, _ = rmg.multigrid_solver(rb, RA, smoother="line", **kw)
    tstep, td = tmg.multigrid_solver(tb, TA, smoother="line", **kw)
    assert all(s.startswith("line") for s in td.smoothers)
    one_cycle(rstep, tstep, rb, RA.block_shape[0])


def test_line_smoother_axes():
    """The short (strong-coupling) axes: one on 4:1 cells, two (ADI, in
    forward then reversed order) when two extents are short."""
    for case, axes in (("s3", [0]), ("t3", [0, 1]), ("e2", [1])):
        _, tb, _, TA = problem(case, "laplace" if case != "e2" else "elast",
                               2)
        _, td = tmg.multigrid_solver(tb, TA, smoother="line")
        assert td.smoothers[-1] == f"line axes={axes}"


@pytest.mark.parametrize("case,degree,levels", [
    ("s2", 2, 0), ("s3", 2, 0), ("hang2", 2, 0), ("s2", 1, 1)])
def test_dgcg_coarse_cycle(case, degree, levels):
    rm, tm = mesh_pair(case)
    rms = rmesh.hierarchy(rm, levels) if levels else None
    tms = tmesh.hierarchy(tm, levels) if levels else None
    m_r, m_t = (rms[-1], tms[-1]) if levels else (rm, tm)
    deg = np.full(m_r.n_elements, degree)
    rb, tb = RBasis(m_r, deg), TBasis(m_t, deg)
    RA = r_laplace(rb, **LAPLACE)
    rstep, _ = rmg.multigrid_solver(rb, RA, meshes=rms, coarse="dgcg")
    tstep, td = tmg.multigrid_solver(tb, to_port(RA), meshes=tms,
                                     coarse="dgcg")
    assert td.coarse == "dgcg"
    one_cycle(rstep, tstep, rb, 1)


def test_line_beats_gs_on_stretched_cells():
    """The reference's claim: on 4:1 cells the line-smoothed V-cycle
    contracts far better than colored block GS."""
    _, tb, _, TA = problem("s3", "laplace", 2)
    b = t_l2(tb, lambda x: torch.sin(torch.pi * x[..., 0])
             * torch.sin(torch.pi * x[..., 1]), device=CPU)
    nb = float(tbv.norm(b))

    def rate(**kw):
        step, _ = tmg.multigrid_solver(tb, TA, **kw)
        x, res = tbv.zeros_like(b), []
        for _ in range(8):
            x = step(x, b)
            res.append(float(tbv.norm(tbv.sub(b, tbm.matvec(TA, x)))) / nb)
        return (res[-1] / res[0]) ** (1 / 7)

    r_line, r_gs = rate(smoother="line", jacobi_damping=1.0), rate()
    assert r_line < 0.35 and r_line < r_gs - 0.2, (r_line, r_gs)


@pytest.mark.parametrize("cells,levels", [((2, 2), 1), ((2, 1, 1), 1)])
def test_penalty_damped_multigrid(cells, levels):
    """``multigrid_solver(penalty_matrix=assemble_penalty_only(...),
    penalty_damping=0.5)``: one cycle against the reference at 1e-11;
    in 2D the damped hierarchy needs no more cycles than plain Galerkin
    (the reference's test of the dual hierarchy)."""
    rms = rmesh.hierarchy(rmesh.structured(cells), levels)
    tms = tmesh.hierarchy(tmesh.structured(cells), levels)
    deg = np.full(rms[-1].n_elements, 2)
    rb, tb = RBasis(rms[-1], deg), TBasis(tms[-1], deg)
    RA = r_laplace(rb, penalty=2.0, dirichlet=True)
    TA = t_laplace(tb, penalty=2.0, dirichlet=True, device=CPU)
    RP = r_pen(rb, penalty=2.0, dirichlet=True)
    TP = t_pen(tb, penalty=2.0, dirichlet=True, device=CPU)
    kw = dict(penalty_damping=0.5)
    rstep, _ = rmg.multigrid_solver(rb, RA, meshes=rms, penalty_matrix=RP,
                                    **kw)
    tstep, _ = tmg.multigrid_solver(tb, TA, meshes=tms, penalty_matrix=TP,
                                    **kw)
    one_cycle(rstep, tstep, rb, 1)
    if len(cells) == 3:
        return
    b = t_l2(tb, lambda x: 2 * torch.pi**2 * torch.sin(torch.pi * x[..., 0])
             * torch.sin(torch.pi * x[..., 1]), device=CPU)
    counts = {}
    for name, extra in (("galerkin", {}),
                        ("damped", dict(penalty_matrix=TP, **kw))):
        step, _ = tmg.multigrid_solver(tb, TA, meshes=tms, **extra)
        x, info = tcg.loop_solve(step, tbv.zeros_like(b), b,
                                 matvec_fn=lambda v: tbm.matvec(TA, v),
                                 tol=1e-9, maxiter=60)
        assert float(tbv.norm(tbv.sub(b, tbm.matvec(TA, x)))) < 1e-6
        counts[name] = info["iterations"]
    assert counts["damped"] <= counts["galerkin"], counts
