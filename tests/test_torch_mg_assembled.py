"""Port vs reference: the assembled hp-multigrid, in f64.

* ``setup_hierarchy`` (p then h, and ``h_first``) and
  ``MultigridData.renew``: bases, coarse patterns bitwise, Galerkin
  matrices at 1e-12;
* one V-cycle of ``multigrid_solver`` per smoother (``gs``, ``jacobi``,
  ``lex``, ``patch``), scalar and vector-valued, with re-assembled coarse
  operators, with the penalty-damped hierarchy, with a dense and a GS
  coarse solve: 1e-11 of max|x|;
* ``gs_coarse_solver`` at 1e-12; one V-cycle through an h-level made by
  ``refine_local`` with mixed degrees at 1e-11;
* the matrix-free solver with the reference's defaults (the
  sum-factorized apply in f64, block-Jacobi Chebyshev of degree 3), on a
  ``refine_local`` mesh with mixed degrees, and with a GS coarse level:
  1e-11;
* ``loop_solve`` on a small 2D elasticity multigrid: the same iteration
  count and history;
* the lex-smoothed multigrid with re-assembled levels against a fresh
  residual history of the C++ baseline (``cpp/baseline_mg3d``) at 4^3
  p=2, cycle by cycle, with the bound of ``tests/test_parity_cpp.py``;
* the patch branch's fallbacks and the refused branches.
"""

import inspect
import json
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.assemble.elasticity import assemble_elasticity as r_elast
from hpdg_tpu.assemble.elasticity import l2_functional_vec as r_l2v
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.linalg import blockvector as rbv
from hpdg_tpu.solvers import cg as rcg
from hpdg_tpu.solvers import multigrid as rmg

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_elasticity as t_elast
from hpdg_tpu_torch.assemble import l2_functional as t_l2
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble import l2_functional_vec as t_l2v
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.solvers import cg as tcg
from hpdg_tpu_torch.solvers import multigrid as tmg
from hpdg_tpu_torch.solvers import patches as tpat

from test_torch_galerkin import (assert_close, assert_same_pattern, jx,
                                 rand_vec, to_port)

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
LAPLACE = dict(penalty=3.0, dirichlet=True, penalty_scaling="normal")
ELAST = dict(mu=1.0, lam=1.0, penalty=4.0, dirichlet=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def problem(kind, cells, degree, levels=1):
    """Reference and port: mesh chains, finest bases and matrices."""
    rms = rmesh.hierarchy(rmesh.structured(cells), levels)
    tms = tmesh.hierarchy(tmesh.structured(cells), levels)
    deg = degree(rms[-1].n_elements) if callable(degree) \
        else np.full(rms[-1].n_elements, degree)
    rb, tb = RBasis(rms[-1], deg), TBasis(tms[-1], deg)
    RA = r_laplace(rb, **LAPLACE) if kind == "laplace" else r_elast(rb, **ELAST)
    return rms, tms, rb, tb, RA, to_port(RA)


def factories(kind):
    if kind == "laplace":
        return (lambda b: r_laplace(b, **LAPLACE),
                lambda b: t_laplace(b, **LAPLACE, device=CPU))
    return (lambda b: r_elast(b, **ELAST),
            lambda b: t_elast(b, **ELAST, device=CPU))


def one_cycle(rstep, tstep, rb, ncomp, tol=1e-11):
    x, b = rand_vec(rb, 5, ncomp), rand_vec(rb, 6, ncomp)
    want = jax.jit(rstep)(jx(x), jx(b))
    got = tstep(convert.bucket_dict(x, device=CPU),
                convert.bucket_dict(b, device=CPU))
    assert_close(want, got, tol)


@pytest.mark.parametrize("kind,cells,degree,h_first", [
    ("laplace", (2, 3), lambda n: np.random.default_rng(2).integers(1, 4, n),
     False),
    ("laplace", (2, 2, 2), 2, True),
    ("elast", (2, 2, 2), 2, False),
    ("elast", (2, 2), 4, True)])
def test_setup_hierarchy_and_renew(kind, cells, degree, h_first):
    rms, tms, rb, tb, RA, TA = problem(kind, cells, degree)
    rd = rmg.setup_hierarchy(rb, RA, meshes=rms, h_first=h_first)
    td = tmg.setup_hierarchy(tb, TA, meshes=tms, h_first=h_first)
    assert [b.mesh.n_elements for b in td.bases] == \
        [b.mesh.n_elements for b in rd.bases]
    for rbas, tbas in zip(rd.bases, td.bases):
        np.testing.assert_array_equal(tbas.degrees, rbas.degrees)
    for RM, TM in zip(rd.matrices, td.matrices):
        assert TM.block_shape == RM.block_shape
        assert_same_pattern(RM.pattern, TM.pattern)
        assert_close(RM.values, TM.values, 1e-12)
    # renew after the fine matrix changed: same coarse pattern objects
    patterns = [M.pattern for M in td.matrices]
    rd.renew(rbm.add_scaled(RA, RA, 0.5))
    td.renew(tbm.add_scaled(TA, TA, 0.5))
    assert [M.pattern for M in td.matrices[:-1]] == patterns[:-1]
    for RM, TM in zip(rd.matrices, td.matrices):
        assert_close(RM.values, TM.values, 1e-12)


CYCLES = [  # kind, cells, degree, smoother, coarse, re-assembled
    ("laplace", (2, 2, 2), 2, "gs", "auto", False),
    ("laplace", (2, 2, 2), 2, "jacobi", "auto", False),
    ("laplace", (2, 2, 2), 2, "lex", "dense", True),
    ("laplace", (2, 2, 2), 2, "patch", "gs", False),
    ("laplace", (2, 3), lambda n: np.random.default_rng(4).integers(1, 4, n),
     "patch", "auto", False),
    ("laplace", (2, 3), lambda n: np.random.default_rng(4).integers(1, 4, n),
     "lex", "auto", False),
    ("elast", (2, 2), 2, "gs", "gs", False),
    ("elast", (2, 2), 2, "lex", "dense", True),
    ("elast", (2, 2, 2), 1, "patch", "auto", False),
    ("elast", (2, 2, 2), 2, "patch", "auto", True),
]


@pytest.mark.parametrize("kind,cells,degree,smoother,coarse,reassembled",
                         CYCLES)
def test_vcycle_matches_reference(kind, cells, degree, smoother, coarse,
                                  reassembled):
    rms, tms, rb, tb, RA, TA = problem(kind, cells, degree)
    rfac, tfac = factories(kind) if reassembled else (None, None)
    kw = dict(smoother=smoother, coarse=coarse, pre_steps=2, post_steps=2)
    rstep, rd = rmg.multigrid_solver(rb, RA, meshes=rms,
                                     operator_factory=rfac, **kw)
    tstep, td = tmg.multigrid_solver(tb, TA, meshes=tms,
                                     operator_factory=tfac, **kw)
    assert len(td.smoothers) == len(td.bases) - 1
    if smoother == "patch" and kind == "elast":
        assert all(s.startswith("class-patch") for s in td.smoothers)
    one_cycle(rstep, tstep, rb, RA.block_shape[0])


def test_penalty_damped_hierarchy():
    """A = A_cons + A_pen with the penalty part damped per level; the
    penalty part is the difference of two assemblies (the penalty term
    is linear in the penalty factor)."""
    rms, tms, rb, tb, RA, TA = problem("laplace", (2, 2, 2), 2)
    kw1 = dict(LAPLACE, penalty=2.0)
    RP = rbm.add_scaled(RA, r_laplace(rb, **kw1), -1.0)
    TP = tbm.add_scaled(TA, t_laplace(tb, **kw1, device=CPU), -1.0)
    kw = dict(meshes=None, smoother="gs", penalty_damping=0.5)
    rstep, _ = rmg.multigrid_solver(rb, RA, penalty_matrix=RP, **kw)
    tstep, _ = tmg.multigrid_solver(tb, TA, penalty_matrix=TP, **kw)
    one_cycle(rstep, tstep, rb, 1)


@pytest.mark.parametrize("kind", ["laplace", "elast"])
def test_gs_coarse_solver(kind):
    _, _, rb, tb, RA, TA = problem(kind, (2, 3), 1, levels=0)
    b = rand_vec(rb, 8, RA.block_shape[0])
    want = jax.jit(rmg.gs_coarse_solver(rb, RA, iterations=7))(jx(b))
    got = tmg.gs_coarse_solver(tb, TA, iterations=7)(
        convert.bucket_dict(b, device=CPU))
    assert_close(want, got, 1e-12)


def test_loop_solve_on_elasticity_multigrid():
    rms, tms, rb, tb, RA, TA = problem("elast", (2, 2), 2)

    def force(x, lib):
        s = lib.sin(np.pi * x[..., 0]) * lib.sin(np.pi * x[..., 1])
        return lib.stack([2 * np.pi ** 2 * s, 0 * s], -1)

    rbb = r_l2v(rb, lambda x: force(x, jnp))
    tbb = t_l2v(tb, lambda x: force(x, torch), device=CPU)
    rstep, _ = rmg.multigrid_solver(rb, RA, meshes=rms)
    tstep, _ = tmg.multigrid_solver(tb, TA, meshes=tms)
    rx, rinfo = rcg.loop_solve(rstep, rbv.zeros(rb, ncomp=2), rbb,
                               matvec_fn=lambda v: rbm.matvec(RA, v),
                               tol=1e-10, maxiter=60)
    tx, tinfo = tcg.loop_solve(tstep, tbv.zeros(tb, device=CPU, ncomp=2), tbb,
                               matvec_fn=lambda v: tbm.matvec(TA, v),
                               tol=1e-10, maxiter=60)
    assert 3 <= tinfo["iterations"] < 60
    assert tinfo["iterations"] == rinfo["iterations"]
    np.testing.assert_allclose(tinfo["history"], rinfo["history"], rtol=1e-8,
                               atol=1e-13 * rinfo["history"][0])
    assert_close(rx, tx, 1e-10)


def test_matrixfree_defaults_match_reference():
    """The same call computes the same cycle: the sum-factorized apply in
    f64 on every level (the kernel only when asked for), block-Jacobi
    Chebyshev of degree 3 unless the caller asks for patches."""
    from hpdg_tpu_torch.matrixfree import sumfact

    rsig = inspect.signature(rmg.matrixfree_multigrid_solver).parameters
    tsig = inspect.signature(tmg.matrixfree_multigrid_solver).parameters
    for name in ("penalty", "dirichlet", "cheby_degree", "penalty_scaling",
                 "smoother"):
        assert tsig[name].default == rsig[name].default, name
    assert tsig["use_kernel"].default is rsig["use_pallas"].default is False
    assert np.dtype(rsig["dtype"].default) == np.float64
    assert tsig["dtype"].default is torch.float64
    rms, tms, rb, tb, _, _ = problem("laplace", (2, 3), 2)
    kw = dict(penalty=2.0, penalty_scaling="normal")
    rstep, _ = rmg.matrixfree_multigrid_solver(rb, meshes=rms, **kw)
    tstep, info = tmg.matrixfree_multigrid_solver(tb, meshes=tms, **kw,
                                                  device=CPU)
    assert info["smoothers"] == [None, None]  # Chebyshev on both levels
    assert all(op.__qualname__.startswith(sumfact.sipg_operator.__name__)
               for op in info["operators"])
    one_cycle(rstep, tstep, rb, 1)


@pytest.mark.parametrize("dim", [2, 3])
def test_assembled_cycle_through_refine_local_h_level(dim):
    """``multigrid_solver(meshes=[structured, refine_local(...)])`` with
    mixed degrees: the h-transfer takes kept elements (``child_pos ==
    -1``) and sibling groups alike, and one V-cycle matches the
    reference's at 1e-11 (the adaptive loop's hierarchy)."""
    from hpdg_tpu.mesh.adaptive import refine_local as r_refine
    from hpdg_tpu_torch.mesh.adaptive import refine_local as t_refine

    cells = (4, 3) if dim == 2 else (2, 3, 2)
    r0, t0 = rmesh.structured(cells), tmesh.structured(cells)
    marks = np.random.default_rng(21).random(r0.n_elements) < 0.4
    rm, tm = r_refine(r0, marks), t_refine(t0, marks)
    assert (tm.child_pos == -1).any() and (tm.child_pos >= 0).any()
    deg = np.random.default_rng(22).integers(1, 5, rm.n_elements)
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    RA = r_laplace(rb, **LAPLACE)
    rstep, rdata = rmg.multigrid_solver(rb, RA, meshes=[r0, rm])
    tstep, tdata = tmg.multigrid_solver(tb, to_port(RA), meshes=[t0, tm])
    assert [b.mesh.n_elements for b in tdata.bases] == \
        [b.mesh.n_elements for b in rdata.bases]
    one_cycle(rstep, tstep, rb, 1)


@pytest.mark.parametrize("dim,smoother", [(2, "cheb"), (2, "patch"),
                                          (3, "cheb")])
def test_matrixfree_cycle_on_refine_local_mixed_degrees(dim, smoother):
    """The default route on a ``refine_local`` mesh with mixed degrees
    (1-3 in 2D, 1-2 in 3D; hanging faces; kept elements with ``child_pos == -1`` in the h-level)
    against the reference's default route: one V-cycle at 1e-11.  The
    patch smoother cannot take such levels; both packages smooth them by
    Chebyshev (mixed degrees) or fall back to it (hanging faces)."""
    from hpdg_tpu.mesh.adaptive import refine_local as r_refine
    from hpdg_tpu_torch.mesh.adaptive import refine_local as t_refine

    cells, pmax = ((3, 4), 3) if dim == 2 else ((2, 2, 2), 2)
    r0, t0 = rmesh.structured(cells), tmesh.structured(cells)
    marks = np.random.default_rng(11).random(r0.n_elements) < 0.35
    rm, tm = r_refine(r0, marks), t_refine(t0, marks)
    assert (tm.child_pos == -1).any() and (tm.faces.nc_code > 0).any()
    deg = np.random.default_rng(12).integers(1, pmax + 1, rm.n_elements)
    if smoother == "patch":
        deg[:] = 2  # one degree: the patch branch reaches its fallback
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    kw = dict(penalty=3.0, penalty_scaling="normal", smoother=smoother)
    rstep, _ = rmg.matrixfree_multigrid_solver(rb, meshes=[r0, rm], **kw)
    tstep, info = tmg.matrixfree_multigrid_solver(tb, meshes=[t0, tm], **kw,
                                                  device=CPU)
    assert [b.mesh.n_elements for b in info["bases"]][:2] == \
        [t0.n_elements, tm.n_elements]
    assert all(s is None for s in info["smoothers"])
    one_cycle(rstep, tstep, rb, 1)


def test_matrixfree_gs_coarse_level():
    """A coarse level above the dense limit takes 40 colored GS steps."""
    cells = (40, 40)
    rb = RBasis(rmesh.structured(cells), np.full(1600, 2))
    tb = TBasis(tmesh.structured(cells), np.full(1600, 2))
    kw = dict(penalty=2.0, penalty_scaling="normal", smoother="patch")
    rstep, _ = rmg.matrixfree_multigrid_solver(rb, dtype=jnp.float64, **kw)
    tstep, info = tmg.matrixfree_multigrid_solver(
        tb, dtype=torch.float64, **kw, device=CPU)
    assert info["bases"][0].ndof > tmg.DENSE_COARSE_MAX
    one_cycle(rstep, tstep, rb, 1)


def test_patch_branch_falls_back_within_the_memory_budget(monkeypatch):
    """When the class check fails, per-patch inverses are taken only
    within ``PATCH_MEMORY_BUDGET``; above it the level smooths by
    colored block GS."""
    _, tms, _, tb, _, TA = problem("elast", (2, 2), 1)

    def refuse(*args, **kwargs):
        raise ValueError("not translation-invariant")

    monkeypatch.setattr(tpat, "ClassPatchSmoother", refuse)
    _, td = tmg.multigrid_solver(tb, TA, meshes=tms, smoother="patch")
    assert td.smoothers == ["patch"]
    monkeypatch.setattr(tpat, "PATCH_MEMORY_BUDGET", 0)
    _, td = tmg.multigrid_solver(tb, TA, meshes=tms, smoother="patch")
    assert td.smoothers == ["gs"]


def test_refused_branches():
    _, tms, _, tb, _, TA = problem("laplace", (2, 2), 1)
    with pytest.raises(NotImplementedError, match="item 20"):
        tmg.multigrid_solver(tb, TA, meshes=tms, smoother="line")
    with pytest.raises(NotImplementedError, match="item 20"):
        tmg.multigrid_solver(tb, TA, meshes=tms, coarse="dgcg")
    with pytest.raises(ValueError):
        tmg.multigrid_solver(tb, TA, meshes=tms, smoother="sor")


def test_lex_multigrid_matches_cpp_baseline_history():
    """The algorithm of the card's phase-9 check at a small size: the
    C++ hp-MG (lexicographic block GS 3+3, re-assembled levels, dense
    coarse Cholesky) and the port's ``multigrid_solver`` from zero."""
    exe = Path(__file__).resolve().parent.parent / "cpp" / "baseline_mg3d"
    out = subprocess.run([str(exe), "4", "2", "1e-8"], capture_output=True,
                         text=True, check=True, timeout=120)
    cpp = json.loads(out.stdout)["history"]
    meshes = tmesh.hierarchy(tmesh.structured((2, 2, 2)), 1)
    tb = TBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
    A = t_laplace(tb, **kw, device=CPU)
    b = t_l2(tb, lambda x: 2 * np.pi ** 2 * torch.sin(np.pi * x[..., 0])
             * torch.sin(np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]),
             device=CPU)
    step, data = tmg.multigrid_solver(
        tb, A, operator_factory=lambda bas: t_laplace(bas, **kw, device=CPU),
        meshes=meshes, smoother="lex", coarse="dense")
    assert data.smoothers == ["lex", "lex"] and data.coarse == "dense"
    nb = float(tbv.norm(b))
    x, hist = tbv.zeros_like(b), [1.0]
    for _ in range(len(cpp) - 1):
        x = step(x, b)
        hist.append(float(tbv.norm(tbv.sub(b, tbm.matvec(A, x)))) / nb)
    assert len(cpp) >= 6
    for k, (a, c) in enumerate(zip(hist, cpp)):
        assert abs(a - c) <= 1e-10 * abs(c) + 5e-14, (k, a, c)
