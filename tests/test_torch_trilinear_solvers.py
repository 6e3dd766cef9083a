"""Port vs reference: the solver stack on TRILINEAR meshes, in f64.

* one assembled and one matrix-free V-cycle on a curved
  ``[base, refine, refine]`` hierarchy at 1e-11;
* the obstacle solve and an h-adaptive round on a curved mesh, state
  carried by ``interpolate_to`` / ``restrict_to_coarse`` (which work in
  the parametric boxes);
* ``save_npz`` refuses geometry (the reference drops it silently);
* the SIPG matrix of the quarter cylinder stays positive definite and
  the volume identities hold;
* the curved-geometry example converges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.assemble import dirichlet_rhs as r_dirichlet
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks import api as rapi
from hpdg_tpu.blocks import persist as rper
from hpdg_tpu.estimators import error as rerr
from hpdg_tpu.estimators.utility import mark_fraction as r_mark
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.solvers import multigrid as rmg

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import api as tapi
from hpdg_tpu_torch.blocks import persist as tper
from hpdg_tpu_torch.estimators import error as terr
from hpdg_tpu_torch.estimators.utility import mark_fraction as t_mark
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.mesh import geometry as tgeo
from hpdg_tpu_torch.solvers import multigrid as tmg

from test_torch_galerkin import assert_close, jx, rand_vec
from test_torch_geometry import SHEAR2, assert_same_mesh
from test_torch_trilinear import annulus, cylinder, dense, tri_pair, tt

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def curved_hierarchy(case, cells):
    """[base, refine, refine] chains of both packages."""
    rm, tm = tri_pair(case, cells)
    rms = [rm, rmesh.refine(rm)]
    tms = [tm, tmesh.refine(tm)]
    rms.append(rmesh.refine(rms[-1]))
    tms.append(tmesh.refine(tms[-1]))
    assert_same_mesh(rms[-1], tms[-1])
    return rms, tms


def one_cycle(rstep, tstep, rb, tol=1e-11):
    x, b = rand_vec(rb, 5), rand_vec(rb, 6)
    want = jax.jit(rstep)(jx(x), jx(b))
    assert_close(want, tstep(tt(x), tt(b)), tol)


def test_assembled_vcycle_on_a_curved_hierarchy():
    rms, tms = curved_hierarchy("wavy2", (2, 2))
    n = rms[-1].n_elements
    rb, tb = RBasis(rms[-1], np.full(n, 2)), TBasis(tms[-1], np.full(n, 2))
    kw = dict(penalty=4.0, dirichlet=True)
    RA = r_laplace(rb, **kw)
    TA = t_laplace(tb, device=CPU, **kw)
    assert_close(RA.values, TA.values, 1e-12)
    rstep, rdata = rmg.multigrid_solver(rb, RA, meshes=rms)
    tstep, tdata = tmg.multigrid_solver(tb, TA, meshes=tms)
    assert [b.mesh.n_elements for b in tdata.bases] == \
        [b.mesh.n_elements for b in rdata.bases]
    one_cycle(rstep, tstep, rb)


def test_matrixfree_vcycle_on_a_curved_hierarchy():
    rms, tms = curved_hierarchy("annulus", (2, 2))
    n = rms[-1].n_elements
    rb, tb = RBasis(rms[-1], np.full(n, 2)), TBasis(tms[-1], np.full(n, 2))
    kw = dict(penalty=4.0, penalty_scaling="normal")
    rstep, _ = rmg.matrixfree_multigrid_solver(rb, meshes=rms, **kw)
    tstep, info = tmg.matrixfree_multigrid_solver(tb, meshes=tms, device=CPU,
                                                  **kw)
    assert len(info["operators"]) == 3  # p=1 on the fine mesh, then 2 h-levels
    one_cycle(rstep, tstep, rb)


def test_obstacle_solve_on_a_curved_mesh_matches_reference():
    rm, tm = tri_pair("wavy2", (4, 4))
    rb, tb = RBasis(rm, np.full(16, 2)), TBasis(tm, np.full(16, 2))
    RA = rapi.laplace(rb, penalty=4.0, dirichlet=True)
    TA = tapi.laplace(tb, penalty=4.0, dirichlet=True, device=CPU)
    assert_close(RA.values, TA.values, 1e-12)
    rbv_ = rapi.l2_functional(rb, lambda x: 8.0 * jnp.ones_like(x[..., 0]))
    tbv_ = tapi.l2_functional(tb, lambda x: 8.0 * torch.ones_like(x[..., 0]),
                              device=CPU)
    assert_close(rbv_, tbv_, 1e-13)
    rlo, rup = rapi.constant_bounds(rb, lower=-0.05, upper=0.05)
    tlo, tup = tapi.constant_bounds(tb, lower=-0.05, upper=0.05, device=CPU)
    xr, ir = rapi.solve_obstacle(rb, RA, rbv_, rlo, rup, tol=1e-10,
                                 maxiter=80)
    xt, it = tapi.solve_obstacle(tb, TA, tbv_, tlo, tup, tol=1e-10,
                                 maxiter=80)
    assert it["iterations"] == int(ir["iterations"])
    assert max(it["truncated"]) > 0  # the contact zone is active
    np.testing.assert_allclose(it["energy"], np.asarray(ir["energy"]),
                               rtol=1e-9)
    assert_close(xr, xt, 1e-8)
    for p in xt:
        assert (xt[p] <= tup[p] + 1e-9).all() and (xt[p] >= tlo[p] - 1e-9).all()


def test_h_adaptive_round_on_a_curved_mesh_matches_reference():
    """solve -> estimate -> mark -> refine_local -> carry the state ->
    solve again, on a trilinear mesh in both packages: same marks, same
    meshes, same carried state, same errors, and the L2 error drops."""
    u_r = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(  # noqa: E731
        jnp.pi * x[..., 1])
    u_t = lambda x: torch.sin(torch.pi * x[..., 0]) * torch.sin(  # noqa: E731
        torch.pi * x[..., 1])
    rm, tm = tri_pair("wavy2", (4, 4))
    rb, tb = RBasis(rm, np.full(16, 2)), TBasis(tm, np.full(16, 2))

    def r_solve(basis):
        A = rapi.laplace(basis, penalty=4.0, dirichlet=True)
        b = rapi.l2_functional(basis, lambda x: 2 * jnp.pi**2 * u_r(x))
        bd = r_dirichlet(basis, u_r, penalty=4.0)
        b = {p: b[p] + bd[p] for p in b}
        return rapi.solve_linear(basis, A, b, tol=1e-10, maxiter=400)[0]

    def t_solve(basis):
        A = tapi.laplace(basis, penalty=4.0, dirichlet=True, device=CPU)
        b = tapi.l2_functional(basis, lambda x: 2 * torch.pi**2 * u_t(x),
                               device=CPU)
        bd = tapi.dirichlet_data(basis, u_t, penalty=4.0, device=CPU)
        b = {p: b[p] + bd[p] for p in b}
        return tapi.solve_linear(basis, A, b, tol=1e-10, maxiter=400)[0]

    xr, xt = r_solve(rb), t_solve(tb)
    assert_close(xr, xt, 1e-8)
    e1r, e1t = float(rerr.l2_error(rb, xr, u_r)), float(terr.l2_error(tb, xt,
                                                                      u_t))
    np.testing.assert_allclose(e1t, e1r, rtol=1e-6)
    ur_i, ut_i = rapi.interpolate(rb, u_r), tapi.interpolate(tb, u_t,
                                                             device=CPU)
    eta_r = np.asarray(rapi.local_norm(
        rb, {p: xr[p] - ur_i[p] for p in xr}, penalty=4.0))
    eta_t = tapi.local_norm(tb, {p: xt[p] - ut_i[p] for p in xt},
                            penalty=4.0, device=CPU).numpy()
    np.testing.assert_allclose(eta_t, eta_r, rtol=0, atol=1e-7 * eta_r.max())
    marks = r_mark(eta_r, 0.7)
    np.testing.assert_array_equal(t_mark(eta_t, 0.7), marks)
    assert marks.any() and not marks.all()
    r2 = radapt.refine_local(rm, radapt.close_marks(rm, marks))
    t2 = tadapt.refine_local(tm, tadapt.close_marks(tm, marks))
    assert_same_mesh(r2, t2)
    rb2 = RBasis(r2, np.full(r2.n_elements, 2))
    tb2 = TBasis(t2, np.full(t2.n_elements, 2))
    # the state is carried in the parametric boxes: geometry-agnostic
    x = rand_vec(rb, 3)
    rs = rper.save_state(rb, jx(x))
    ts = tper.save_state(tb, tt(x))
    x0r = rper.interpolate_to(rs, rb2)
    x0t = tper.interpolate_to(ts, tb2, device=CPU)
    assert_close(x0r, x0t, 1e-13)
    back_r = rper.restrict_to_coarse(rper.save_state(rb2, x0r), rb)
    back_t = tper.restrict_to_coarse(tper.save_state(tb2, x0t), tb,
                                     device=CPU)
    assert_close(back_r, back_t, 1e-13)
    assert_close(x, back_t, 1e-12)  # refine then restrict is the identity
    x2r, x2t = r_solve(rb2), t_solve(tb2)
    e2r, e2t = float(rerr.l2_error(rb2, x2r, u_r)), float(terr.l2_error(
        tb2, x2t, u_t))
    np.testing.assert_allclose(e2t, e2r, rtol=1e-6)
    assert e2t < 0.7 * e1t, (e1t, e2t)


def test_save_npz_refuses_geometry_where_the_reference_drops_it(tmp_path):
    """The checkpoint layout has no geometry fields: the reference
    writes a curved mesh and reads back a box mesh; the port refuses."""
    rm, tm = tri_pair("wavy2")
    rb, tb = RBasis(rm, np.full(6, 2)), TBasis(tm, np.full(6, 2))
    x = rand_vec(rb, 1)
    path = str(tmp_path / "state.npz")
    rper.save_npz(path, rper.save_state(rb, jx(x)))
    back = rper.load_npz(path).basis.mesh
    assert rm.corners is not None and back.corners is None  # dropped
    assert abs(back.volumes.sum() - rm.volumes.sum()) > 1e-3
    with pytest.raises(ValueError, match="geometry"):
        tper.save_npz(str(tmp_path / "port.npz"), tper.save_state(tb, tt(x)))
    ab = TBasis(tgeo.affine_image(tmesh.structured((2, 2)), SHEAR2),
                np.full(4, 1))
    with pytest.raises(ValueError, match="geometry"):
        tper.save_npz(str(tmp_path / "port.npz"), tper.save_state(
            ab, tt(rand_vec(ab, 1))))


def test_quarter_cylinder_matrix_is_positive_definite():
    """penalty=4, "normal" scaling (face-centre factors), p=3 on the
    2x2x2 quarter hollow cylinder: the smallest eigenvalue is positive,
    and the volume identities hold."""
    _, tm = tri_pair("cylinder")
    tb = TBasis(tm, np.full(8, 3))
    A = tapi.laplace(tb, penalty=4.0, dirichlet=True, device=CPU,
                     penalty_scaling="normal")
    Ad = dense(A, tb)
    assert np.abs(Ad - Ad.T).max() < 1e-12 * np.abs(Ad).max()
    assert np.linalg.eigvalsh(0.5 * (Ad + Ad.T)).min() > 0
    one = {3: torch.ones((8, 64), dtype=torch.float64)}
    M = tapi.mass(tb, device=CPU)
    vol = tm.volumes.sum()
    m1 = sum(float((one[p] * v).sum()) for p, v in tbm.matvec(M, one).items())
    l1 = sum(float(v.sum()) for v in tapi.l2_functional(
        tb, lambda x: torch.ones_like(x[..., 0]), device=CPU).values())
    assert abs(m1 - vol) < 1e-12 * vol and abs(l1 - vol) < 1e-12 * vol
    assert abs(vol - 0.75 * np.pi) < 0.12 * 0.75 * np.pi  # 2 cells per arc


@pytest.mark.parametrize("dim,n", [(2, 3), (3, 2)])
def test_curved_geometry_example_converges(dim, n):
    """``examples.curved_geometry.run``: non-zero Dirichlet data on the
    annulus quarter / quarter cylinder; the volume is the reference
    mesh's, and the error falls at the second order of the re-sampled
    Q1 geometry (a factor of about 4 per refinement)."""
    from hpdg_tpu_torch.examples import curved_geometry as ex
    recs = ex.run(n=n, p=2, levels=2, dim=dim, device=CPU)
    phi = annulus if dim == 2 else cylinder
    for lvl, r in enumerate(recs):
        rm = rgeo.isoparametric(rmesh.structured((n * 2**lvl,) * dim), phi)
        assert abs(r["volume"] - rm.volumes.sum()) < 1e-13
        assert r["info"]["iterations"] < 4000
    assert recs[0]["l2_err"] / recs[1]["l2_err"] > 3.0
    assert recs[0]["nodal_err"] / recs[1]["nodal_err"] > 3.0
    assert abs(recs[1]["volume"] - 0.75 * np.pi) < abs(
        recs[0]["volume"] - 0.75 * np.pi)
