"""Port vs reference: diagonal blocks, block Jacobi, PCG and the
hp-adaptive solve of this slice, in f64.

* sipg_diagonal_blocks (constant, scalar, tensor coefficients) at 1e-12
  of max|D| against the reference and against the diagonal of the
  port's assembled matrix (sums in another order);
* pcg with block Jacobi on BASELINE config 1 (2D Poisson SIPG p=2 at
  4x4, tests/test_solve_poisson.py): the same iteration count, x within
  1e-10 of max|x| and the residual histories within 1e-8 relative
  (CG amplifies roundoff differences of the two packages' sums, so the
  roundoff-dominated last steps are held at 1e-8 of ||r_0||);
* the whole slice: mesh refined from the same marks, mixed degrees,
  sum-factorized matvec, block-Jacobi PCG from the matrix-free diagonal
  blocks, in both packages; x within 1e-8 of max|x| and verified by the
  port's dedup SpMV, an independent route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import matrixfree as rmf
from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_assemble
from hpdg_tpu.assemble import l2_functional as r_l2
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.linalg import blockvector as rbv
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.solvers import pcg as r_pcg
from hpdg_tpu.solvers import smoothers as rsm

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import matrixfree as tmf
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_assemble
from hpdg_tpu_torch.assemble import l2_functional as t_l2
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.solvers import pcg as t_pcg
from hpdg_tpu_torch.solvers import smoothers as tsm

from test_torch_sumfact import DIFFUSION, assert_close, hanging_pair

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.mark.parametrize("case", ["2d", "3d"])
@pytest.mark.parametrize("kind,scaling", [(None, "measure"),
                                          (None, "normal"),
                                          ("scalar", "normal"),
                                          ("tensor", "measure")])
def test_sipg_diagonal_blocks(case, kind, scaling):
    rb, tb = hanging_pair(case)
    k_ref, k_port = DIFFUSION[kind]
    kw = dict(penalty=3.0, dirichlet=True, penalty_scaling=scaling)
    want = rmf.sipg_diagonal_blocks(rb, diffusion=k_ref, **kw)
    got = tmf.sipg_diagonal_blocks(tb, diffusion=k_port, **kw, device=CPU)
    assert_close(want, got)
    diag = tbm.extract_diagonal(t_assemble(tb, diffusion=k_port, **kw,
                                           device=CPU))
    assert_close({p: v.numpy() for p, v in diag.items()}, got)


def test_extract_diagonal_and_diag_slots():
    rb, tb = hanging_pair("2d")
    RA = r_assemble(rb, penalty=2.0, dirichlet=True)
    TA = t_assemble(tb, penalty=2.0, dirichlet=True, device=CPU)
    rs, ts = rbm.diag_slots(RA.pattern), tbm.diag_slots(TA.pattern)
    for p in rs:
        np.testing.assert_array_equal(rs[p], ts[p])
    assert_close(rbm.extract_diagonal(RA), tbm.extract_diagonal(TA))


def test_blockvector_random_draws_the_reference_numbers():
    rb, tb = hanging_pair("3d")
    for seed in (1887, 4):
        want, got = rbv.random(rb, seed), tbv.random(tb, seed, device=CPU)
        for p in want:
            np.testing.assert_array_equal(np.asarray(want[p]), got[p].numpy())


def test_block_jacobi_step_matches_reference():
    rb, tb = hanging_pair("2d")
    RA = r_assemble(rb, penalty=4.0, dirichlet=True)
    TA = t_assemble(tb, penalty=4.0, dirichlet=True, device=CPU)
    b = rbv.random(rb, 3)
    rx, tx = rbv.zeros(rb), tbv.zeros(tb, device=CPU)
    rstep, tstep = rsm.block_jacobi_step(RA, 0.6), tsm.block_jacobi_step(TA,
                                                                         0.6)
    tb_ = convert.bucket_dict({p: np.asarray(v) for p, v in b.items()},
                              device=CPU)
    for _ in range(3):
        rx, tx = rstep(rx, b), tstep(tx, tb_)
    assert_close(rx, tx)


def _f_ref(x):
    return 2 * jnp.pi**2 * jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(
        jnp.pi * x[..., 1])


def _f_port(x):
    return 2 * np.pi**2 * torch.sin(np.pi * x[..., 0]) * torch.sin(
        np.pi * x[..., 1])


def test_pcg_config1_matches_reference():
    """BASELINE config 1: 2D Poisson SIPG p=2, 4x4, CG + block Jacobi
    (tests/test_solve_poisson.py::solve_poisson)."""
    n, p = 4, 2
    rm, tm = rmesh.structured((n, n)), tmesh.structured((n, n))
    rb = RBasis(rm, np.full(rm.n_elements, p))
    tb = TBasis(tm, np.full(tm.n_elements, p))
    RA = r_assemble(rb, penalty=2.0 * p, dirichlet=True)
    TA = t_assemble(tb, penalty=2.0 * p, dirichlet=True, device=CPU)
    rx, rinfo = r_pcg(lambda v: rbm.matvec(RA, v), r_l2(rb, _f_ref),
                      precond=rsm.block_jacobi_preconditioner(RA),
                      tol=1e-10, maxiter=2000)
    tx, tinfo = t_pcg(lambda v: tbm.matvec(TA, v), t_l2(tb, _f_port, device=CPU),
                      precond=tsm.block_jacobi_preconditioner(TA),
                      tol=1e-10, maxiter=2000)
    k = int(rinfo["iterations"])
    assert tinfo["iterations"] == k
    rh, th = np.asarray(rinfo["residuals"]), tinfo["residuals"].numpy()
    assert th.shape == rh.shape == (2001,)
    # pointwise 1e-8 relative down to 1e-6 of ||r_0||; below that the
    # recursion's roundoff (~1e-12 of ||r_0|| here) dominates the last
    # steps, which agree to 1e-8 of ||r_0||
    big = rh >= 1e-6 * rh[0]
    np.testing.assert_allclose(th[big], rh[big], rtol=1e-8)
    np.testing.assert_allclose(th, rh, rtol=0, atol=1e-8 * rh[0])
    assert (th[k:] == th[k]).all() and th[k] <= 1e-10 * th[0] * 10
    assert_close(rx, tx, tol=1e-10)


def test_pcg_contract_without_preconditioner():
    """maxiter cut: history padded with the last value; rtol=False takes
    tol as an absolute target."""
    rb, tb = hanging_pair("2d")
    TA = t_assemble(tb, penalty=4.0, dirichlet=True, device=CPU)
    RA = r_assemble(rb, penalty=4.0, dirichlet=True)
    b = rbv.random(rb, 2)
    # tol 5.0 is absolute: the history falls to 4.76 at k = 7, far from
    # the target, so roundoff cannot move the stopping step
    for rtol, tol, maxiter in ((True, 1e-30, 5), (False, 5.0, 400)):
        rx, ri = r_pcg(lambda v: rbm.matvec(RA, v), b, tol=tol,
                       maxiter=maxiter, rtol=rtol)
        tx, ti = t_pcg(lambda v: tbm.matvec(TA, v),
                       convert.bucket_dict({p: np.asarray(v)
                                            for p, v in b.items()}, device=CPU),
                       tol=tol, maxiter=maxiter, rtol=rtol)
        assert ti["iterations"] == int(ri["iterations"]) == min(7, maxiter)
        np.testing.assert_allclose(ti["residuals"].numpy(),
                                   np.asarray(ri["residuals"]), rtol=1e-8)
        assert_close(rx, tx, tol=1e-10)


def _phase7_recipe(cells):
    """The chip run's hp-adaptive solve set-up: 30% of the base lattice
    marked with default_rng(3), refined with 2:1 closure; degrees in
    {2, 3, 4} from default_rng(1887)."""
    marks = np.random.default_rng(3).random(int(np.prod(cells))) < 0.3
    r0, t0 = rmesh.structured(cells), tmesh.structured(cells)
    rm = radapt.refine_local(r0, radapt.close_marks(r0, marks))
    tm = tadapt.refine_local(t0, tadapt.close_marks(t0, marks))
    degrees = np.random.default_rng(1887).integers(2, 5, size=rm.n_elements)
    return RBasis(rm, degrees), TBasis(tm, degrees)


def test_hp_adaptive_block_jacobi_pcg_slice():
    rb, tb = _phase7_recipe((2, 2, 2))
    assert (tb.mesh.faces.nc_code > 0).any()
    assert len(tb.bucket_degrees) == 3
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")

    def f_ref(x):
        return 3 * jnp.pi**2 * jnp.prod(jnp.sin(jnp.pi * x), axis=-1)

    def f_port(x):
        return 3 * np.pi**2 * torch.prod(torch.sin(np.pi * x), dim=-1)

    # reference: jitted PCG around the sum-factorized matvec
    rop = rmf.sipg_operator(rb, **kw)
    Dr = rmf.sipg_diagonal_blocks(rb, **kw)
    Dinv = {p: jnp.asarray(np.linalg.inv(np.asarray(d))) for p, d in
            Dr.items()}
    rx, rinfo = jax.jit(lambda b: r_pcg(
        rop, b, precond=lambda r: rsm.apply_blockdiag(Dinv, r), tol=1e-8,
        maxiter=5000))(r_l2(rb, f_ref))
    # port
    top = tmf.sipg_operator(tb, **kw, device=CPU)
    M = tsm.block_jacobi_preconditioner(
        tmf.sipg_diagonal_blocks(tb, **kw, device=CPU))
    b = t_l2(tb, f_port, device=CPU)
    tx, tinfo = t_pcg(top, b, precond=M, tol=1e-8, maxiter=5000)
    assert tinfo["iterations"] == int(rinfo["iterations"])
    assert_close(rx, tx, tol=1e-8)
    # verified by the dedup SpMV (assembled blocks, another route)
    dd, _ = tmf.dedup_spmv_from_plan(tb, dtype=torch.float64, **kw, device=CPU)
    rel = float(tbv.norm(tbv.sub(b, dd(tx))) / tbv.norm(b))
    assert rel <= 1e-8, rel
