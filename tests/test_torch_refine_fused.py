"""The fused refinement solve and ``setup_hierarchy(coarse_bases)`` on the
CPU, against the stepwise route and against ``hpdg_tpu``.

* ``refinement_solve(fused=True)`` runs the anchor and chain bodies
  eagerly on CPU tensors: the same ``steps``, ``history`` and x, bit for
  bit, as ``fused=False``, on the reference's own fused problem (3x3
  p=1, damped block-Jacobi chains of 30) and on the 6^3 p=2 patch cycle
  of ``test_torch_refine.py``;
* the port's fused solve against ``onchip_refinement_solve(fused=True)``
  and ``api.solve_linear(method="onchip")`` against the reference's: the
  same ``steps``, ``history[0]`` to f32 rounding (``H32``), and x within ``2 tol kappa
  ||x||`` in the 2-norm (below);
* ``n_runs``: one entry per run in ``runs``, the chosen run by the
  reference's rule;
* F2: a fourth positional argument of ``setup_hierarchy`` is the
  reference's ``coarse_bases`` (not read), and ``dtype`` stays a keyword.

The x tolerance: both solves end with a true residual ``||b - A x|| <=
tol ||b||`` (checked here with the dense f64 matrix), so ``||x_p - x_r||
<= ||A^-1|| 2 tol ||b|| <= 2 tol kappa(A) ||x_r||`` with kappa the
2-norm condition number of the SPD matrix, computed densely.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks import api as rapi
from hpdg_tpu.matrixfree import sipg_diagonal_blocks as r_diag
from hpdg_tpu.matrixfree import sipg_operator as r_sipg
from hpdg_tpu.matrixfree.exact import uniform_sipg_exact_residual
from hpdg_tpu.solvers import multigrid as rmg
from hpdg_tpu.solvers.refine import onchip_refinement_solve

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble import l2_functional
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import api as tapi
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.matrixfree import sipg_operator as t_sipg
from hpdg_tpu_torch.matrixfree.uniform import uniform_sipg_factorized
from hpdg_tpu_torch.solvers import matrixfree_multigrid_solver
from hpdg_tpu_torch.solvers import multigrid as tmg
from hpdg_tpu_torch.solvers import refinement_solve

from test_torch_galerkin import assert_close, to_port

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
KW = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
TOL = 1e-8
#: the reference's anchored norm is an f32 sum of squares of the hi half
#: of its residual pair (``refine.onchip_refinement_solve``'s
#: ``refstep``), the port's an f64 one: the first history entries (r = b)
#: agree to f32 rounding of sums of at most 64 terms, 64 * 2^-24 < 4e-6
H32 = 4e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def _dense(basis):
    A = t_laplace(basis, **KW, device=CPU)
    return tbm.to_dense(A, basis)


def _kappa(Ad):
    ev = np.linalg.eigvalsh(0.5 * (Ad + Ad.T))
    assert ev[0] > 0
    return ev[-1] / ev[0]


def _assert_x_within(Ad, b, x_port, x_ref, tol=TOL):
    """||x_p - x_r|| <= 2 tol kappa ||x_r|| (module docstring), after
    checking the premise: both true residuals within tol ||b||."""
    nb = np.linalg.norm(b)
    for x in (x_port, x_ref):
        assert np.linalg.norm(b - Ad @ x) <= tol * nb
    bound = 2 * tol * _kappa(Ad) * np.linalg.norm(x_ref)
    assert np.linalg.norm(x_port - x_ref) <= bound


# ---- the reference's fused problem: 3x3 p=1, block-Jacobi chains ------

@pytest.fixture(scope="module")
def jacobi_problem():
    p = 1
    rng = np.random.default_rng(8)
    tb = TBasis(tmesh.structured((3, 3)), np.full(9, p))
    b_np = {p: rng.standard_normal((9, (p + 1) ** 2))}
    D = r_diag(RBasis(rmesh.structured((3, 3)), np.full(9, p)),
               dtype=jnp.float32, **KW)
    Dinv = np.linalg.inv(np.asarray(D[p], np.float64)).astype(np.float32)
    return tb, b_np, Dinv


def _port_jacobi_solve(tb, b_np, Dinv, **kw):
    p = 1
    op32 = t_sipg(tb, dtype=torch.float32, device=CPU, **KW)
    Dt = torch.as_tensor(Dinv)

    def step(x, b):
        r = b[p] - op32(x)[p]
        return {p: x[p] + 0.7 * torch.einsum("nij,nj->ni", Dt, r)}

    b64 = {p: torch.as_tensor(b_np[p])}
    A64 = uniform_sipg_factorized(tb, device=CPU, **KW)
    residual = lambda x: tbv.sub(b64, A64(x))  # noqa: E731
    return refinement_solve(step, residual, b64, chain_k=30, tol=TOL,
                            max_steps=8, **kw)


def _assert_same_solve(a, b):
    (xa, ia), (xb, ib) = a, b
    assert ia["steps"] == ib["steps"] and ia["cycles"] == ib["cycles"]
    assert ia["history"] == ib["history"]
    for k in xa:
        assert torch.equal(xa[k], xb[k])


def test_fused_equals_stepwise_block_jacobi(jacobi_problem):
    stepwise = _port_jacobi_solve(*jacobi_problem)
    fused = _port_jacobi_solve(*jacobi_problem, fused=True)
    _assert_same_solve(stepwise, fused)
    info = fused[1]
    assert info["steps"] > 2 and info["history"][-1] <= TOL
    assert info["cycles"] == 30 * (info["steps"] - 1)
    assert info["replays"] == {"anchor": 0, "chain": 0}  # eager on the CPU
    assert info["seconds_capture"] >= 0.0
    for key in ("seconds_loop", "seconds_fetch", "seconds_verify"):
        assert 0.0 <= info[key] <= info["seconds"]


def test_fused_matches_reference_fused(jacobi_problem):
    tb, b_np, Dinv = jacobi_problem
    p = 1
    rb = RBasis(rmesh.structured((3, 3)), np.full(9, p))
    op32 = r_sipg(rb, dtype=jnp.float32, **KW)
    Dr = jnp.asarray(Dinv)

    def step(x, b):
        r = {p: b[p] - op32(x)[p]}
        return {p: x[p] + 0.7 * jnp.einsum("nij,nj->ni", Dr, r[p])}

    res = uniform_sipg_exact_residual(rb, b_np, **KW)
    xr, ir = onchip_refinement_solve(step, res, b_np, chain_k=30, tol=TOL,
                                     max_steps=8, fused=True)
    xt, it = _port_jacobi_solve(tb, b_np, Dinv, fused=True)
    assert it["steps"] == ir["steps"]
    assert it["history"][0] == pytest.approx(ir["history"][0], rel=H32)
    Ad = _dense(tb)
    flat = lambda v: v.reshape(-1)  # noqa: E731 one bucket, element order
    _assert_x_within(Ad, flat(b_np[p]), flat(xt[p].numpy()),
                     flat(np.asarray(xr[p])))


def test_n_runs_records_each_run_and_takes_the_verified(jacobi_problem):
    tb = jacobi_problem[0]
    A_host = uniform_sipg_factorized(tb, device=CPU, **KW)
    b_host = {1: torch.as_tensor(jacobi_problem[1][1])}
    calls = []

    def host_residual(x):
        # the first run's verification fails: the rule must prefer a
        # verified run to it, however fast it was
        calls.append(1)
        r = tbv.sub(b_host, A_host(x))
        return tbv.scale(1e6, r) if len(calls) == 1 else r

    x, info = _port_jacobi_solve(*jacobi_problem, fused=True, n_runs=3,
                                 host_residual=host_residual)
    runs = info["runs"]
    assert len(runs) == 3 and len(calls) == 3
    assert runs[0]["rel_residual"] > TOL
    assert all(r["rel_residual"] <= TOL for r in runs[1:])
    assert info["verified"]
    assert info["seconds"] == min(r["seconds"] for r in runs[1:])
    assert all(r["steps"] == info["steps"] for r in runs)
    assert all(r["history"] == info["history"] for r in runs)
    # every run solves the same system bit for bit on the CPU: the
    # returned x is the chosen run's, a copy of the static buffer
    x1, _ = _port_jacobi_solve(*jacobi_problem, fused=True)
    assert torch.equal(x[1], x1[1])


# ---- the 6^3 p=2 patch cycle (test_torch_refine.py's problem) ----------

def test_fused_equals_stepwise_patch_cycle():
    meshes = tmesh.hierarchy(tmesh.structured((3, 3, 3)), 1)
    basis = TBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    step, _ = matrixfree_multigrid_solver(basis, meshes=meshes,
                                          smoother="patch", use_kernel=True,
                                          dtype=torch.float32, **KW,
                                          device=CPU)
    f = lambda x: torch.sin(np.pi * x[..., 0]) * (1.0 + x[..., 1])  # noqa: E731
    b64 = l2_functional(basis, f, device=CPU)
    A64 = uniform_sipg_factorized(basis, **KW, device=CPU)
    residual = lambda x: tbv.sub(b64, A64(x))  # noqa: E731
    kw = dict(chain_k=2, tol=TOL, max_steps=8, host_residual=residual)
    stepwise = refinement_solve(step, residual, b64, **kw)
    fused = refinement_solve(step, residual, b64, fused=True, **kw)
    _assert_same_solve(stepwise, fused)
    assert fused[1]["verified"] and fused[1]["steps"] >= 3


# ---- api.solve_linear(method="onchip") against the reference -----------

def test_solve_linear_onchip_matches_reference():
    # 4^2 p=2: the p2 -> p1 V-cycle with a dense coarse solve (an h-level
    # below would triple the reference's compile of its fused loop)
    p = 2
    deg = np.full(16, p)
    rb = RBasis(rmesh.structured((4, 4)), deg)
    tb = TBasis(tmesh.structured((4, 4)), deg)
    RA = rapi.laplace(rb, penalty=2.0, dirichlet=True)
    b = rapi.l2_functional(rb, lambda x: jnp.sin(np.pi * x[..., 0])
                           * jnp.cos(np.pi * x[..., 1]))
    b_np = {k: np.asarray(v) for k, v in b.items()}
    kw = dict(tol=TOL, maxiter=40, method="onchip")
    xr, ir = rapi.solve_linear(rb, RA, b, **kw)
    xt, it = tapi.solve_linear(tb, to_port(RA), {k: torch.tensor(v)
                                                 for k, v in b_np.items()},
                               **kw)
    assert it["verified"] and ir["verified"]
    assert it["steps"] == ir["steps"]
    assert it["history"][0] == pytest.approx(ir["history"][0], rel=H32)
    assert "seconds_capture" in it  # the fused route, as the reference's
    Ad = tbm.to_dense(to_port(RA), tb)
    flat = lambda x: tbv.to_flat(  # noqa: E731
        tb, {k: torch.tensor(np.asarray(v)) for k, v in x.items()})
    _assert_x_within(Ad, flat(b_np), flat(xt), flat(xr))


# ---- F2: setup_hierarchy's fourth positional argument -------------------

def test_setup_hierarchy_takes_coarse_bases_in_fourth_place():
    rms = rmesh.hierarchy(rmesh.structured((2, 2)), 1)
    tms = tmesh.hierarchy(tmesh.structured((2, 2)), 1)
    deg = np.full(16, 3)
    rb, tb = RBasis(rms[-1], deg), TBasis(tms[-1], deg)
    RA = rapi.laplace(rb, penalty=2.0, dirichlet=True)
    TA = to_port(RA)
    rd = rmg.setup_hierarchy(rb, RA, rms, [rb])
    td = tmg.setup_hierarchy(tb, TA, tms, [tb])
    assert len(td.bases) == len(rd.bases) == 3  # 4^2 p3, 4^2 p1, 2^2 p1
    for rbas, tbas in zip(rd.bases, td.bases):
        assert tbas.mesh.n_elements == rbas.mesh.n_elements
        np.testing.assert_array_equal(tbas.degrees, rbas.degrees)
    for RM, TM in zip(rd.matrices, td.matrices):
        assert_close(RM.values, TM.values, 1e-12)
        assert all(v.dtype == torch.float64 for v in TM.values.values())
    # dtype is still taken by keyword, after coarse_bases
    t32 = tmg.setup_hierarchy(tb, TA, tms, None, dtype=torch.float32)
    assert all(v.dtype == torch.float32
               for M in t32.matrices[:-1] for v in M.values.values())
    for M32, M64 in zip(t32.matrices, td.matrices):
        assert_close({k: v.double() for k, v in M32.values.items()},
                     M64.values, 1e-6)
