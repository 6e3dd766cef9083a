"""The whole slice on the CPU: 3D SIPG p=2 on 6^3 (3^3 -> 6^3 hierarchy),
f32 V-cycle chains with f64 anchors, verified to 1e-8 — and the port's
answer checked independently with the reference's assembled f64 matrix."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_assemble
from hpdg_tpu.assemble import l2_functional as r_l2
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import l2_functional
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.matrixfree.uniform import uniform_sipg_factorized
from hpdg_tpu_torch.solvers import matrixfree_multigrid_solver, refinement_solve

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the tests run in several worker processes on one machine: one
    # thread each for torch and numpy's BLAS keeps them from
    # oversubscribing its cores
    with threadpool_limits(1):
        yield


KW = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")


@pytest.fixture(scope="module")
def solved():
    meshes = tmesh.hierarchy(tmesh.structured((3, 3, 3)), 1)
    basis = TBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    step, _ = matrixfree_multigrid_solver(basis, meshes=meshes,
                                          smoother="patch", use_kernel=True,
                                          dtype=torch.float32, **KW, device=CPU)
    f = lambda x: torch.sin(np.pi * x[..., 0]) * (1.0 + x[..., 1])  # noqa: E731
    b64 = l2_functional(basis, f, device=CPU)
    A64 = uniform_sipg_factorized(basis, **KW, device=CPU)
    residual = lambda x: bv.sub(b64, A64(x))  # noqa: E731
    x64, info = refinement_solve(step, residual, b64, chain_k=2, tol=1e-8,
                                 max_steps=8, host_residual=residual)
    return basis, x64, info


def test_refinement_reaches_verified_1e8(solved):
    _, x64, info = solved
    assert info["verified"] and info["rel_residual"] <= 1e-8
    h = info["history"]
    assert h[0] == pytest.approx(1.0)
    assert all(h[i + 1] < 1e-2 * h[i] for i in range(len(h) - 1))
    assert info["steps"] == len(h) <= 8
    assert info["cycles"] == 2 * (info["steps"] - 1)
    assert len(info["runs"]) == 1
    (x,) = x64.values()
    assert x.dtype == torch.float64 and torch.isfinite(x).all()


def test_refined_answer_checked_by_reference_assembly(solved):
    """Independent check: b - A x with hpdg_tpu's assembled f64 matrix
    and its own load vector, the port's x64 handed over as numpy."""
    _, x64, _ = solved
    meshes = rmesh.hierarchy(rmesh.structured((3, 3, 3)), 1)
    rb = RBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    A = r_assemble(rb, dtype=jnp.float64, **KW)
    b = r_l2(rb, lambda x: jnp.sin(jnp.pi * x[..., 0]) * (1.0 + x[..., 1]),
             dtype=jnp.float64)
    x = convert.to_numpy(x64)
    Ax = rbm.matvec(A, {p: jnp.asarray(v) for p, v in x.items()})
    r = np.concatenate([np.asarray(b[p] - Ax[p]).ravel() for p in b])
    nb = np.linalg.norm(np.concatenate([np.asarray(b[p]).ravel() for p in b]))
    assert np.linalg.norm(r) / nb <= 1e-8
