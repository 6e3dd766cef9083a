"""The PDAS inner solve of ``solve_obstacle_verified`` as a reusable
program (``solvers.tnnmg.TruncatedRefinement``), on CPU tensors.

On a card its ``fused`` route replays two CUDA graphs over static
buffers; here the same bodies run eagerly on those buffers, so every
comparison is bit for bit:

* ``fused=True`` against ``fused=False`` over outers whose active sets
  change: equal histories, ``y`` equal after every outer;
* the static buffers take a renewal: the parametric cycle on them equals
  the cycle on the freshly renewed hierarchy, and differs from the cycle
  on the buffers as they were before;
* ``solve_obstacle_verified(n_runs=2)`` resets its state between runs:
  both runs take the same iterations, outers and steps, and return the
  ``x`` of ``n_runs=1``.

The reference comparison of the whole verified solve is
``test_torch_obstacle.py::test_solve_obstacle_verified_matches_reference``,
the graph routes on the card are in ``test_torch_kernel_cuda.py``.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.solvers import smoothers as sm
from hpdg_tpu_torch.solvers import tnnmg as tn
from hpdg_tpu_torch.solvers.multigrid import (parametric_cycle,
                                              setup_hierarchy)

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
f32, f64 = torch.float32, torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def problem(n, p):
    """Config 5's membrane pushed into a lower obstacle at -0.2 on n^2
    at degree p (port only): (basis, A64, b64, lo, up)."""
    m = tmesh.structured((n, n), lower=(-1, -1), upper=(1, 1))
    basis = DGBasis(m, np.full(m.n_elements, p))
    A64 = api.laplace(basis, penalty=2.0, dirichlet=True, device=CPU)
    b64 = api.l2_functional(basis, lambda x: -8.0 + 0.0 * x[..., 0],
                            device=CPU)
    lo, up = api.constant_bounds(basis, lower=-0.2, device=CPU)
    return basis, A64, b64, lo, up


def to32(A64):
    return bm.BlockSparseMatrix(
        A64.pattern, A64.dim, {k: v.to(f32) for k, v in A64.values.items()},
        A64.block_shape)


def refinement(basis, A64, b64, fused, chain_k=2):
    """A ``TruncatedRefinement`` on a hierarchy of its own, as
    ``solve_obstacle_verified`` builds it."""
    A32 = to32(A64)
    free = {k: torch.ones(v.shape, dtype=torch.bool) for k, v in b64.items()}
    data = setup_hierarchy(basis, tn.truncated_matrix(A32, free), dtype=f32)
    return tn.TruncatedRefinement(A64, A32, data, parametric_cycle(
        data, dtype=f32), b64, chain_k=chain_k, max_steps=12, fused=fused)


@pytest.fixture(scope="module")
def c5_8():
    """8^2 p=2 and three outers' (free, b_tr) of shrinking active sets:
    the dofs within 0.1, 1e-3 and 1e-9 of the obstacle at the f64 TNNMG
    solution, the rest free, ``b_tr = F (b - A x_act)``."""
    basis, A64, b64, lo, up = problem(8, 2)
    x, hist = tn.solve_tnnmg(A64, b64, basis, lo, up, tol=1e-10, maxiter=40)
    assert max(hist["truncated"]) > 0
    systems = []
    for eps in (1e-1, 1e-3, 1e-9):
        free = {k: x[k] > lo[k] + eps for k in x}
        x_act = {k: torch.where(free[k], 0.0, lo[k]) for k in x}
        Axa = bm.matvec(A64, x_act)
        systems.append((free, {k: torch.where(free[k], b64[k] - Axa[k], 0.0)
                               for k in x}))
    return basis, A64, b64, systems


def test_truncated_refinement_fused_equals_eager(c5_8):
    basis, A64, b64, systems = c5_8
    fused = refinement(basis, A64, b64, fused=True)
    eager = refinement(basis, A64, b64, fused=False)
    assert fused.graphs is None and fused.mats is not fused.data.matrices
    tol_cut = 1e-8 * float(bv.norm(b64))
    actives = set()
    for free, b_tr in systems:
        actives.add(sum(int((~v).sum()) for v in free.values()))
        hf = fused(free, b_tr, tol_cut)
        he = eager(free, b_tr, tol_cut)
        assert hf == he and len(hf) >= 2 and hf[-1] <= tol_cut
        assert all(torch.equal(fused.y[k], eager.y[k]) for k in b64)
    assert len(actives) == 3  # the active set changed at every outer


def test_static_buffers_take_the_renewal(c5_8):
    basis, A64, b64, systems = c5_8
    ref = refinement(basis, A64, b64, fused=True)
    stale = [bm.BlockSparseMatrix(M.pattern, M.dim,
                                  {k: v.clone() for k, v in M.values.items()},
                                  M.block_shape) for M in ref.mats]
    stale_dinvs = [{p: d.clone() for p, d in D.items()} for D in ref.dinvs]
    buffers = [M.values for M in ref.mats]
    free, b_tr = systems[1]
    ref.load(free, b_tr)
    # the buffers are the same tensors, renewed in place
    assert all(M.values is v for M, v in zip(ref.mats, buffers))
    assert all(torch.equal(ref.ff[k], free[k].to(f64))
               and torch.equal(ref.b_tr[k], b_tr[k]) for k in b64)
    rng = np.random.default_rng(5)
    rhs = {k: torch.as_tensor(rng.standard_normal(v.shape), dtype=f32)
           for k, v in b64.items()}
    zero = bv.zeros_like(rhs)
    fresh = ref.data.matrices
    want = ref.cycle(fresh, [sm.inverse_diagonal_blocks(M) for M in fresh],
                     zero, rhs)
    got = ref.cycle(ref.mats, ref.dinvs, zero, rhs)
    old = ref.cycle(stale, stale_dinvs, zero, rhs)
    assert all(torch.equal(got[k], want[k]) for k in rhs)
    assert not all(torch.equal(old[k], want[k]) for k in rhs)


def test_verified_solve_n_runs_resets_between_runs():
    basis, A64, b64, lo, up = problem(4, 2)
    kw = dict(tol=1e-8, maxiter=30, max_outer=6)
    x1, info1 = tn.solve_obstacle_verified(A64, b64, basis, lo, up, **kw)
    x2, info2 = tn.solve_obstacle_verified(A64, b64, basis, lo, up,
                                           n_runs=2, **kw)
    a, b = info2["runs"]
    (one,) = info1["runs"]
    assert one["verified"] and one["truncated"] > 0
    for run in (a, b):
        for key in ("tnnmg_iterations", "steps", "truncated", "verified",
                    "free_residual"):
            assert run[key] == one[key]
    assert info2["seconds_capture"] >= 0.0
    assert all(np.array_equal(x1[k], x2[k]) for k in x1)
