"""Port vs reference: patch smoothing and the matrix-free V-cycle, f64.

The reference runs its matrix-free multigrid with ``use_pallas=False``
(the sum-factorized operator: the same operator as the stencil to f64
roundoff) and ``smoother="patch"``; the port runs the stencil kernel's
route (``use_kernel=True``: its plain twin on the CPU) and its default,
sum-factorized route.  One smoother sweep and one V-cycle from the same
(x, b) agree to 1e-11, and the per-cycle contraction rates to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.matrixfree import sipg_operator as r_sipg
from hpdg_tpu.solvers.multigrid import \
    matrixfree_multigrid_solver as r_mg
from hpdg_tpu.solvers.patches import uniform_patch_smoother as r_ups

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.matrixfree.uniform import uniform_sipg_factorized
from hpdg_tpu_torch.ops.uniform_stencil import uniform_stencil_operator
from hpdg_tpu_torch.solvers.multigrid import \
    matrixfree_multigrid_solver as t_mg
from hpdg_tpu_torch.solvers.patches import uniform_patch_smoother as t_ups

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the tests run in several worker processes on one machine: one
    # thread each for torch and numpy's BLAS keeps them from
    # oversubscribing its cores
    with threadpool_limits(1):
        yield


KW = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")


def _rel(got: dict, want: dict) -> float:
    num = sum(float(np.sum((got[p].numpy() - np.asarray(want[p])) ** 2))
              for p in want)
    den = sum(float(np.sum(np.asarray(want[p]) ** 2)) for p in want)
    return (num / den) ** 0.5


def _rand(basis, seed):
    rng = np.random.default_rng(seed)
    return {p: rng.standard_normal((basis.bucket_size(p), basis.n_local(p)))
            for p in basis.bucket_degrees}


@pytest.mark.parametrize("cells,p", [((4, 3, 4), 2), ((5, 4), 4)])
@pytest.mark.parametrize("reverse", [False, True])
def test_patch_smoother_step_matches_reference(cells, p, reverse):
    n = int(np.prod(cells))
    rb = RBasis(rmesh.structured(cells), np.full(n, p))
    tb = TBasis(tmesh.structured(cells), np.full(n, p))
    rstep = r_ups(r_sipg(rb, dtype=jnp.float64, **KW), rb, 2.0,
                  dirichlet=True, penalty_scaling="normal", reverse=reverse)
    tstep = t_ups(uniform_stencil_operator(tb, **KW, device=CPU), tb, 2.0,
                  dirichlet=True, penalty_scaling="normal", reverse=reverse,
                  device=CPU)
    x, b = _rand(rb, 3), _rand(rb, 4)
    want = rstep({q: jnp.asarray(v) for q, v in x.items()},
                 {q: jnp.asarray(v) for q, v in b.items()})
    xt = convert.bucket_dict(x, device=CPU)
    got = tstep(xt, convert.bucket_dict(b, device=CPU))
    assert _rel(got, want) < 1e-11
    np.testing.assert_array_equal(xt[p].numpy(), x[p])  # x is not mutated


@pytest.fixture(scope="module")
def hierarchy():
    """3^3 -> 6^3 at p=2: levels p2 6^3, p1 6^3, p1 3^3 (coarse), the
    port's cycle by the stencil route (K1's twin on the CPU)."""
    rms = rmesh.hierarchy(rmesh.structured((3, 3, 3)), 1)
    tms = tmesh.hierarchy(tmesh.structured((3, 3, 3)), 1)
    n = rms[-1].n_elements
    rb, tb = RBasis(rms[-1], np.full(n, 2)), TBasis(tms[-1], np.full(n, 2))
    rstep, _ = r_mg(rb, meshes=rms, use_pallas=False, smoother="patch",
                    dtype=jnp.float64, **KW)
    tstep, info = t_mg(tb, meshes=tms, smoother="patch", use_kernel=True,
                       dtype=torch.float64, **KW, device=CPU)
    return rb, tb, jax.jit(rstep), tstep, info, tms


@pytest.mark.parametrize("use_kernel", [True, False])
def test_vcycle_matches_reference(hierarchy, use_kernel):
    rb, tb, rstep, tstep, info, tms = hierarchy
    if not use_kernel:  # the default, sum-factorized route
        tstep, info = t_mg(tb, meshes=tms, smoother="patch",
                           dtype=torch.float64, **KW, device=CPU)
    assert [b.mesh.n_elements for b in info["bases"]] == [27, 216, 216]
    assert [b.bucket_degrees for b in info["bases"]] == [(1,), (1,), (2,)]
    assert all(s is not None for s in info["smoothers"])  # patches
    x, b = _rand(rb, 5), _rand(rb, 6)
    want = rstep({q: jnp.asarray(v) for q, v in x.items()},
                 {q: jnp.asarray(v) for q, v in b.items()})
    got = tstep(convert.bucket_dict(x, device=CPU),
                convert.bucket_dict(b, device=CPU))
    assert _rel(got, want) < 1e-11


def test_contraction_rate_matches_reference(hierarchy):
    rb, tb, rstep, tstep, _, _ = hierarchy
    b = _rand(rb, 7)
    rop = r_sipg(rb, dtype=jnp.float64, **KW)
    top = uniform_sipg_factorized(tb, dtype=torch.float64, **KW, device=CPU)
    bj = {q: jnp.asarray(v) for q, v in b.items()}
    bt = convert.bucket_dict(b, device=CPU)
    xr, xt = {q: jnp.zeros_like(v) for q, v in bj.items()}, tbv.zeros_like(bt)
    res_r, res_t = [1.0], [1.0]
    nb = float(np.sqrt(sum(np.sum(v ** 2) for v in b.values())))
    for _ in range(3):
        xr, xt = rstep(xr, bj), tstep(xt, bt)
        rr = {q: bj[q] - v for q, v in rop(xr).items()}
        res_r.append(float(np.sqrt(sum(float(jnp.sum(v ** 2))
                                       for v in rr.values()))) / nb)
        res_t.append(float(tbv.norm(tbv.sub(bt, top(xt)))) / nb)
    rate_r = res_r[-1] ** (1 / 3)
    rate_t = res_t[-1] ** (1 / 3)
    assert rate_t < 0.1  # the patch-smoothed hierarchy contracts fast
    assert abs(rate_t - rate_r) < 1e-6, (rate_t, rate_r)


def test_solver_refuses_unported_branches():
    """The matrix-free solver knows "cheb" and "patch" only; a patch
    block above 1024 dofs (p=5 in 3D) smooths by Chebyshev, as in the
    reference."""
    tb = TBasis(tmesh.structured((2, 2, 2)), np.full(8, 2))
    with pytest.raises(ValueError):
        t_mg(tb, smoother="line", **KW, device=CPU)
    tb5 = TBasis(tmesh.structured((2, 2, 2)), np.full(8, 5))
    _, info = t_mg(tb5, smoother="patch", **KW, device=CPU)
    assert info["smoothers"][-1] is None  # Chebyshev on the p=5 level
