"""Port vs reference: the DG-norm error indicators, in f64.

``ipdg_local_norm`` (Dirichlet on and off, both penalty scalings) and
``jump_indicator`` on 2D and 3D box meshes with mixed degrees, uniform
and after ``refine_local`` (hanging faces), from the same numpy-seeded
coefficients: per-element values at 1e-12 of their max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.matrixfree import norms as rnorms
from hpdg_tpu.mesh.adaptive import refine_local as r_refine

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.matrixfree import norms as tnorms
from hpdg_tpu_torch.mesh.adaptive import refine_local as t_refine

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def bases(cells, refined: bool, pmax: int, seed: int):
    """Reference and port bases on the same mesh and degrees."""
    rm, tm = rmesh.structured(cells), tmesh.structured(cells)
    rng = np.random.default_rng(seed)
    if refined:
        marks = rng.random(rm.n_elements) < 0.4
        rm, tm = r_refine(rm, marks), t_refine(tm, marks)
        assert (tm.faces.nc_code > 0).any()
    deg = rng.integers(1, pmax + 1, rm.n_elements)
    return RBasis(rm, deg), TBasis(tm, deg)


def coeffs(basis, seed):
    rng = np.random.default_rng(seed)
    return {p: rng.standard_normal((basis.bucket_size(p), basis.n_local(p)))
            for p in basis.bucket_degrees}


def assert_rel(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


CASES = [((4, 3), False, 4), ((3, 4), True, 3), ((2, 3, 2), False, 3),
         ((2, 2, 3), True, 2)]


@pytest.mark.parametrize("cells,refined,pmax", CASES)
@pytest.mark.parametrize("dirichlet", [True, False])
@pytest.mark.parametrize("scaling", ["measure", "normal"])
def test_ipdg_local_norm_matches_reference(cells, refined, pmax, dirichlet,
                                           scaling):
    rb, tb = bases(cells, refined, pmax, seed=len(cells) + pmax)
    x = coeffs(rb, 5)
    want = rnorms.ipdg_local_norm(rb, penalty=3.0, dirichlet=dirichlet,
                                  penalty_scaling=scaling)(
        {p: jnp.asarray(v) for p, v in x.items()})
    got = tnorms.ipdg_local_norm(tb, penalty=3.0, dirichlet=dirichlet,
                                 penalty_scaling=scaling, device=CPU)(
        convert.bucket_dict(x, device=CPU))
    assert_rel(got, want, 1e-12)


@pytest.mark.parametrize("cells,refined,pmax", CASES)
def test_jump_indicator_matches_reference(cells, refined, pmax):
    rb, tb = bases(cells, refined, pmax, seed=7 + pmax)
    x = coeffs(rb, 6)
    want = rnorms.jump_indicator(rb, penalty=2.0)(
        {p: jnp.asarray(v) for p, v in x.items()})
    got = tnorms.jump_indicator(tb, penalty=2.0, device=CPU)(
        convert.bucket_dict(x, device=CPU))
    assert_rel(got, want, 1e-12)


def test_norm_of_f32_coefficients_is_taken_in_f64():
    """A float32 vector is promoted to the indicator's f64 tables."""
    _, tb = bases((3, 3), True, 3, seed=2)
    x = convert.bucket_dict(coeffs(tb, 7), device=CPU)
    x32 = {p: v.float() for p, v in x.items()}
    op = tnorms.ipdg_local_norm(tb, dirichlet=True, device=CPU)
    want = op({p: v.double() for p, v in x32.items()})
    assert torch.equal(op(x32), want)
    jump = tnorms.jump_indicator(tb, device=CPU)
    assert (op(x) >= jump(x) - 1e-14).all()  # the jumps are one part
