"""Port vs reference: right-hand sides and the mass matrix, in f64.

``l2_functional``, ``dirichlet_rhs`` (both penalty scalings, a scalar
and a tensor medium), ``neumann_rhs`` (its sum is the physical surface
measure), ``assemble_mass`` (plain, weighted, on the block-diagonal and
on the stiffness pattern), ``lumped_mass`` and their ``api`` entry
points, on box, affine and trilinear meshes with mixed degrees, at
1e-13 of the largest entry; the volume identities
``1^T M 1 = sum l2_functional(1) = sum volumes``; a Dirichlet solve with
non-zero boundary data that reproduces a polynomial.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import dirichlet_rhs as r_dirichlet
from hpdg_tpu.assemble import l2_functional as r_l2
from hpdg_tpu.assemble.mass import assemble_mass as r_mass
from hpdg_tpu.assemble.mass import lumped_mass as r_lumped
from hpdg_tpu.assemble.plan import build_plan as r_plan
from hpdg_tpu.assemble.rhs import neumann_rhs as r_neumann
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks import api as rapi
from hpdg_tpu.mesh import geometry as rgeo

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import (assemble_mass as t_mass,
                                     dirichlet_rhs as t_dirichlet,
                                     l2_functional as t_l2,
                                     lumped_mass as t_lumped,
                                     neumann_rhs as t_neumann)
from hpdg_tpu_torch.assemble.mass import blockdiag_pattern
from hpdg_tpu_torch.assemble.plan import build_plan as t_plan
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import api as tapi
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.mesh import geometry as tgeo

from test_torch_galerkin import assert_close, assert_same_pattern
from test_torch_geometry import SHEAR2, SHEAR3, k_scalar, k_tensor
from test_torch_trilinear import annulus, cylinder, wavy2

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def pair(case):
    """(reference basis, port basis), mixed degrees."""
    if case == "box2d":
        rm, tm = rmesh.structured((3, 2)), tmesh.structured((3, 2))
    elif case == "shear2d":
        rm = rgeo.affine_image(rmesh.structured((3, 2)), SHEAR2)
        tm = tgeo.affine_image(tmesh.structured((3, 2)), SHEAR2)
    elif case == "shear3d":
        rm = rgeo.affine_image(rmesh.structured((2, 2, 1)), SHEAR3)
        tm = tgeo.affine_image(tmesh.structured((2, 2, 1)), SHEAR3)
    elif case == "wavy2":
        rm = rgeo.isoparametric(rmesh.structured((3, 2)), wavy2)
        tm = tgeo.isoparametric(tmesh.structured((3, 2)), wavy2)
    elif case == "annulus":
        rm = rgeo.isoparametric(rmesh.structured((3, 3)), annulus)
        tm = tgeo.isoparametric(tmesh.structured((3, 3)), annulus)
    else:
        rm = rgeo.isoparametric(rmesh.structured((2, 2, 2)), cylinder)
        tm = tgeo.isoparametric(tmesh.structured((2, 2, 2)), cylinder)
    deg = np.random.default_rng(17).integers(1, 4, rm.n_elements)
    return RBasis(rm, deg), TBasis(tm, deg)


CASES = ["box2d", "shear2d", "shear3d", "wavy2", "annulus", "cylinder"]


def g_ref(x):
    return jnp.sin(x[..., 0] + 0.2) * jnp.cos(0.7 * x[..., 1]) + 0.5


def g_port(x):
    return torch.sin(x[..., 0] + 0.2) * torch.cos(0.7 * x[..., 1]) + 0.5


@pytest.mark.parametrize("case", CASES)
def test_l2_functional_matches_reference(case):
    rb, tb = pair(case)
    assert_close(r_l2(rb, g_ref), t_l2(tb, g_port, device=CPU), 1e-13)
    assert_close(rapi.l2_functional(rb, g_ref, quad_order=7),
                 tapi.l2_functional(tb, g_port, quad_order=7, device=CPU),
                 1e-13)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("scaling,kind", [
    ("measure", None), ("normal", None), ("normal", "scalar"),
    ("measure", "tensor")])
def test_dirichlet_rhs_matches_reference(case, scaling, kind):
    rb, tb = pair(case)
    rk = {None: None, "scalar": k_scalar,
          "tensor": lambda x: k_tensor(x, jnp)}[kind]
    tk = {None: None, "scalar": k_scalar,
          "tensor": lambda x: k_tensor(x, torch)}[kind]
    kw = dict(penalty=4.0, penalty_scaling=scaling)
    want = r_dirichlet(rb, g_ref, diffusion=rk, plan=r_plan(rb), **kw)
    got = t_dirichlet(tb, g_port, diffusion=tk, plan=t_plan(tb), device=CPU,
                      **kw)
    assert_close(want, got, 1e-13)


@pytest.mark.parametrize("case", CASES)
def test_api_dirichlet_data_matches_reference(case):
    rb, tb = pair(case)
    assert_close(rapi.dirichlet_data(rb, g_ref, penalty=3.0),
                 tapi.dirichlet_data(tb, g_port, penalty=3.0, device=CPU),
                 1e-13)
    got = tapi.dirichlet_data(tb, g_port, penalty=3.0, device=CPU,
                              penalty_scaling="normal")
    assert_close(r_dirichlet(rb, g_ref, penalty=3.0,
                             penalty_scaling="normal"), got, 1e-13)


@pytest.mark.parametrize("case", CASES)
def test_neumann_rhs_matches_reference_and_measures_the_surface(case):
    rb, tb = pair(case)
    assert_close(r_neumann(rb, g_ref), t_neumann(tb, g_port, device=CPU),
                 1e-13)
    one = t_neumann(tb, lambda x: torch.ones_like(x[..., 0]), device=CPU)
    area = sum(float(v.sum()) for v in one.values())
    exact = {"box2d": 4.0, "shear2d": 2.0 + 2.0 * np.sqrt(1.25)}.get(case)
    if exact is not None:
        assert abs(area - exact) < 1e-12 * exact
    if case == "annulus":  # two radii and two arcs, the arcs as chords
        chords = 3 * 2 * (1.0 + 2.0) * np.sin(np.pi / 12)
        assert abs(area - (2.0 + chords)) < 1e-12 * area


@pytest.mark.parametrize("case", CASES)
def test_mass_matches_reference(case):
    rb, tb = pair(case)
    RM, TM = r_mass(rb), t_mass(tb, device=CPU)
    assert_same_pattern(RM.pattern, TM.pattern)
    assert_same_pattern(RM.pattern, blockdiag_pattern(tb))
    assert_close(RM.values, TM.values, 1e-13)
    assert_close(r_mass(rb, weight=g_ref, quad_order=6).values,
                 t_mass(tb, weight=g_port, quad_order=6, device=CPU).values,
                 1e-13)
    RP = rapi.mass(rb, plan=r_plan(rb))
    TP = tapi.mass(tb, plan=t_plan(tb), device=CPU)
    assert_same_pattern(RP.pattern, TP.pattern)
    assert_close(RP.values, TP.values, 1e-13)
    assert_close(r_lumped(rb), t_lumped(tb, device=CPU), 1e-14)


@pytest.mark.parametrize("case", CASES)
def test_volume_identities(case):
    _, tb = pair(case)
    vol = tb.mesh.volumes.sum()
    one = {p: torch.ones_like(v) for p, v in tbv.zeros(tb, device=CPU).items()}
    M1 = tbm.matvec(tapi.mass(tb, device=CPU), one)
    m1 = sum(float((one[p] * M1[p]).sum()) for p in one)
    l1 = sum(float(v.sum()) for v in tapi.l2_functional(
        tb, lambda x: torch.ones_like(x[..., 0]), device=CPU).values())
    lump = sum(float(v.sum()) for v in t_lumped(tb, device=CPU).values())
    assert abs(m1 - vol) < 1e-12 * vol and abs(l1 - vol) < 1e-12 * vol
    if tb.mesh.corners is None:  # collocation is exact for constant det
        assert abs(lump - vol) < 1e-12 * vol


@pytest.mark.parametrize("case", ["shear2d", "wavy2"])
def test_dirichlet_solve_reproduces_a_polynomial(case):
    """-Laplace u = 0 with u = 1 + 2x - y on the boundary: on an affine
    mesh the discrete solution IS the polynomial (to solver accuracy),
    on the curved one it converges to it."""
    _, tb0 = pair(case)
    tb = TBasis(tb0.mesh, np.full(tb0.mesh.n_elements, 2))
    u = lambda x: 1.0 + 2.0 * x[..., 0] - x[..., 1]  # noqa: E731
    A = tapi.laplace(tb, penalty=4.0, dirichlet=True, device=CPU)
    b = tapi.dirichlet_data(tb, u, penalty=4.0, device=CPU)
    Ad = tbm.to_dense(A, tb)
    x = np.linalg.solve(Ad, tbv.to_flat(tb, b))
    want = tbv.to_flat(tb, tapi.interpolate(tb, u, device=CPU))
    assert np.abs(x - want).max() < (1e-10 if case == "shear2d" else 2e-2)


def test_lumped_mass_needs_collocation_nodes():
    tm = tmesh.structured((2, 2))
    tb = TBasis(tm, np.full(4, 2), family="equidistant")
    with pytest.raises(NotImplementedError, match="collocation"):
        t_lumped(tb, device=CPU)
