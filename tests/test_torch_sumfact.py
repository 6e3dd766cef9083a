"""Port vs reference: the sum-factorized matrix-free operators, in f64.

sipg_operator on hanging-node, mixed-degree box meshes in 1D, 2D and
3D (scalar and tensor diffusion, SIPG/IIPG/NIPG/theta, sigma1,
Dirichlet on and off, both penalty scalings), held at 1e-12 of max|y|
against ``hpdg_tpu``'s sipg_operator AND against the port's own
assembled matvec — the same operator by an independent route.  The
sums run in another order, so the bound sits a few hundred ulps above
f64 roundoff.  laplace_bulk_operator, mass_operator and
naive_sipg_operator at the same bound; the f32 apply at 1e-5 of
max|y| (f32 roundoff of sums over a few hundred terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import matrixfree as rmf
from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_assemble
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.mesh.adaptive import refine_local as r_refine_local

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import matrixfree as tmf
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_assemble
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.mesh.adaptive import refine_local as t_refine_local

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


# the same coefficient formula, once per package
def k_scalar_ref(x):
    return 1.0 + x[..., 0] ** 2 + 0.5 * x[..., -1]


def k_scalar_port(x):
    return 1.0 + x[..., 0] ** 2 + 0.5 * x[..., -1]


def k_tensor_ref(x):
    d = x.shape[-1]
    eye = jnp.eye(d)
    return (eye * (1.5 + x ** 2)[..., None, :]
            + 0.2 * x[..., 0, None, None] * (1.0 - eye))


def k_tensor_port(x):
    d = x.shape[-1]
    eye = torch.eye(d, dtype=x.dtype)
    return (eye * (1.5 + x ** 2)[..., None, :]
            + 0.2 * x[..., 0, None, None] * (1.0 - eye))


DIFFUSION = {None: (None, None), "scalar": (k_scalar_ref, k_scalar_port),
             "tensor": (k_tensor_ref, k_tensor_port)}


def hanging_pair(case):
    """(reference basis, port basis) on the same refined mesh and
    degrees: a 2D 2x2 and a 3D 2x2x2 lattice with two elements refined
    (hanging faces) and mixed degrees, and a refined 1D line."""
    cells, marks = {"2d": ((2, 2), [0, 1, 1, 0]),
                    "3d": ((2, 2, 2), [1, 0, 0, 0, 0, 0, 0, 1]),
                    "1d": ((4,), [0, 1, 0, 0])}[case]
    marks = np.asarray(marks, bool)
    rm = r_refine_local(rmesh.structured(cells), marks)
    tm = t_refine_local(tmesh.structured(cells), marks)
    degrees = np.random.default_rng(1887).integers(
        1 if case != "3d" else 2, 4 if case != "1d" else 5,
        size=rm.n_elements)
    return RBasis(rm, degrees), TBasis(tm, degrees)


def random_x(basis, seed=5):
    rng = np.random.default_rng(seed)
    return {p: rng.standard_normal((basis.bucket_size(p), basis.n_local(p)))
            for p in basis.bucket_degrees}


def assert_close(want: dict, got: dict, tol=TOL):
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    assert want.keys() == got.keys()
    for p in want:
        d = np.abs(np.asarray(want[p]) - got[p].detach().cpu().numpy()).max()
        assert d <= tol * scale, (p, d / scale)


VARIANTS = [  # dirichlet, scaling, dg_form, sigma1, diffusion
    (True, "measure", "sipg", 0.0, None),
    (False, "normal", "sipg", 0.0, None),
    (True, "normal", "nipg", 0.7, None),
    (True, "measure", 0.5, 0.0, None),
    (True, "normal", "iipg", 0.0, "scalar"),
    (False, "measure", "sipg", 0.3, "scalar"),
    (True, "normal", "sipg", 0.0, "tensor"),
    (True, "measure", "nipg", 0.4, "tensor"),
]


@pytest.mark.parametrize("case", ["2d", "3d"])
@pytest.mark.parametrize("dirichlet,scaling,dg_form,sigma1,kind", VARIANTS)
def test_sipg_operator_matches_reference_and_assembly(case, dirichlet,
                                                      scaling, dg_form,
                                                      sigma1, kind):
    rb, tb = hanging_pair(case)
    k_ref, k_port = DIFFUSION[kind]
    kw = dict(penalty=3.0, dirichlet=dirichlet, penalty_scaling=scaling,
              dg_form=dg_form, sigma1=sigma1)
    x = random_x(rb)
    ry = rmf.sipg_operator(rb, diffusion=k_ref, dtype=jnp.float64, **kw)(
        {p: jnp.asarray(v) for p, v in x.items()})
    op = tmf.sipg_operator(tb, diffusion=k_port, dtype=torch.float64, **kw,
                           device=CPU)
    ty = op(convert.bucket_dict(x, device=CPU))
    assert_close(ry, ty)
    # the port's own assembled matvec: an independent route
    A = t_assemble(tb, diffusion=k_port, **kw, device=CPU)
    assert_close({p: v.numpy() for p, v in ty.items()},
                 tbm.matvec(A, convert.bucket_dict(x, device=CPU)))


@pytest.mark.parametrize("kind", [None, "scalar", "tensor"])
def test_sipg_operator_1d(kind):
    rb, tb = hanging_pair("1d")
    k_ref, k_port = DIFFUSION[kind]
    x = random_x(rb)
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
    ry = rmf.sipg_operator(rb, diffusion=k_ref, **kw)(
        {p: jnp.asarray(v) for p, v in x.items()})
    assert_close(ry, tmf.sipg_operator(tb, diffusion=k_port, **kw, device=CPU)(
        convert.bucket_dict(x, device=CPU)))


@pytest.mark.parametrize("kind", [None, "scalar", "tensor"])
def test_laplace_bulk_and_mass_operators(kind):
    rb, tb = hanging_pair("3d")
    k_ref, k_port = DIFFUSION[kind]
    x = random_x(rb, seed=11)
    rx = {p: jnp.asarray(v) for p, v in x.items()}
    tx = convert.bucket_dict(x, device=CPU)
    assert_close(rmf.laplace_bulk_operator(rb, diffusion=k_ref)(rx),
                 tmf.laplace_bulk_operator(tb, diffusion=k_port, device=CPU)(tx))
    if kind is None:
        assert_close(rmf.mass_operator(rb)(rx),
                     tmf.mass_operator(tb, device=CPU)(tx))


def test_naive_sipg_operator_matches_reference():
    rb, tb = hanging_pair("2d")
    x = random_x(rb, seed=2)
    kw = dict(penalty=2.5, dirichlet=True, dg_form="nipg", sigma1=0.2)
    assert_close(rmf.naive_sipg_operator(rb, **kw)(
        {p: jnp.asarray(v) for p, v in x.items()}),
        tmf.naive_sipg_operator(tb, **kw, device=CPU)(
            convert.bucket_dict(x, device=CPU)))


def test_sipg_operator_f32():
    """The f32 apply (the card's working type) against the reference's
    f64 apply: f32 roundoff only."""
    rb, tb = hanging_pair("3d")
    x = random_x(rb, seed=4)
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
    ry = rmf.sipg_operator(rb, dtype=jnp.float64, **kw)(
        {p: jnp.asarray(v) for p, v in x.items()})
    ty = tmf.sipg_operator(tb, dtype=torch.float32, **kw, device=CPU)(
        convert.bucket_dict(x, dtype=torch.float32, device=CPU))
    assert all(v.dtype == torch.float32 for v in ty.values())
    assert_close(ry, ty, tol=1e-5)


def test_entry_step_matches_uniform_stencil():
    """The entry step of __graft_entry__.entry() (sipg_operator,
    Dirichlet, penalty 2, "measure") equals the uniform stencil (K1's plain twin) on a full
    lattice: two routes to the same A u."""
    from hpdg_tpu_torch.matrixfree.uniform import uniform_sipg_operator
    p = 2
    m = tmesh.structured((3, 3, 3))
    basis = TBasis(m, np.full(m.n_elements, p))
    x = {p: torch.as_tensor(np.random.default_rng(1887).standard_normal(
        (m.n_elements, (p + 1) ** 3)))}
    y = tmf.sipg_operator(basis, penalty=2.0, dirichlet=True, device=CPU)(x)
    want = uniform_sipg_operator(basis, penalty=2.0, dirichlet=True,
                                 device=CPU)(x)
    assert_close({p: want[p].numpy()}, y)


def test_sipg_operator_matches_reference_assembly():
    """Port's sipg_operator against the reference's assembled matrix on
    a 3D hanging mesh (carried across with convert)."""
    rb, tb = hanging_pair("3d")
    RA = r_assemble(rb, penalty=2.0, dirichlet=True, dtype=jnp.float64)
    x = random_x(rb, seed=8)
    ry = rbm.matvec(RA, {p: jnp.asarray(v) for p, v in x.items()})
    assert_close(ry, tmf.sipg_operator(tb, penalty=2.0, dirichlet=True, device=CPU)(
        convert.bucket_dict(x, device=CPU)))
