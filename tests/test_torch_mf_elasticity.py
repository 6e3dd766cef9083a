"""Port vs reference: the matrix-free SIPG elasticity apply, in f64.

``elasticity_operator`` at 1e-12 of max|y| against the reference's
apply AND against the port's own assembled matvec (the same operator by
an independent route), in 2D and 3D, uniform and mixed degrees, a
``refine_local`` mesh with hanging faces, Dirichlet on and off, both
penalty scalings and ``include_bulk=False``; the f32 apply at 1e-5;
``elasticity_diagonal_blocks``; a mesh with geometry is taken, twisted
charts and a missing card without ``device="cpu"`` are refused.
"""

import types

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.matrixfree.elasticity import \
    elasticity_diagonal_blocks as r_diag
from hpdg_tpu.matrixfree.elasticity import elasticity_operator as r_op
from hpdg_tpu.mesh.adaptive import refine_local as r_refine_local

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_elasticity as t_elast
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.matrixfree.elasticity import \
    elasticity_diagonal_blocks as t_diag
from hpdg_tpu_torch.matrixfree.elasticity import elasticity_operator as t_op
from hpdg_tpu_torch.mesh.adaptive import refine_local as t_refine_local

from test_torch_galerkin import assert_close, jx, rand_vec

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def pair(case):
    """(reference basis, port basis) on the same mesh and degrees."""
    if case == "hanging":
        marks = np.asarray([0, 1, 1, 0], bool)
        rm = r_refine_local(rmesh.structured((2, 2)), marks)
        tm = t_refine_local(tmesh.structured((2, 2)), marks)
        deg = np.random.default_rng(1887).integers(1, 4, size=rm.n_elements)
        return RBasis(rm, deg), TBasis(tm, deg)
    cells, degrees, upper = {
        "2d": ((3, 2), 2, (1.5, 1.0)),
        "2d-mixed": ((2, 2), [1, 2, 3, 2], None),
        "3d-mixed": ((2, 1, 1), [1, 2], None),
        "3d": ((2, 2, 2), 2, (1.0, 1.25, 0.75)),
    }[case]
    rm = rmesh.structured(cells, upper=upper)
    tm = tmesh.structured(cells, upper=upper)
    deg = np.broadcast_to(np.asarray(degrees), (rm.n_elements,)).copy()
    return RBasis(rm, deg), TBasis(tm, deg)


VARIANTS = [  # dirichlet, scaling, include_bulk
    (True, "measure", True),
    (False, "normal", True),
    (True, "normal", False),
]


@pytest.mark.parametrize("dirichlet,scaling,include_bulk", VARIANTS)
@pytest.mark.parametrize("case", ["2d", "2d-mixed", "3d-mixed", "3d",
                                  "hanging"])
def test_elasticity_operator_matches_reference(case, dirichlet, scaling,
                                               include_bulk):
    rb, tb = pair(case)
    d = rb.dim
    kw = dict(mu=1.3, lam=0.7, penalty=4.0, dirichlet=dirichlet,
              penalty_scaling=scaling, include_bulk=include_bulk)
    x = rand_vec(rb, 3, ncomp=d)
    want = jax.jit(r_op(rb, **kw))(jx(x))
    got = t_op(tb, **kw, device=CPU)(convert.bucket_dict(x, device=CPU))
    assert_close(want, got, 1e-12)


@pytest.mark.parametrize("dirichlet,scaling", [(True, "measure"),
                                               (False, "normal")])
@pytest.mark.parametrize("case", ["2d-mixed", "3d", "hanging"])
def test_elasticity_operator_matches_assembled(case, dirichlet, scaling):
    _, tb = pair(case)
    kw = dict(mu=1.0, lam=2.0, penalty=5.0, dirichlet=dirichlet,
              penalty_scaling=scaling)
    x = convert.bucket_dict(rand_vec(tb, 4, ncomp=tb.dim), device=CPU)
    want = tbm.matvec(t_elast(tb, **kw, device=CPU), x)
    got = t_op(tb, **kw, device=CPU)(x)
    assert_close({k: v.numpy() for k, v in want.items()}, got, 1e-12)
    # the f32 apply against the f64 one
    op32 = t_op(tb, **kw, dtype=torch.float32, device=CPU)
    y32 = op32({k: v.float() for k, v in x.items()})
    assert all(v.dtype == torch.float32 for v in y32.values())
    assert_close({k: v.numpy() for k, v in got.items()}, y32, 1e-5)


@pytest.mark.parametrize("case", ["2d-mixed", "3d"])
def test_elasticity_diagonal_blocks_match_reference(case):
    rb, tb = pair(case)
    kw = dict(mu=1.1, lam=0.9, dirichlet=True)
    want = r_diag(rb, **kw)
    got = t_diag(tb, **kw, device=CPU)
    assert_close({k: np.asarray(v) for k, v in want.items()}, got, 1e-12)


def test_refusals():
    """A mesh with first-class geometry is taken (the reference's
    apply); twisted face charts are refused, as in the reference."""
    from hpdg_tpu.mesh import geometry as rgeo
    from hpdg_tpu_torch.mesh import geometry as tgeo
    tm = tmesh.structured((2, 2))
    shear = np.array([[1.0, 0.4], [0.1, 0.9]])
    rb = RBasis(rgeo.affine_image(rmesh.structured((2, 2)), shear),
                np.full(4, 1))
    tb = TBasis(tgeo.affine_image(tm, shear), np.full(4, 1))
    x = rand_vec(rb, 3, ncomp=2)
    assert_close(r_op(rb, dirichlet=True)(jx(x)),
                 t_op(tb, dirichlet=True, device=CPU)(
                     convert.bucket_dict(x, device=CPU)), 1e-12)
    twisted = types.SimpleNamespace(**{f: getattr(tm, f) for f in (
        "dim", "lower", "extent", "bfaces")}, n_elements=tm.n_elements,
        faces=types.SimpleNamespace(is_classic=False))
    with pytest.raises(NotImplementedError, match="twisted"):
        t_op(TBasis(twisted, np.full(4, 1)), device=CPU)
    if not torch.cuda.is_available():
        # the entry point runs on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="device"):
            t_op(TBasis(tm, np.full(4, 1)))
