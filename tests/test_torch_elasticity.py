"""Port vs reference: SIPG linear elasticity (BASELINE config 4), f64.

* ``assemble_elasticity`` on box meshes in 2D and 3D, uniform and mixed
  degrees, Dirichlet on and off, both penalty scalings: the pattern
  bitwise, every block at 1e-12 of max|A|;
* ``l2_functional_vec`` at 1e-13;
* the assembled matrix against the reference's dense oracle, and its
  symmetry;
* the blocks of elements that see the same faces are bitwise equal (what
  the class-deduplicated patch smoother verifies);
* meshes with first-class geometry are taken (the same matrix as the
  reference's); twisted face charts are refused, as in the reference.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble.elasticity import assemble_elasticity as r_elast
from hpdg_tpu.assemble.elasticity import l2_functional_vec as r_l2v
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.testing import oracle

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_elasticity as t_elast
from hpdg_tpu_torch.assemble import l2_functional_vec as t_l2v
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm

from test_torch_galerkin import assert_close, assert_same_pattern

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def pair(cells, degrees, upper=None):
    rm = rmesh.structured(cells, upper=upper)
    tm = tmesh.structured(cells, upper=upper)
    deg = np.broadcast_to(np.asarray(degrees), (rm.n_elements,)).copy()
    return RBasis(rm, deg), TBasis(tm, deg)


CASES = [  # cells, degrees, upper
    ((3, 2), 1, (1.5, 1.0)),
    ((3, 2), 2, (1.5, 1.0)),
    ((2, 2), [1, 2, 3, 2], None),
    ((2, 1, 1), [1, 2], None),
    ((2, 2, 2), 2, (1.0, 1.25, 0.75)),
]


@pytest.mark.parametrize("scaling", ["measure", "normal"])
@pytest.mark.parametrize("dirichlet", [False, True])
@pytest.mark.parametrize("cells,degrees,upper", CASES)
def test_assemble_elasticity_matches_reference(cells, degrees, upper,
                                               dirichlet, scaling):
    rb, tb = pair(cells, degrees, upper)
    kw = dict(mu=1.3, lam=0.7, penalty=3.0, dirichlet=dirichlet,
              penalty_scaling=scaling)
    RA = r_elast(rb, **kw)
    TA = t_elast(tb, **kw, device=CPU)
    d = len(cells)
    assert TA.block_shape == RA.block_shape == (d, d)
    assert_same_pattern(RA.pattern, TA.pattern)
    assert_close({k: np.asarray(v) for k, v in RA.values.items()},
                 TA.values, 1e-12)


@pytest.mark.parametrize("cells,degrees", [((3, 2), 2), ((2, 2), [1, 2, 3, 2]),
                                           ((2, 1, 1), [1, 2])])
def test_elasticity_matches_oracle(cells, degrees):
    rb, tb = pair(cells, degrees)
    kw = dict(mu=1.0, lam=2.0, penalty=1.5, dirichlet=True)
    Ad = tbm.to_dense(t_elast(tb, **kw, device=CPU), tb)
    Aref = oracle.elasticity_matrix(rb, **kw)
    assert np.linalg.norm(Ad - Aref) <= 1e-11 * np.linalg.norm(Aref)
    np.testing.assert_allclose(Ad, Ad.T, rtol=0, atol=1e-12 * np.abs(Ad).max())


@pytest.mark.parametrize("cells,degrees", [((3, 2), 2), ((2, 2), [1, 2, 3, 2]),
                                           ((2, 2, 2), 1)])
def test_l2_functional_vec_matches_reference(cells, degrees):
    rb, tb = pair(cells, degrees)
    d = len(cells)

    def force(x, lib):
        s = lib.sin(np.pi * x[..., 0]) * lib.cos(0.5 * np.pi * x[..., d - 1])
        return lib.stack([s * (c + 1) + x[..., c] for c in range(d)], -1)

    want = r_l2v(rb, lambda x: force(x, jnp))
    got = t_l2v(tb, lambda x: force(x, torch), device=CPU)
    assert_close({k: np.asarray(v) for k, v in want.items()}, got, 1e-13)


def test_equal_blocks_for_equal_surroundings():
    """Interior elements of a uniform lattice get bitwise equal diagonal
    blocks, and the face-coupling blocks of one axis are equal too."""
    tm = tmesh.structured((4, 4, 4))
    tb = TBasis(tm, np.full(tm.n_elements, 1))
    A = t_elast(tb, penalty=4.0, dirichlet=True, device=CPU)
    D = tbm.extract_diagonal(A)[1]
    interior = [21, 22, 25, 26, 37, 38, 41, 42]  # cells 1..2 on every axis
    for e in interior[1:]:
        assert torch.equal(D[e], D[interior[0]])
    rows, cols = A.pattern.entries[(1, 1)]
    off = np.flatnonzero(cols - rows == 1)  # +z neighbours
    vals = A.values[(1, 1)][torch.as_tensor(off)]
    assert torch.equal(vals, vals[:1].expand_as(vals))


def test_geometry_meshes_are_refused():
    """A mesh with first-class geometry is NOT refused: the same call
    assembles the reference's matrix.  What stays refused is a mesh with
    twisted face charts, as in the reference."""
    from hpdg_tpu.mesh import geometry as rgeo
    from hpdg_tpu_torch.mesh import geometry as tgeo
    shear = np.array([[1.0, 0.4], [0.1, 0.9]])
    rm = rgeo.affine_image(rmesh.structured((2, 2)), shear)
    tm = tgeo.affine_image(tmesh.structured((2, 2)), shear)
    rb, tb = RBasis(rm, np.full(4, 1)), TBasis(tm, np.full(4, 1))
    RA, TA = r_elast(rb), t_elast(tb, device=CPU)
    assert_same_pattern(RA.pattern, TA.pattern)
    assert_close(RA.values, TA.values, 1e-12)
    twisted = types.SimpleNamespace(**{f: getattr(tm, f) for f in (
        "dim", "lower", "extent", "bfaces", "jac", "shift", "corners")},
        n_elements=tm.n_elements,
        faces=types.SimpleNamespace(is_classic=False))
    with pytest.raises(NotImplementedError, match="twisted"):
        t_elast(TBasis(twisted, np.full(4, 1)), device=CPU)
