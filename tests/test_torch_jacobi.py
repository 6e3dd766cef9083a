"""Port vs reference: the matrix-free block-Jacobi drivers and the
diagonal-block factories (``matrixfree.jacobi``), in f64 at 1e-12 of
the largest entry.

* mass, heat, weighted mass and weighted heat blocks (a mass weight, a
  scalar diffusion, Dirichlet on and off, both penalty scalings) in 2D
  and 3D, uniform and mixed degrees;
* the identity and block-diagonal operators;
* the batched projected scalar GS (bounds with ±inf);
* three steps of matrix-free projected block Jacobi and two of the
  nonlinear block Jacobi with an exact local solver;
* meshes with geometry are taken (affine and trilinear: the
  reference's blocks), and a CPU-only call without ``device="cpu"``
  raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.matrixfree import jacobi as rj

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.matrixfree import jacobi as tj

from test_torch_galerkin import assert_close, jx, rand_vec, to_port

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def pair(cells, degrees):
    rm, tm = rmesh.structured(cells), tmesh.structured(cells)
    deg = np.broadcast_to(np.asarray(degrees), (rm.n_elements,)).copy()
    return RBasis(rm, deg), TBasis(tm, deg)


def npd(d):
    return {k: np.asarray(v) for k, v in d.items()}


def tt(x):
    return convert.bucket_dict(x, device=CPU)


# the same coefficient formulas, once per package (plain arithmetic)
def weight(x):
    return 1.0 + x[..., 0] ** 2 + 0.5 * x[..., -1]


def diffusion(x):
    return 2.0 + x[..., 0] * x[..., -1]


CASES = [((3, 2), 2), ((2, 2), [1, 2, 3, 2]), ((2, 1, 1), [1, 2]),
         ((2, 2, 2), 1)]


@pytest.mark.parametrize("cells,degrees", CASES)
def test_mass_and_heat_blocks_match_reference(cells, degrees):
    rb, tb = pair(cells, degrees)
    assert_close(npd(rj.mass_diagonal_blocks(rb)),
                 tj.mass_diagonal_blocks(tb, device=CPU), 1e-12)
    kw = dict(penalty=3.0, mass_coef=0.7, dirichlet=True)
    assert_close(npd(rj.heat_diagonal_blocks(rb, **kw)),
                 tj.heat_diagonal_blocks(tb, **kw, device=CPU), 1e-12)


@pytest.mark.parametrize("dirichlet,scaling", [(True, "measure"),
                                               (False, "normal")])
@pytest.mark.parametrize("cells,degrees", CASES[1:3])
def test_weighted_blocks_match_reference(cells, degrees, dirichlet,
                                         scaling):
    rb, tb = pair(cells, degrees)
    assert_close(npd(rj.weighted_mass_diagonal_blocks(rb, weight)),
                 tj.weighted_mass_diagonal_blocks(tb, weight, device=CPU),
                 1e-12)
    kw = dict(weight=weight, diffusion=diffusion, penalty=2.5,
              mass_coef=1.5, dirichlet=dirichlet, penalty_scaling=scaling)
    assert_close(npd(rj.weighted_heat_diagonal_blocks(rb, **kw)),
                 tj.weighted_heat_diagonal_blocks(tb, **kw, device=CPU),
                 1e-12)
    # no weight: the plain mass blocks under the diffusion's stiffness
    kw["weight"] = None
    assert_close(npd(rj.weighted_heat_diagonal_blocks(rb, **kw)),
                 tj.weighted_heat_diagonal_blocks(tb, **kw, device=CPU),
                 1e-12)


def test_identity_and_blockdiag_operators():
    rng = np.random.default_rng(2)
    blocks = {1: rng.standard_normal((5, 4, 4)), 2: rng.standard_normal(
        (3, 9, 9))}
    x = {1: rng.standard_normal((5, 4)), 2: rng.standard_normal((3, 9))}
    assert all(torch.equal(v, tt(x)[k])
               for k, v in tj.identity_operator()(tt(x)).items())
    assert_close(rj.blockdiag_operator(jx(blocks))(jx(x)),
                 tj.blockdiag_operator(tt(blocks))(tt(x)), 1e-12)


def spd_blocks(rng, n, bs):
    G = rng.standard_normal((n, bs, bs))
    return G @ G.transpose(0, 2, 1) + bs * np.eye(bs)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_local_projected_gs_matches_reference(sweeps):
    rng = np.random.default_rng(sweeps)
    n, bs = 6, 9
    Dm = spd_blocks(rng, n, bs)
    r = rng.standard_normal((n, bs)) * 4
    x0 = rng.standard_normal((n, bs)) * 0.1
    lo = np.where(rng.random((n, bs)) < 0.3, -np.inf, -0.2)
    up = np.where(rng.random((n, bs)) < 0.5, np.inf, 0.25)
    want = rj.local_projected_gs(*map(jnp.asarray, (Dm, r, x0, lo, up)),
                                 sweeps=sweeps)
    args = [torch.as_tensor(a) for a in (Dm, r, x0, lo, up)]
    got = tj.local_projected_gs(*args, sweeps=sweeps)
    assert_close({0: np.asarray(want)}, {0: got}, 1e-12)
    assert torch.equal(args[2], torch.as_tensor(x0))  # x0 untouched
    assert bool(((got >= args[3]) & (got <= args[4])).all())


@pytest.mark.parametrize("cells,degrees", CASES[:3])
def test_matrix_free_jacobi_drivers_match_reference(cells, degrees):
    rb, tb = pair(cells, degrees)
    RA = r_laplace(rb, penalty=3.0, dirichlet=True)
    TA = to_port(RA)
    D = npd(rbm.extract_diagonal(RA))
    rng = np.random.default_rng(9)
    b = rand_vec(rb, 1)
    lo = {p: np.where(rng.random(v.shape) < 0.2, -np.inf, -0.05)
          for p, v in b.items()}
    up = {p: np.full(v.shape, np.inf) for p, v in b.items()}
    x0 = {p: np.zeros_like(v) for p, v in b.items()}
    rstep = jax.jit(rj.matrix_free_block_projected_jacobi(
        lambda v: rbm.matvec(RA, v), jx(D), jx(lo), jx(up), omega=0.8))
    tstep = tj.matrix_free_block_projected_jacobi(
        lambda v: tbm.matvec(TA, v), tt(D), tt(lo), tt(up), omega=0.8)
    xr, xt = jx(x0), tt(x0)
    for _ in range(3):
        xr, xt = rstep(xr, jx(b)), tstep(xt, tt(b))
        assert_close(xr, xt, 1e-12)
    rstep = jax.jit(rj.matrix_free_block_nonlinear_jacobi(
        lambda v: rbm.matvec(RA, v), jx(D),
        lambda Dm, r, x: jnp.linalg.solve(Dm, r[..., None])[..., 0],
        omega=0.7))
    tstep = tj.matrix_free_block_nonlinear_jacobi(
        lambda v: tbm.matvec(TA, v), tt(D),
        lambda Dm, r, x: torch.linalg.solve(Dm, r), omega=0.7)
    for _ in range(2):
        xr, xt = rstep(xr, jx(b)), tstep(xt, tt(b))
        assert_close(xr, xt, 1e-12)


def test_geometry_meshes_are_refused():
    """Meshes with first-class geometry are NOT refused: affine maps
    scale the mass blocks by |det A|, trilinear ones integrate the
    per-point |det J|, as the reference does."""
    from hpdg_tpu.mesh import geometry as rgeo
    from hpdg_tpu_torch.mesh import geometry as tgeo
    tm = tmesh.structured((2, 2))
    shear = np.array([[1.0, 0.4], [0.1, 0.9]])
    bend = lambda x: x + 0.1 * np.sin(3.0 * x[..., ::-1])  # noqa: E731
    pairs = [(rgeo.affine_image(rmesh.structured((2, 2)), shear),
              tgeo.affine_image(tm, shear)),
             (rgeo.isoparametric(rmesh.structured((2, 2)), bend),
              tgeo.isoparametric(tm, bend))]
    for rg, tg in pairs:
        rb, tb = RBasis(rg, np.full(4, 2)), TBasis(tg, np.full(4, 2))
        assert_close(npd(rj.mass_diagonal_blocks(rb)),
                     tj.mass_diagonal_blocks(tb, device=CPU), 1e-12)
        assert_close(npd(rj.weighted_mass_diagonal_blocks(rb, weight)),
                     tj.weighted_mass_diagonal_blocks(tb, weight,
                                                      device=CPU), 1e-12)
        assert_close(npd(rj.heat_diagonal_blocks(rb, dirichlet=True)),
                     tj.heat_diagonal_blocks(tb, dirichlet=True,
                                             device=CPU), 1e-12)
    if not torch.cuda.is_available():
        # the factories run on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="device"):
            tj.mass_diagonal_blocks(TBasis(tm, np.full(4, 1)))
