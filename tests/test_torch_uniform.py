"""Port vs reference: the uniform-lattice SIPG operators and K1's wrapper.

* the plain stencil (K1's twin) against hpdg_tpu's
  ``uniform_sipg_operator`` and the assembled ``bm.matvec``, 1e-12 in f64;
* the factorized form against hpdg_tpu's, 1e-12 in f64;
* one interpret-mode case of the Pallas kernel itself, f32, 1e-5 of
  max|y| (the two f32 sums run in another order);
* K1's launch tables (tiles, variant masks, strides) replayed in numpy,
  which checks everything of the kernel but its arithmetic on the CPU;
* the wrapper's dispatch: plain twin for CPU tensors, a CUDA request
  refused without a card (the kernel itself on a card:
  tests/test_torch_kernel_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_assemble
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.matrixfree import uniform as runi
from hpdg_tpu.ops.pallas_uniform import pallas_uniform_sipg_operator

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.matrixfree import uniform as tuni
from hpdg_tpu_torch.ops import uniform_stencil as us


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the tests run in several worker processes on one machine: one
    # thread each for torch and numpy's BLAS keeps them from
    # oversubscribing its cores
    with threadpool_limits(1):
        yield


SHAPES = [((4, 2, 3), 2), ((3, 3, 3), 1), ((1, 3, 2), 2), ((2, 2, 2), 4),
          ((5, 3), 4)]
# each new shape costs the reference a round of XLA compiles: the
# differential tests take a subset (3D p=1 and p=4 stay covered here and
# by the kernel replay below, and by test_torch_multigrid against hpdg_tpu)
PLAIN_SHAPES = [s for s in SHAPES if s != ((3, 3, 3), 1)]
FACT_SHAPES = [s for s in SHAPES if s not in (((3, 3, 3), 1), ((2, 2, 2), 4))]


def _pair(cells, p, upper=None):
    n = int(np.prod(cells))
    return (RBasis(rmesh.structured(cells, upper=upper), np.full(n, p)),
            TBasis(tmesh.structured(cells, upper=upper), np.full(n, p)))


def _rand(basis, p, seed=0):
    rng = np.random.default_rng(seed)
    return {p: rng.standard_normal((basis.mesh.n_elements, basis.n_local(p)))}


@pytest.mark.parametrize("cells,p", PLAIN_SHAPES)
@pytest.mark.parametrize("scaling", ["measure", "normal"])
@pytest.mark.parametrize("dirichlet", [True, False])
def test_plain_stencil_matches_reference(cells, p, scaling, dirichlet):
    rb, tb = _pair(cells, p, upper=(1.0, 0.5, 2.0)[:len(cells)])
    kw = dict(penalty=2.0, dirichlet=dirichlet, penalty_scaling=scaling)
    x = _rand(rb, p)
    yref = np.asarray(runi.uniform_sipg_operator(rb, dtype=jnp.float64, **kw)(
        {p: jnp.asarray(x[p])})[p])
    yasm = np.asarray(rbm.matvec(r_assemble(rb, dtype=jnp.float64, **kw),
                                 {p: jnp.asarray(x[p])})[p])
    y = tuni.uniform_sipg_operator(tb, dtype=torch.float64, **kw)(
        convert.bucket_dict(x))[p].numpy()
    scale = np.abs(yasm).max()
    np.testing.assert_allclose(y, yref, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(y, yasm, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("cells,p", FACT_SHAPES)
@pytest.mark.parametrize("scaling", ["measure", "normal"])
@pytest.mark.parametrize("dirichlet", [True, False])
def test_factorized_matches_reference(cells, p, scaling, dirichlet):
    rb, tb = _pair(cells, p)
    kw = dict(penalty=2.0, dirichlet=dirichlet, penalty_scaling=scaling)
    x = _rand(rb, p, seed=1)
    yref = np.asarray(runi.uniform_sipg_factorized(rb, dtype=jnp.float64, **kw)(
        {p: jnp.asarray(x[p])})[p])
    y = tuni.uniform_sipg_factorized(tb, dtype=torch.float64, **kw)(
        convert.bucket_dict(x))[p].numpy()
    np.testing.assert_allclose(y, yref, rtol=0, atol=1e-12 * np.abs(yref).max())


def test_wrapper_matches_pallas_kernel_interpret():
    """The port's stencil (plain twin path, f32) against the Pallas
    kernel run in interpret mode, "normal" scaling on an anisotropic
    (4, 2, 4) lattice at p=2."""
    rb, tb = _pair((4, 2, 4), 2)
    x = {2: _rand(rb, 2, seed=2)[2].astype(np.float32)}
    pal = pallas_uniform_sipg_operator(rb, penalty=2.0, dirichlet=True,
                                       interpret=True,
                                       penalty_scaling="normal")
    yref = np.asarray(pal({2: jnp.asarray(x[2])})[2])
    op = us.uniform_stencil_operator(tb, penalty=2.0, dirichlet=True,
                                     penalty_scaling="normal")
    y = op(convert.bucket_dict(x))[2]
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - yref).max() < 1e-5 * np.abs(yref).max()


def _replay_kernel(op, u):
    """K1's tile schedule in numpy: every tile applies its variant's
    diagonal block and the neighbour couplings its mask names, at the
    element strides."""
    st = op.tables
    kp = us.kernel_plan(op.basis, st)
    y = np.full_like(u, np.nan)
    te = us.tile_elems(st.bs)
    for vid, start, count in kp.tiles:
        assert 0 < count <= te
        e = kp.elems[start:start + count]
        acc = u[e] @ st.Tdiag[vid].T
        for ax in range(st.dim):
            if (kp.var_mask[vid] >> (2 * ax)) & 1:
                acc += u[e + kp.strides[ax]] @ st.M12[ax].T
            if (kp.var_mask[vid] >> (2 * ax + 1)) & 1:
                acc += u[e - kp.strides[ax]] @ st.M21[ax].T
        assert np.isnan(y[e]).all(), "an element sits in two tiles"
        y[e] = acc
    assert not np.isnan(y).any(), "an element sits in no tile"
    return y


@pytest.mark.parametrize("cells,p", SHAPES + [((6, 6, 6), 1), ((12, 4, 5), 2)])
@pytest.mark.parametrize("dirichlet", [True, False])
def test_kernel_launch_tables_replay_the_operator(cells, p, dirichlet):
    _, tb = _pair(cells, p)
    op = us.UniformStencilOperator(tb, 2.0, dirichlet, "normal")
    x = _rand(tb, p, seed=4)
    want = op(convert.bucket_dict(x))[p].numpy()
    got = _replay_kernel(op, x[p])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    assert op.launches == 0  # CPU tensors never reach the kernel


def test_kernel_plan_refuses_non_lattice_order():
    m = tmesh.structured((3, 2, 2))
    perm = np.random.default_rng(0).permutation(m.n_elements)
    mp = tmesh.from_boxes(m.lower[perm], m.extent[perm])
    basis = TBasis(mp, np.full(mp.n_elements, 1))
    st = tuni.stencil_tables(basis, 2.0, True)
    with pytest.raises(ValueError, match="C-lattice"):
        us.kernel_plan(basis, st)


def test_tile_size_fits_kernel_layout():
    # the kernel's 256 threads hold 4x4 register tiles; block size <= 128
    assert [us.tile_elems(bs) for bs in (8, 27, 125, 9, 25)] == \
        [512, 144, 32, 340, 144]
    _, tb = _pair((2, 2), 11)  # bs = 144 > 128
    with pytest.raises(ValueError, match="block size"):
        us.kernel_plan(tb, tuni.stencil_tables(tb, 2.0, True))


def test_wrapper_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    _, tb = _pair((2, 2, 2), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        us.uniform_stencil_operator(tb, device="cuda")

