"""Port vs reference: the uniform-lattice SIPG operators and K1's wrapper.

* the plain stencil (K1's twin) against hpdg_tpu's
  ``uniform_sipg_operator`` and the assembled ``bm.matvec``, 1e-12 in f64;
* the factorized form against hpdg_tpu's, 1e-12 in f64;
* one interpret-mode case of the Pallas kernel itself, f32, 1e-5 of
  max|y| (the two f32 sums run in another order);
* K1's launch tables (tiles and their order, per-variant product lists,
  the padded stored matrices, the instantiation) replayed in numpy to
  1e-13, which checks everything of the kernel but its arithmetic on
  the CPU;
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

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


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
    y = tuni.uniform_sipg_operator(tb, dtype=torch.float64, **kw, device=CPU)(
        convert.bucket_dict(x, device=CPU))[p].numpy()
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
    y = tuni.uniform_sipg_factorized(tb, dtype=torch.float64, **kw, device=CPU)(
        convert.bucket_dict(x, device=CPU))[p].numpy()
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
                                     penalty_scaling="normal", device=CPU)
    y = op(convert.bucket_dict(x, device=CPU))[2]
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - yref).max() < 1e-5 * np.abs(yref).max()


def _replay_kernel(op, u):
    """K1's launch tables in numpy: every tile runs its variant's products
    (stored matrix, element shift) as one GEMM over the zero-padded
    stored matrices, K chunk by K chunk as the GEMM instantiations stream
    it (the small ones take K = bs, one chunk)."""
    st = op.tables
    kp = us.kernel_plan(op.basis, st)
    mats = us.stored_matrices(st, kp)
    assert mats.shape == (len(st.variants) + 2 * st.dim, kp.k, kp.n)
    assert not mats[:, st.bs:].any() and not mats[:, :, st.bs:].any()
    kc = 32 if kp.instantiation in ("gemm125", "generic") else kp.k
    y = np.full_like(u, np.nan)
    order = []
    for vid, start, count in kp.tiles:
        assert 0 < count <= kp.tile
        e = kp.elems[start:start + count]
        assert (st.vid[e] == vid).all()
        acc = np.zeros((count, kp.n))
        for q in range(kp.prod_count[vid]):
            src = np.zeros((count, kp.k))  # u rows, K padded with zeros
            src[:, :st.bs] = u[e + kp.prod_shift[vid, q]]
            for k0 in range(0, kp.k, kc):
                acc += src[:, k0:k0 + kc] @ mats[kp.prod_mat[vid, q], k0:k0 + kc]
        order.append(us.tile_order(kp.prod_count[vid], count))
        assert np.isnan(y[e]).all(), "an element sits in two tiles"
        y[e] = acc[:, :st.bs]
    assert not np.isnan(y).any(), "an element sits in no tile"
    assert order == sorted(order)  # short tiles, then the costliest
    return y


@pytest.mark.parametrize("cells,p", SHAPES + [((6, 6, 6), 1), ((12, 4, 5), 2),
                                             ((32, 5, 7), 1), ((9, 4, 4), 4),
                                             ((3, 4, 5), 3)])
@pytest.mark.parametrize("dirichlet", [True, False])
def test_kernel_launch_tables_replay_the_operator(cells, p, dirichlet):
    _, tb = _pair(cells, p)
    op = us.UniformStencilOperator(tb, 2.0, dirichlet, "normal", device=CPU)
    x = _rand(tb, p, seed=4)
    want = op(convert.bucket_dict(x, device=CPU))[p].numpy()
    got = _replay_kernel(op, x[p])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    assert op.launches == 0  # CPU tensors never reach the kernel


def test_kernel_plan_product_lists():
    # 3x3x3 at p=1: 27 variants; the centre has all 7 products, a corner 4
    _, tb = _pair((3, 3, 3), 1)
    st = tuni.stencil_tables(tb, 2.0, True)
    kp = us.kernel_plan(tb, st)
    assert kp.instantiation == "small8" and kp.strides == (9, 3, 1)
    centre = st.vid[13]
    assert kp.prod_count[centre] == 7
    assert list(kp.prod_mat[centre]) == [centre] + list(range(27, 33))
    assert list(kp.prod_shift[centre]) == [0, 9, -9, 3, -3, 1, -1]
    assert kp.prod_count[st.vid[0]] == 4  # (0,0,0): +ax neighbours only
    assert list(kp.prod_shift[st.vid[0], :4]) == [0, 9, 3, 1]
    assert kp.tiles[0, 0] == centre  # every tile is short; 7 products first
    _, tb = _pair((12, 12, 12), 4)
    kp = us.kernel_plan(tb, tuni.stencil_tables(tb, 2.0, True))
    # short tiles first: 12 edges of 10 (5 products), 8 corners (4); then
    # the 10^3 interior elements (7 full tiles and one of 104, 7 products
    # x 4 warp rows) and 6 faces of 100 (6 x 4)
    assert kp.instantiation == "gemm125" and kp.tile == 128
    assert list(kp.tiles[:, 2]) == ([10] * 12 + [1] * 8 + [128] * 7
                                    + [104] + [100] * 6)


def test_kernel_plan_refuses_non_lattice_order():
    m = tmesh.structured((3, 2, 2))
    perm = np.random.default_rng(0).permutation(m.n_elements)
    mp = tmesh.from_boxes(m.lower[perm], m.extent[perm])
    basis = TBasis(mp, np.full(mp.n_elements, 1))
    st = tuni.stencil_tables(basis, 2.0, True)
    with pytest.raises(ValueError, match="C-lattice"):
        us.kernel_plan(basis, st)


def test_tile_size_fits_kernel_layout():
    # bs = 125 and every other bs <= 128: GEMM tiles of 128 elements,
    # matrices padded to K = multiple of 32 and N = 128; bs = 27 and 8:
    # one thread per element, 128 per tile, rows padded to 4 floats
    assert [us.kernel_layout(bs) for bs in (125, 27, 8, 64, 25, 1, 128)] == [
        ("gemm125", 128, 128, 128), ("small27", 128, 27, 28),
        ("small8", 128, 8, 8), ("generic", 128, 64, 128),
        ("generic", 128, 32, 128), ("generic", 128, 32, 128),
        ("generic", 128, 128, 128)]
    _, tb = _pair((2, 2), 11)  # bs = 144 > 128
    with pytest.raises(ValueError, match="block size"):
        us.kernel_plan(tb, tuni.stencil_tables(tb, 2.0, True))


def test_wrapper_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    _, tb = _pair((2, 2, 2), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        us.uniform_stencil_operator(tb, device="cuda")

