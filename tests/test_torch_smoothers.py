"""Port vs reference: the block and patch smoothers of the assembled
hp-multigrid, in f64.

* ``greedy_coloring``, ``build_vertex_patches`` and
  ``general_vertex_patches`` bitwise (uniform lattices and meshes with
  hanging faces);
* one step of colored block GS, lexicographic block GS (uniform and
  mixed degrees), Chebyshev, and the per-patch, class-deduplicated and
  general vertex-patch sweeps, forward and reverse, scalar and
  vector-valued: 1e-12 of max|x|;
* ``estimate_rho`` at 1e-12 (the same random start vector);
* the class check covers every member (the reference compares only the
  first and the last one of a class).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.solvers import patches as rpat
from hpdg_tpu.solvers import smoothers as rsm

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.solvers import patches as tpat
from hpdg_tpu_torch.solvers import smoothers as tsm

from test_torch_galerkin import assembled, assert_close, jx, rand_vec

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def bases(case):
    """(reference basis, port basis) of a named small problem."""
    if case.startswith("hanging"):
        cells, marks = {"hanging2d": ((3, 3), [0, 1, 0, 0, 1, 0, 0, 0, 0]),
                        "hanging3d": ((2, 2, 2), [1, 0, 0, 0, 0, 0, 0, 1])
                        }[case]
        marks = np.asarray(marks, bool)
        rm = radapt.refine_local(rmesh.structured(cells), marks)
        tm = tadapt.refine_local(tmesh.structured(cells), marks)
    else:
        cells = {"2d": (4, 3), "3d": (3, 3, 2), "3d4": (4, 4, 4)}[case]
        rm, tm = rmesh.structured(cells), tmesh.structured(cells)
    return rm, tm


def pair(case, degrees):
    rm, tm = bases(case)
    deg = degrees(rm.n_elements) if callable(degrees) \
        else np.full(rm.n_elements, degrees)
    return RBasis(rm, deg), TBasis(tm, deg)


def mixed(n):
    return np.random.default_rng(11).integers(1, 4, size=n)


def run_step(rstep, tstep, rb, ncomp, seed=3):
    x, b = rand_vec(rb, seed, ncomp), rand_vec(rb, seed + 1, ncomp)
    want = jax.jit(rstep)(jx(x), jx(b))
    xt = convert.bucket_dict(x, device=CPU)
    got = tstep(xt, convert.bucket_dict(b, device=CPU))
    assert_close(want, got, 1e-12)
    for p in x:  # the caller's x is not mutated
        np.testing.assert_array_equal(xt[p].numpy(), x[p])


@pytest.mark.parametrize("case", ["2d", "3d", "hanging2d", "hanging3d"])
def test_greedy_coloring_bitwise(case):
    rm, tm = bases(case)
    want = rsm.greedy_coloring(rm)
    got = tsm.greedy_coloring(tm)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    fi, fo = tm.faces.inside, tm.faces.outside
    assert (got[fi] != got[fo]).all()


@pytest.mark.parametrize("case", ["2d", "3d", "3d4"])
def test_build_vertex_patches_bitwise(case):
    rm, tm = bases(case)
    want, got = rpat.build_vertex_patches(rm), tpat.build_vertex_patches(tm)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["2d", "hanging2d", "hanging3d"])
def test_general_vertex_patches_bitwise(case):
    rm, tm = bases(case)
    want, got = rpat.general_vertex_patches(rm), tpat.general_vertex_patches(tm)
    assert [len(c) for c in want] == [len(c) for c in got]
    for cw, cg in zip(want, got):
        for w, g in zip(cw, cg):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind,case,degrees", [
    ("laplace", "hanging2d", mixed), ("laplace", "3d", 2),
    ("elast", "2d", 2), ("elast", "hanging3d", 1)])
def test_colored_block_gs_step(kind, case, degrees, reverse):
    rb, tb = pair(case, degrees)
    RA, TA = assembled(kind, rb)
    run_step(rsm.colored_block_gs_step(RA, rb, reverse=reverse),
             tsm.colored_block_gs_step(TA, tb, reverse=reverse),
             rb, RA.block_shape[0])


def test_richardson_composes_steps():
    rb, tb = pair("2d", 2)
    RA, TA = assembled("laplace", rb)
    run_step(rsm.richardson(rsm.block_jacobi_step(RA, omega=0.7), 3),
             tsm.richardson(tsm.block_jacobi_step(TA, omega=0.7), 3), rb, 1)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind,case,degrees", [
    ("laplace", "3d", 2), ("laplace", "hanging2d", mixed),
    ("laplace", "hanging3d", mixed), ("elast", "2d", 2)])
def test_lexicographic_block_gs_step(kind, case, degrees, reverse):
    rb, tb = pair(case, degrees)
    RA, TA = assembled(kind, rb)
    run_step(rsm.lexicographic_block_gs_step(RA, rb, reverse=reverse),
             tsm.lexicographic_block_gs_step(TA, tb, reverse=reverse),
             rb, RA.block_shape[0])


@pytest.mark.parametrize("kind,degrees", [("laplace", mixed), ("elast", 2)])
def test_estimate_rho_and_chebyshev(kind, degrees):
    rb, tb = pair("2d", degrees)
    RA, TA = assembled(kind, rb)
    ncomp = RA.block_shape[0]
    rD, tD = rsm.inverse_diagonal_blocks(RA), tsm.inverse_diagonal_blocks(TA)
    rpc = lambda r: rsm.apply_blockdiag(rD, r)  # noqa: E731
    tpc = lambda r: tsm.apply_blockdiag(tD, r)  # noqa: E731
    rop = lambda x: rbm.matvec(RA, x)  # noqa: E731
    top = lambda x: tbm.matvec(TA, x)  # noqa: E731
    x = jx(rand_vec(rb, 0, ncomp))
    rho_r = rsm.estimate_rho(rop, rpc, x)
    rho_t = tsm.estimate_rho(top, tpc, convert.bucket_dict(
        {p: np.asarray(v) for p, v in x.items()}, device=CPU))
    assert abs(rho_t - rho_r) <= 1e-12 * rho_r
    run_step(rsm.chebyshev_smoother(rop, rpc, lmax=1.05 * rho_r, degree=4),
             tsm.chebyshev_smoother(top, tpc, lmax=1.05 * rho_t, degree=4),
             rb, ncomp)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind,case,degrees", [
    ("laplace", "3d", 1), ("laplace", "2d", 2), ("elast", "2d", 1),
    ("elast", "3d", 1)])
def test_patch_smoother_steps(kind, case, degrees, reverse):
    """Per-patch inverses and class-deduplicated inverses: both against
    the reference's sweeps."""
    rb, tb = pair(case, degrees)
    RA, TA = assembled(kind, rb)
    ncomp = RA.block_shape[0]
    run_step(rpat.patch_smoother_step(RA, rb, reverse=reverse, damping=0.9),
             tpat.patch_smoother_step(TA, tb, reverse=reverse, damping=0.9),
             rb, ncomp)
    run_step(rpat.class_patch_smoother_step(RA, rb, reverse=reverse),
             tpat.class_patch_smoother_step(TA, tb, reverse=reverse),
             rb, ncomp)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind,case,degrees", [
    ("laplace", "hanging2d", mixed), ("laplace", "hanging3d", 1),
    ("elast", "hanging2d", 1)])
def test_general_patch_smoother_step(kind, case, degrees, reverse):
    rb, tb = pair(case, degrees)
    RA, TA = assembled(kind, rb)
    run_step(rpat.general_patch_smoother_step(RA, rb, reverse=reverse),
             tpat.general_patch_smoother_step(TA, tb, reverse=reverse),
             rb, RA.block_shape[0])


def test_class_check_covers_every_member():
    """A lattice whose patch operators differ only at a middle member of
    the interior class: the reference (first and last member only) takes
    the class inverse, the port refuses."""
    rm, tm = rmesh.structured((6, 6)), tmesh.structured((6, 6))
    rb, tb = RBasis(rm, np.full(36, 1)), TBasis(tm, np.full(36, 1))
    RA, TA = assembled("laplace", rb)
    # cell (2, 3): in the patches of vertices (1..2, 2..3), all interior,
    # none the first (1, 1) or last (3, 3) member of the class
    e = 2 * 6 + 3
    vals = {k: np.asarray(v).copy() for k, v in RA.values.items()}
    vals[(1, 1)][e] *= 1.5
    RA2 = rbm.BlockSparseMatrix(RA.pattern, RA.dim,
                                {k: jnp.asarray(v) for k, v in vals.items()},
                                RA.block_shape)
    TA2 = tbm.BlockSparseMatrix(TA.pattern, TA.dim,
                                convert.bucket_dict(vals, device=CPU),
                                TA.block_shape)
    rpat.class_patch_smoother_step(RA2, rb)  # the reference accepts it
    with pytest.raises(ValueError, match="translation"):
        tpat.class_patch_smoother_step(TA2, tb)
    tpat.class_patch_smoother_step(TA, tb)  # the unperturbed matrix passes
