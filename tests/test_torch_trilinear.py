"""Port vs reference: TRILINEAR (isoparametric Q1) element geometry, f64.

* ``isoparametric`` and ``from_quad_lattice`` / ``from_hex_lattice`` on
  curved cells: meshes bitwise, the Q1 primitives and per-point queries
  at 1e-14, ``refine`` / ``refine_local`` (hanging faces) / ``unrefine``
  / ``semicoarsen`` restrict and merge ``corners`` bitwise;
* assembled SIPG matrices against the reference (1e-12) and the
  independent dense oracle (1e-11), the sum-factorized apply, diagonal,
  mass and heat blocks, with hanging faces and variable media;
* elasticity by both routes (assembled against reference and oracle,
  matrix-free against reference and assembled), its geometry tables and
  the vector load;
* ``ipdg_local_norm``, ``l2_error``, ``h1_seminorm_error``.

The solver stack on these meshes is held in
``test_torch_trilinear_solvers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.assemble.elasticity import assemble_elasticity as r_elast
from hpdg_tpu.assemble.elasticity import l2_functional_vec as r_l2v
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.estimators import error as rerr
from hpdg_tpu.matrixfree import elasticity as rmfe
from hpdg_tpu.matrixfree import jacobi as rj
from hpdg_tpu.matrixfree import norms as rnorms
from hpdg_tpu.matrixfree.diagonal import sipg_diagonal_blocks as r_diag
from hpdg_tpu.matrixfree.sumfact import (mass_operator as r_massop,
                                         sipg_operator as r_sipg)
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.testing import oracle

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_elasticity as t_elast
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble import l2_functional_vec as t_l2v
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.estimators import error as terr
from hpdg_tpu_torch.examples import meshes
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.matrixfree import elasticity as tmfe
from hpdg_tpu_torch.matrixfree import jacobi as tj
from hpdg_tpu_torch.matrixfree import norms as tnorms
from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks as t_diag
from hpdg_tpu_torch.matrixfree.sumfact import (mass_operator as t_massop,
                                               sipg_operator as t_sipg)
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.mesh import geometry as tgeo

from test_torch_galerkin import (assert_close, assert_same_pattern, jx,
                                 rand_vec)
from test_torch_geometry import (SHEAR2, assert_same_mesh, k_scalar, k_tensor,
                                 port_mesh)

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def wavy2(x):
    x = np.asarray(x, np.float64)
    return np.stack([x[..., 0] + 0.08 * np.sin(np.pi * x[..., 0])
                     * np.sin(np.pi * x[..., 1]),
                     x[..., 1] - 0.06 * np.sin(np.pi * x[..., 0] * 0.7)
                     * np.cos(np.pi * x[..., 1] * 0.5)], -1)


def wavy3(x):
    x = np.asarray(x, np.float64)
    s = np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
    return np.stack([x[..., 0] + 0.06 * np.sin(np.pi * x[..., 1] * 0.8),
                     x[..., 1] + 0.05 * s,
                     x[..., 2] + 0.07 * np.sin(np.pi * x[..., 2] * 0.6)
                     * np.cos(np.pi * x[..., 0])], -1)


annulus, cylinder = meshes.annulus_quarter, meshes.cylinder_quarter

MAPS = {"wavy2": ((3, 2), wavy2), "wavy3": ((2, 2, 2), wavy3),
        "annulus": ((3, 3), annulus), "cylinder": ((2, 2, 2), cylinder)}


def tri_pair(case, cells=None):
    """(reference mesh, port mesh), each by its own ``isoparametric``."""
    shape, phi = MAPS[case]
    shape = cells or shape
    return (rgeo.isoparametric(rmesh.structured(shape), phi),
            tgeo.isoparametric(tmesh.structured(shape), phi))


def hanging_pair(case, seed=4):
    rm, tm = tri_pair(case)
    marks = np.random.default_rng(seed).random(rm.n_elements) < 0.4
    marks[0] = True
    rm, tm = radapt.refine_local(rm, marks), tadapt.refine_local(tm, marks)
    assert (tm.faces.nc_code > 0).any() and tm.corners is not None
    return rm, tm


def bases(rm, tm, pmax, seed=1):
    deg = np.random.default_rng(seed).integers(1, pmax + 1, rm.n_elements)
    return RBasis(rm, deg), TBasis(tm, deg)


def mediums(kind):
    return ({None: None, "scalar": k_scalar,
             "tensor": lambda x: k_tensor(x, jnp)}[kind],
            {None: None, "scalar": k_scalar,
             "tensor": lambda x: k_tensor(x, torch)}[kind])


def tt(x):
    return convert.bucket_dict(x, device=CPU)


def dense(A, basis):
    return np.asarray(tbm.to_dense(A, basis))


@pytest.mark.parametrize("case", sorted(MAPS))
def test_isoparametric_bitwise(case):
    rm, tm = tri_pair(case)
    assert tm.corners is not None and tm.jac is None
    assert_same_mesh(rm, tm)
    assert_same_mesh(rm, port_mesh(rm))
    np.testing.assert_array_equal(rm.volumes, tm.volumes)
    np.testing.assert_array_equal(rgeo.mean_detj_q1(rm),
                                  tgeo.mean_detj_q1(tm))
    assert tgeo.is_trilinear(tm) and not tgeo.has_element_charts(tm)


def test_isoparametric_rejects_an_inverted_cell():
    fold = lambda x: np.stack([x[..., 0] * (1 - 2 * x[..., 1]),  # noqa: E731
                               x[..., 1]], -1)
    with pytest.raises(ValueError, match="inverted"):
        tgeo.isoparametric(tmesh.structured((2, 2)), fold)


@pytest.mark.parametrize("case", ["wavy2", "wavy3"])
def test_q1_primitives_and_queries_match_reference(case):
    rm, tm = tri_pair(case)
    rng = np.random.default_rng(9)
    n, d = rm.n_elements, rm.dim
    e = np.arange(n)
    xi = rng.random((n, 4, d))
    x = rm.lower[:, None, :] + xi * rm.extent[:, None, :]
    ks = rng.random((n, 4)) + 1.0
    kt = rng.random((n, 4, d, d))
    kt = kt + np.swapaxes(kt, -1, -2)
    cp = rng.integers(0, 2**d, n)
    pairs = [
        (rgeo.q1_eval(rm.corners, xi), tgeo.q1_eval(tm.corners, xi)),
        (rgeo.q1_jacobian_local(rm.corners, xi),
         tgeo.q1_jacobian_local(tm.corners, xi)),
        (rgeo.q1_child_corners(rm.corners, e, cp),
         tgeo.q1_child_corners(tm.corners, e, cp)),
        (rgeo.apply_map(rm, e, x), tgeo.apply_map(tm, e, x)),
        (rgeo.jacobians(rm, e, x), tgeo.jacobians(tm, e, x)),
        (rgeo.geometry_tensor(rm, e), tgeo.geometry_tensor(tm, e)),
        (rgeo.effective_tensor(rm, e, None, x),
         tgeo.effective_tensor(tm, e, None, x)),
        (rgeo.effective_tensor(rm, e, ks, x),
         tgeo.effective_tensor(tm, e, ks, x)),
        (rgeo.effective_tensor(rm, e, jnp.asarray(kt), x),
         tgeo.effective_tensor(tm, e, kt, x)),
        (rgeo.detj_phys(rm, e, x), tgeo.detj_phys(tm, e, x)),
        (rgeo.face_jacobian_factor(rm, e, 0), tgeo.face_jacobian_factor(
            tm, e, 0)),
        (rgeo.face_jacobian_factor(rm, e, d - 1, x),
         tgeo.face_jacobian_factor(tm, e, d - 1, x)),
    ]
    for want, got in pairs:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-14 * max(1.0, np.abs(want).max()))
    got = tgeo.effective_tensor(tm, e, torch.from_numpy(kt), x)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(pairs[8][0]), rtol=0,
                               atol=1e-13)
    with pytest.raises(ValueError, match="needs points"):
        tgeo.detj_phys(tm, e)


@pytest.mark.parametrize("dim", [2, 3])
def test_lattice_import_of_curved_cells_is_trilinear(dim):
    shape, phi = ((4, 3), annulus) if dim == 2 else ((2, 3, 2), cylinder)
    pts, cells = meshes.mapped_lattice(shape, phi)
    r_imp = rgeo.from_quad_lattice if dim == 2 else rgeo.from_hex_lattice
    t_imp = tgeo.from_quad_lattice if dim == 2 else tgeo.from_hex_lattice
    rm, tm = r_imp(pts, cells, shape), t_imp(pts, cells, shape)
    assert tm.corners is not None and tm.jac is None
    assert_same_mesh(rm, tm)
    perm = np.random.default_rng(0).permutation(len(cells))
    with pytest.raises(ValueError, match="not lattice-ordered|inverted"):
        t_imp(pts, cells[perm], shape)


@pytest.mark.parametrize("case", ["wavy2", "cylinder"])
def test_refinement_restricts_and_merges_corners(case):
    rm, tm = tri_pair(case)
    r1, t1 = rmesh.refine(rm), tmesh.refine(tm)
    assert_same_mesh(r1, t1)
    np.testing.assert_allclose(t1.volumes.sum(), tm.volumes.sum(),
                               rtol=1e-13)
    r2, t2 = hanging_pair(case)
    assert_same_mesh(r2, t2)
    marks = t2.child_pos >= 0
    r3, t3 = radapt.unrefine(r2, marks), tadapt.unrefine(t2, marks)
    assert_same_mesh(r3, t3)
    # merging undoes the restriction: the corners of the base mesh
    order = np.lexsort(t3.lower.T[::-1])
    np.testing.assert_allclose(t3.corners[order], tm.corners, rtol=0,
                               atol=1e-15)
    (_, rc), (tl, tc) = radapt.semicoarsen(r1, 0), tadapt.semicoarsen(t1, 0)
    assert_same_mesh(rc, tc)
    assert tl.parent_mesh is tc


@pytest.mark.parametrize("case,pmax,kind,hanging", [
    ("wavy2", 3, None, False), ("wavy2", 2, "scalar", True),
    ("wavy2", 2, "tensor", False), ("wavy3", 2, None, False),
    ("annulus", 2, None, True)])
def test_assembled_laplace_matches_reference_and_oracle(case, pmax, kind,
                                                        hanging):
    rm, tm = hanging_pair(case) if hanging else tri_pair(case)
    rb, tb = bases(rm, tm, pmax)
    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal")
    s1 = 0.25 if kind != "scalar" and not hanging else 0.0
    rk, tk = mediums(kind)
    RA = r_laplace(rb, diffusion=rk, sigma1=s1, **kw)
    TA = t_laplace(tb, diffusion=tk, sigma1=s1, device=CPU, **kw)
    assert_same_pattern(RA.pattern, TA.pattern)
    assert_close(RA.values, TA.values, 1e-12)
    if kind is None:
        Ao = oracle.sipg_matrix(rb, **kw)
        Ad = dense(t_laplace(tb, device=CPU, **kw), tb)
        assert np.abs(Ad - Ao).max() < 1e-11 * np.abs(Ao).max()
        assert np.abs(Ad - Ad.T).max() < 1e-12 * np.abs(Ad).max()


def test_chunked_assembly_leaves_the_sums_alone(monkeypatch):
    """Cutting the per-point einsums into element chunks changes no
    block by more than rounding (1e-12 of max|A|)."""
    from hpdg_tpu_torch.assemble import sipg as tsipg
    _, tm = tri_pair("wavy3")
    tb = TBasis(tm, np.full(tm.n_elements, 2))
    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal",
              device=CPU)
    whole = t_laplace(tb, **kw)
    wholeE = t_elast(tb, **kw)
    wholeD = t_diag(tb, **kw)
    monkeypatch.setattr(tsipg, "CHUNK_BYTES", 1 << 12)  # < one element
    assert_close(convert.to_numpy(whole.values), t_laplace(tb, **kw).values,
                 1e-12)
    assert_close(convert.to_numpy(wholeE.values), t_elast(tb, **kw).values,
                 1e-12)
    assert_close(convert.to_numpy(wholeD), t_diag(tb, **kw), 1e-12)


@pytest.mark.parametrize("case,pmax,kind,hanging,sigma1", [
    ("wavy2", 3, None, True, 0.0), ("wavy2", 2, "scalar", False, 0.0),
    ("wavy2", 2, "tensor", False, 0.25), ("wavy3", 2, None, False, 0.25),
    ("cylinder", 2, "tensor", False, 0.0)])
def test_sumfact_matches_reference_and_assembly(case, pmax, kind, hanging,
                                                sigma1):
    rm, tm = hanging_pair(case) if hanging else tri_pair(case)
    rb, tb = bases(rm, tm, pmax, seed=3)
    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal",
              sigma1=sigma1)
    rk, tk = mediums(kind)
    x = rand_vec(rb, 7)
    want = r_sipg(rb, diffusion=rk, **kw)(jx(x))
    got = t_sipg(tb, diffusion=tk, device=CPU, **kw)(tt(x))
    assert_close(want, got, 1e-12)
    TA = t_laplace(tb, diffusion=tk, device=CPU, **kw)
    assert_close(convert.to_numpy(tbm.matvec(TA, tt(x))), got, 1e-12)
    got32 = t_sipg(tb, diffusion=tk, device=CPU, dtype=torch.float32, **kw)(
        {k: v.float() for k, v in tt(x).items()})
    assert all(v.dtype == torch.float32 for v in got32.values())
    assert_close(want, got32, 1e-5)


@pytest.mark.parametrize("case,kind,hanging", [
    ("wavy2", None, True), ("wavy3", "scalar", False),
    ("annulus", "tensor", False)])
def test_diagonal_mass_and_heat_blocks_match_reference(case, kind, hanging):
    rm, tm = hanging_pair(case) if hanging else tri_pair(case)
    rb, tb = bases(rm, tm, 2, seed=5)
    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal")
    rk, tk = mediums(kind)
    npd = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    got = t_diag(tb, diffusion=tk, device=CPU, **kw)
    assert_close(npd(r_diag(rb, diffusion=rk, **kw)), got, 1e-12)
    TA = t_laplace(tb, diffusion=tk, device=CPU, **kw)
    assert_close(convert.to_numpy(tbm.extract_diagonal(TA)), got, 1e-12)
    assert_close(npd(rj.mass_diagonal_blocks(rb)),
                 tj.mass_diagonal_blocks(tb, device=CPU), 1e-13)
    assert_close(npd(rj.weighted_mass_diagonal_blocks(rb, k_scalar)),
                 tj.weighted_mass_diagonal_blocks(tb, k_scalar, device=CPU),
                 1e-13)
    assert_close(
        npd(rj.weighted_heat_diagonal_blocks(rb, k_scalar, rk, mass_coef=0.5,
                                             **kw)),
        tj.weighted_heat_diagonal_blocks(tb, k_scalar, tk, mass_coef=0.5,
                                         device=CPU, **kw), 1e-12)
    x = rand_vec(rb, 2)
    assert_close(r_massop(rb)(jx(x)), t_massop(tb, device=CPU)(tt(x)), 1e-13)


ELAST = dict(mu=1.3, lam=0.7, penalty=3.0)


def elast_pair(case):
    if case == "affine2d":
        rm = rgeo.affine_image(rmesh.structured((2, 3)), SHEAR2)
        tm = tgeo.affine_image(tmesh.structured((2, 3)), SHEAR2)
        return RBasis(rm, [1, 2, 2, 1, 2, 3]), TBasis(tm, [1, 2, 2, 1, 2, 3])
    if case == "hanging2d":
        rm, tm = hanging_pair("wavy2")
        return bases(rm, tm, 2, seed=8)
    rm, tm = tri_pair(case)
    return bases(rm, tm, 2, seed=8)


@pytest.mark.parametrize("case,dirichlet,scaling", [
    ("affine2d", True, "measure"), ("wavy2", False, "measure"),
    ("hanging2d", True, "normal"), ("wavy3", True, "measure")])
def test_elasticity_assembled_matches_reference_and_oracle(case, dirichlet,
                                                           scaling):
    rb, tb = elast_pair(case)
    kw = dict(dirichlet=dirichlet, penalty_scaling=scaling, **ELAST)
    RA = r_elast(rb, **kw)
    TA = t_elast(tb, device=CPU, **kw)
    assert TA.block_shape == RA.block_shape
    assert_same_pattern(RA.pattern, TA.pattern)
    assert_close(RA.values, TA.values, 1e-12)
    if scaling == "measure":  # the oracle knows this scaling only
        Ao = oracle.elasticity_matrix(rb, dirichlet=dirichlet, **ELAST)
        Ad = dense(TA, tb)
        assert np.abs(Ad - Ao).max() < 1e-11 * np.abs(Ao).max()
    d = rb.dim
    f = lambda x: x[..., :d] * x[..., :1] + 1.0  # noqa: E731
    assert_close(r_l2v(rb, f), t_l2v(tb, f, device=CPU), 1e-13)


@pytest.mark.parametrize("case,dirichlet,scaling", [
    ("affine2d", True, "measure"), ("affine2d", False, "normal"),
    ("wavy2", True, "normal"), ("hanging2d", True, "measure"),
    ("wavy3", True, "normal")])
def test_elasticity_matrixfree_matches_reference_and_assembly(case, dirichlet,
                                                              scaling):
    rb, tb = elast_pair(case)
    d = rb.dim
    kw = dict(dirichlet=dirichlet, penalty_scaling=scaling, **ELAST)
    x = rand_vec(rb, 12, ncomp=d)
    want = jax.jit(rmfe.elasticity_operator(rb, **kw))(jx(x))
    got = tmfe.elasticity_operator(tb, device=CPU, **kw)(tt(x))
    assert_close(want, got, 1e-12)
    TA = t_elast(tb, device=CPU, **kw)
    assert_close(convert.to_numpy(tbm.matvec(TA, tt(x))), got, 1e-12)
    skel = tmfe.elasticity_operator(tb, device=CPU, include_bulk=False,
                                    **kw)(tt(x))
    want_s = jax.jit(rmfe.elasticity_operator(rb, include_bulk=False,
                                              **kw))(jx(x))
    assert_close(want_s, skel, 1e-12)
    got32 = tmfe.elasticity_operator(tb, device=CPU, dtype=torch.float32,
                                     **kw)({k: v.float()
                                            for k, v in tt(x).items()})
    assert_close(want, got32, 1e-5)


def test_elasticity_geom_tables_and_diagonal_blocks_match_reference():
    rb, tb = elast_pair("wavy2")
    kw = dict(penalty=3.0, dirichlet=True, penalty_scaling="normal")
    rt, tt_ = rmfe.elasticity_geom_tables(rb, **kw), \
        tmfe.elasticity_geom_tables(tb, **kw)
    for p in rt["bulk"]:
        for a, b in zip(rt["bulk"][p], tt_["bulk"][p]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)
    for key in ("face", "bnd"):
        assert len(rt[key]) == len(tt_[key]) > 0
        for ra, ta in zip(rt[key], tt_[key]):
            for a, b in zip(ra, ta):
                np.testing.assert_allclose(b, a, rtol=0,
                                           atol=1e-13 * np.abs(a).max())
    want = rmfe.elasticity_diagonal_blocks(rb, dirichlet=True, **ELAST)
    got = tmfe.elasticity_diagonal_blocks(tb, dirichlet=True, device=CPU,
                                          **ELAST)
    assert_close({k: np.asarray(v) for k, v in want.items()}, got, 1e-12)


@pytest.mark.parametrize("case,hanging", [("wavy2", True), ("wavy3", False),
                                          ("affine", False)])
def test_norms_and_error_norms_match_reference(case, hanging):
    if case == "affine":
        rm = rgeo.affine_image(rmesh.structured((3, 2)), SHEAR2)
        tm = tgeo.affine_image(tmesh.structured((3, 2)), SHEAR2)
    else:
        rm, tm = hanging_pair(case) if hanging else tri_pair(case)
    rb, tb = bases(rm, tm, 3, seed=6)
    x = rand_vec(rb, 4)
    for dirichlet, scaling in ((True, "measure"), (False, "normal")):
        kw = dict(penalty=4.0, dirichlet=dirichlet, penalty_scaling=scaling)
        want = np.asarray(rnorms.ipdg_local_norm(rb, **kw)(jx(x)))
        got = tnorms.ipdg_local_norm(tb, device=CPU, **kw)(tt(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * want.max())
    d = rb.dim
    u_r = lambda p: jnp.sin(p[..., 0]) * jnp.cos(p[..., d - 1])  # noqa: E731
    u_t = lambda p: torch.sin(p[..., 0]) * torch.cos(p[..., d - 1])  # noqa: E731
    g_r = lambda p: jnp.stack([p[..., a] * p[..., 0]  # noqa: E731
                               for a in range(d)], -1)
    g_t = lambda p: torch.stack([p[..., a] * p[..., 0]  # noqa: E731
                                 for a in range(d)], -1)
    np.testing.assert_allclose(float(terr.l2_error(tb, tt(x), u_t)),
                               float(rerr.l2_error(rb, jx(x), u_r)),
                               rtol=1e-12)
    np.testing.assert_allclose(
        float(terr.h1_seminorm_error(tb, tt(x), g_t)),
        float(rerr.h1_seminorm_error(rb, jx(x), g_r)), rtol=1e-12)
