"""Port vs reference: first-class AFFINE element geometry, in f64.

* ``affine_image``, ``affinize`` and ``from_hex_lattice`` /
  ``from_quad_lattice`` on parallelepiped cells: the meshes bitwise;
* the per-point geometry queries (``apply_map``, ``jacobians``,
  ``geometry_tensor``, ``effective_tensor`` with no, a scalar and a
  tensor medium, ``detj_phys``, ``face_jacobian_factor``), the penalty
  geometry and ``face_grad_jump_geometry`` at 1e-14;
* ``refine``, ``refine_local``, ``unrefine`` and ``semicoarsen`` carry
  ``jac``/``shift``: bitwise;
* ``convert.mesh`` round trip; ``effective_tensor`` with a torch medium;
* the assembled SIPG matrix against the reference (1e-12) and against
  the independent dense oracle (1e-11), the sum-factorized apply against
  the reference and the assembled matvec (1e-12, f32 at 1e-6), diagonal
  blocks, node positions;
* ``coef_parts`` and ``use_kernel=True`` refuse a mesh with geometry.

The helpers ``port_mesh`` and ``assert_same_mesh`` serve the other
geometry test files.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.matrixfree.diagonal import sipg_diagonal_blocks as r_diag
from hpdg_tpu.matrixfree.sumfact import sipg_operator as r_sipg
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.testing import oracle

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble.plan import build_plan as t_plan
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.examples import meshes
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks as t_diag
from hpdg_tpu_torch.matrixfree.sumfact import sipg_operator as t_sipg
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.mesh import geometry as tgeo

from test_torch_galerkin import (assert_close, assert_same_pattern, jx,
                                 rand_vec)

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU

FACE_FIELDS = ("inside", "outside", "axis", "nc_code", "in_side",
               "out_axis", "out_side", "twist")
BFACE_FIELDS = ("elem", "axis", "side")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def port_mesh(rm):
    """The reference mesh ``rm`` (and the chain of its parent meshes) as
    the port's ``Mesh`` on the identical topology."""
    if rm is None:
        return None
    return convert.mesh(
        rm.dim, rm.lower, rm.extent,
        {k: getattr(rm.faces, k) for k in FACE_FIELDS},
        {k: getattr(rm.bfaces, k) for k in BFACE_FIELDS},
        jac=rm.jac, shift=rm.shift, corners=rm.corners, parent=rm.parent,
        child_pos=rm.child_pos, parent_mesh=port_mesh(rm.parent_mesh))


def assert_same_mesh(rm, tm):
    """Every array of the two meshes bitwise equal (dtypes too)."""
    assert rm.dim == tm.dim
    for name in ("lower", "extent", "parent", "child_pos", "jac", "shift",
                 "corners"):
        a, b = getattr(rm, name), getattr(tm, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in FACE_FIELDS:
        np.testing.assert_array_equal(getattr(rm.faces, name),
                                      getattr(tm.faces, name), err_msg=name)
    for name in BFACE_FIELDS:
        np.testing.assert_array_equal(getattr(rm.bfaces, name),
                                      getattr(tm.bfaces, name), err_msg=name)


SHEAR2 = np.array([[1.0, 0.5], [0.0, 1.0]])
SHEAR3 = np.array([[1.0, 0.3, 0.1], [0.0, 0.9, 0.2], [0.1, 0.0, 1.1]])


def twist3(x):
    th = 0.6 * x[..., 2]
    c, s = np.cos(th), np.sin(th)
    return np.stack([c * x[..., 0] - s * x[..., 1],
                     s * x[..., 0] + c * x[..., 1], x[..., 2]], -1)


def affine_pair(case):
    """(reference mesh, port mesh) built by each package's own
    constructor."""
    if case == "shear2d":
        return (rgeo.affine_image(rmesh.structured((3, 2)), SHEAR2, [0.2, -1]),
                tgeo.affine_image(tmesh.structured((3, 2)), SHEAR2, [0.2, -1]))
    if case == "shear3d":
        return (rgeo.affine_image(rmesh.structured((2, 2, 2)), SHEAR3),
                tgeo.affine_image(tmesh.structured((2, 2, 2)), SHEAR3))
    if case == "affinize3d":
        return (rgeo.affinize(rmesh.structured((2, 2, 3)), twist3),
                tgeo.affinize(tmesh.structured((2, 2, 3)), twist3))
    raise ValueError(case)


CASES = ["shear2d", "shear3d", "affinize3d"]


def k_scalar(x):
    return 1.0 + 0.5 * x[..., 0] ** 2 + 0.25 * x[..., 1]


def k_tensor(x, lib):
    d = x.shape[-1]
    eye = lib.eye(d, dtype=x.dtype) if lib is torch else jnp.eye(d)
    rot = x[..., :, None] * x[..., None, :]
    return (2.0 + x[..., 0])[..., None, None] * eye + 0.3 * rot


@pytest.mark.parametrize("case", CASES)
def test_affine_constructors_bitwise(case):
    rm, tm = affine_pair(case)
    assert tm.jac is not None and tm.corners is None
    assert_same_mesh(rm, tm)
    assert_same_mesh(rm, port_mesh(rm))
    np.testing.assert_array_equal(rm.volumes, tm.volumes)
    np.testing.assert_array_equal(rm.centers(), tm.centers())


def test_affinize_with_exact_derivative_and_orientation_guard():
    A = SHEAR3
    phi = lambda x: x @ A.T  # noqa: E731
    dphi = lambda c: np.broadcast_to(A, (len(c), 3, 3))  # noqa: E731
    rm = rgeo.affinize(rmesh.structured((2, 1, 2)), phi, dphi)
    tm = tgeo.affinize(tmesh.structured((2, 1, 2)), phi, dphi)
    assert_same_mesh(rm, tm)
    flip = lambda x: x * np.array([-1.0, 1.0, 1.0])  # noqa: E731
    with pytest.raises(ValueError, match="orientation"):
        tgeo.affinize(tmesh.structured((2, 1, 2)), flip)


def _query_points(m, rng, nq=5):
    """Global parametric points inside every element, (n, nq, dim)."""
    xi = rng.random((m.n_elements, nq, m.dim))
    return m.lower[:, None, :] + xi * m.extent[:, None, :]


@pytest.mark.parametrize("case", CASES)
def test_geometry_queries_match_reference(case):
    rm, tm = affine_pair(case)
    rng = np.random.default_rng(11)
    e = np.arange(rm.n_elements)
    x = _query_points(rm, rng)
    ks = rng.random(x.shape[:2]) + 1.0
    kt = rng.random(x.shape[:2] + (rm.dim, rm.dim))
    kt = kt + np.swapaxes(kt, -1, -2)
    pairs = [
        (rgeo.apply_map(rm, e, x), tgeo.apply_map(tm, e, x)),
        (rgeo.jacobians(rm, e, x), tgeo.jacobians(tm, e, x)),
        (rgeo.geometry_tensor(rm, e), tgeo.geometry_tensor(tm, e)),
        (rgeo.effective_tensor(rm, e, None, x),
         tgeo.effective_tensor(tm, e, None, x)),
        (rgeo.effective_tensor(rm, e, ks, x),
         tgeo.effective_tensor(tm, e, ks, x)),
        (rgeo.effective_tensor(rm, e, jnp.asarray(kt), x),
         tgeo.effective_tensor(tm, e, kt, x)),
        (rgeo.detj_phys(rm, e), tgeo.detj_phys(tm, e)),
        (rgeo.detj_phys(rm, e, x), tgeo.detj_phys(tm, e, x)),
        (rgeo.face_jacobian_factor(rm, e, 1), tgeo.face_jacobian_factor(
            tm, e, 1)),
        (rgeo.face_jacobian_factor(rm, e, 0, x), tgeo.face_jacobian_factor(
            tm, e, 0, x)),
    ]
    for want, got in pairs:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-14 * max(1.0, np.abs(want).max()))
    assert tgeo.has_geometry(tm) and tgeo.has_affine(tm)
    assert not tgeo.is_trilinear(tm) and not tgeo.has_element_charts(tm)


@pytest.mark.parametrize("case", ["shear2d", "affinize3d"])
def test_effective_tensor_with_a_torch_medium(case):
    """A medium held in a torch tensor comes back as a torch tensor of
    its dtype, equal to the numpy route."""
    _, tm = affine_pair(case)
    rng = np.random.default_rng(3)
    e = np.arange(tm.n_elements)
    x = _query_points(tm, rng)
    ks = rng.random(x.shape[:2]) + 1.0
    kt = rng.random(x.shape[:2] + (tm.dim, tm.dim))
    for k in (ks, kt):
        got = tgeo.effective_tensor(tm, e, torch.from_numpy(k), x)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
        want = tgeo.effective_tensor(tm, e, k, x)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-14 * np.abs(want).max())
    got32 = tgeo.effective_tensor(tm, e, torch.from_numpy(ks).float(), x)
    assert got32.dtype == torch.float32


@pytest.mark.parametrize("case", CASES)
def test_penalty_geometry_matches_reference(case):
    rm, tm = affine_pair(case)
    rb = RBasis(rm, np.full(rm.n_elements, 2))
    tb = TBasis(tm, np.full(tm.n_elements, 2))
    from hpdg_tpu.assemble.plan import build_plan as r_plan
    from hpdg_tpu.assemble.plan import face_phys_points as r_fpp
    from hpdg_tpu_torch.assemble.plan import face_phys_points as t_fpp
    rp, tp = r_plan(rb), t_plan(tb)
    rng = np.random.default_rng(5)
    pts = rng.random((4, rm.dim - 1))
    for rfg, tfg in zip(rp.face_groups, tp.face_groups):
        np.testing.assert_array_equal(rfg.face_ids, tfg.face_ids)
        for want, got in zip(rgeo.face_penalty_geometry(rm, rfg),
                             tgeo.face_penalty_geometry(tm, tfg)):
            np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
        for scaling in ("measure", "normal"):
            np.testing.assert_allclose(
                tgeo.penalty_coef_mesh(tm, tfg, 4.0, 2, scaling),
                rgeo.penalty_coef_mesh(rm, rfg, 4.0, 2, scaling),
                rtol=1e-14, atol=0)
        xi, xo = r_fpp(rb, rfg, pts), r_fpp(rb, rfg, pts, side="out")
        np.testing.assert_array_equal(t_fpp(tb, tfg, pts), xi)
        np.testing.assert_array_equal(t_fpp(tb, tfg, pts, side="out"), xo)
        for want, got in zip(rgeo.face_grad_jump_geometry(rm, rfg, xi, xo),
                             tgeo.face_grad_jump_geometry(tm, tfg, xi, xo)):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-14 * np.abs(want).max())
    for rbg, tbg in zip(rp.boundary_groups, tp.boundary_groups):
        for want, got in zip(rgeo.boundary_penalty_geometry(rm, rbg),
                             tgeo.boundary_penalty_geometry(tm, tbg)):
            np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
        np.testing.assert_allclose(
            tgeo.boundary_penalty_coef_mesh(tm, tbg, 4.0, "normal"),
            rgeo.boundary_penalty_coef_mesh(rm, rbg, 4.0, "normal"),
            rtol=1e-14, atol=0)


def sheared_lattice(shape, A):
    """points/cells (VTK ordering, lattice order) of a sheared lattice."""
    pts, cells = meshes.lattice(shape)
    return pts @ np.asarray(A).T, cells


@pytest.mark.parametrize("dim", [2, 3])
def test_lattice_import_of_parallelepipeds_is_affine(dim):
    shape, A = ((3, 2), SHEAR2) if dim == 2 else ((2, 2, 3), SHEAR3)
    pts, cells = sheared_lattice(shape, A)
    r_imp = rgeo.from_quad_lattice if dim == 2 else rgeo.from_hex_lattice
    t_imp = tgeo.from_quad_lattice if dim == 2 else tgeo.from_hex_lattice
    rm, tm = r_imp(pts, cells, shape), t_imp(pts, cells, shape)
    assert tm.jac is not None and tm.corners is None
    assert_same_mesh(rm, tm)
    np.testing.assert_allclose(tm.volumes.sum(),
                               np.prod(shape) * abs(np.linalg.det(A)),
                               rtol=1e-13)
    with pytest.raises(ValueError, match="lattice_shape"):
        t_imp(pts, cells, shape[:-1] + (shape[-1] + 1,))
    mirror = [0, 3, 2, 1] if dim == 2 else [0, 3, 2, 1, 4, 7, 6, 5]
    with pytest.raises(ValueError, match="negative"):
        t_imp(pts, cells[:, mirror], shape)


@pytest.mark.parametrize("case", ["shear2d", "affinize3d"])
def test_refinement_carries_the_affine_maps(case):
    rm, tm = affine_pair(case)
    r1, t1 = rmesh.refine(rm), tmesh.refine(tm)
    assert_same_mesh(r1, t1)
    rng = np.random.default_rng(2)
    marks = rng.random(rm.n_elements) < 0.35
    marks[0] = True
    r2, t2 = radapt.refine_local(rm, marks), tadapt.refine_local(tm, marks)
    assert_same_mesh(r2, t2)
    assert (t2.faces.nc_code > 0).any()
    back = t2.child_pos >= 0
    r3, t3 = radapt.unrefine(r2, back), tadapt.unrefine(t2, back)
    assert_same_mesh(r3, t3)
    np.testing.assert_allclose(t3.volumes.sum(), tm.volumes.sum(),
                               rtol=1e-13)
    (_, rc), (tl, tc) = radapt.semicoarsen(r1, 0), tadapt.semicoarsen(t1, 0)
    assert_same_mesh(rc, tc)
    assert tl.parent_mesh is tc and tl.jac is t1.jac


def dense(A, basis):
    return np.asarray(tbm.to_dense(A, basis))


@pytest.mark.parametrize("case,p,kind", [
    ("shear2d", 3, None), ("shear2d", 2, "scalar"), ("shear2d", 2, "tensor"),
    ("shear3d", 2, None), ("affinize3d", 1, None)])
def test_assembled_laplace_matches_reference_and_oracle(case, p, kind):
    rm, tm = affine_pair(case)
    deg = np.full(rm.n_elements, p)
    deg[0] = max(1, p - 1)
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal")
    rk = {None: None, "scalar": k_scalar,
          "tensor": lambda x: k_tensor(x, jnp)}[kind]
    tk = {None: None, "scalar": k_scalar,
          "tensor": lambda x: k_tensor(x, torch)}[kind]
    RA = r_laplace(rb, diffusion=rk, sigma1=0.25 if kind is None else 0.0,
                   **kw)
    TA = t_laplace(tb, diffusion=tk, sigma1=0.25 if kind is None else 0.0,
                   device=CPU, **kw)
    assert_same_pattern(RA.pattern, TA.pattern)
    assert_close(RA.values, TA.values, 1e-12)
    if kind is None:
        TA0 = t_laplace(tb, device=CPU, **kw)
        Ao = oracle.sipg_matrix(rb, **kw)
        err = np.abs(dense(TA0, tb) - Ao).max() / np.abs(Ao).max()
        assert err < 1e-11, err


@pytest.mark.parametrize("case,p,kind,sigma1", [
    ("shear2d", 3, None, 0.25), ("shear2d", 2, "scalar", 0.0),
    ("shear2d", 2, "tensor", 0.25), ("shear3d", 2, None, 0.0),
    ("affinize3d", 2, "tensor", 0.0)])
def test_sumfact_matches_reference_and_assembly(case, p, kind, sigma1):
    rm, tm = affine_pair(case)
    deg = np.full(rm.n_elements, p)
    deg[-1] = max(1, p - 1)
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal",
              sigma1=sigma1)
    rk = {None: None, "scalar": k_scalar,
          "tensor": lambda x: k_tensor(x, jnp)}[kind]
    tk = {None: None, "scalar": k_scalar,
          "tensor": lambda x: k_tensor(x, torch)}[kind]
    x = rand_vec(rb, 7)
    xt = convert.bucket_dict(x, device=CPU)
    want = r_sipg(rb, diffusion=rk, **kw)(jx(x))
    got = t_sipg(tb, diffusion=tk, device=CPU, **kw)(xt)
    assert_close(want, got, 1e-12)
    TA = t_laplace(tb, diffusion=tk, device=CPU, **kw)
    assert_close(convert.to_numpy(tbm.matvec(TA, xt)), got, 1e-12)
    got32 = t_sipg(tb, diffusion=tk, device=CPU, dtype=torch.float32, **kw)(
        {k: v.float() for k, v in xt.items()})
    assert all(v.dtype == torch.float32 for v in got32.values())
    assert_close(want, got32, 1e-5)  # 1e-6 relative of values ~ 10 max|y|


@pytest.mark.parametrize("case,kind", [("shear2d", None), ("shear2d", "tensor"),
                                       ("affinize3d", "scalar")])
def test_diagonal_blocks_match_reference_and_assembly(case, kind):
    rm, tm = affine_pair(case)
    deg = np.full(rm.n_elements, 2)
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal")
    rk = {None: None, "scalar": k_scalar,
          "tensor": lambda x: k_tensor(x, jnp)}[kind]
    tk = {None: None, "scalar": k_scalar,
          "tensor": lambda x: k_tensor(x, torch)}[kind]
    want = r_diag(rb, diffusion=rk, **kw)
    got = t_diag(tb, diffusion=tk, device=CPU, **kw)
    assert_close({k: np.asarray(v) for k, v in want.items()}, got, 1e-12)
    TA = t_laplace(tb, diffusion=tk, device=CPU, **kw)
    assert_close(convert.to_numpy(tbm.extract_diagonal(TA)), got, 1e-12)


@pytest.mark.parametrize("case", CASES)
def test_node_positions_are_mapped(case):
    rm, tm = affine_pair(case)
    deg = np.arange(rm.n_elements) % 3 + 1
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    for p in tb.bucket_degrees:
        np.testing.assert_array_equal(tb.node_positions(p),
                                      rb.node_positions(p))


def test_coef_parts_and_the_stencil_kernel_refuse_geometry():
    from hpdg_tpu_torch.matrixfree.uniform import uniform_sipg_operator
    from hpdg_tpu_torch.solvers.multigrid import matrixfree_multigrid_solver
    _, tm = affine_pair("shear3d")
    tb = TBasis(tm, np.full(tm.n_elements, 2))
    with pytest.raises(ValueError, match="coef_parts"):
        t_laplace(tb, coef_parts=True, device=CPU)
    with pytest.raises(ValueError, match="geometry"):
        uniform_sipg_operator(tb, device=CPU)
    meshes = [tm, tmesh.refine(tm)]
    fine = TBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    # the stencil kernel cannot take a level with geometry: no fallback
    with pytest.raises(ValueError, match="geometry"):
        matrixfree_multigrid_solver(fine, meshes=meshes, use_kernel=True,
                                    dtype=torch.float32, device=CPU)


@pytest.mark.parametrize("case,n,volume", [("shear", 4, 1.0),
                                           ("twist", 2, 1.0)])
def test_affine_geometry_example_solves(case, n, volume):
    from hpdg_tpu_torch.examples import affine_geometry as ex
    r = ex.run(case, n=n, p=2, device=CPU)
    assert r["rel_residual"] < 1e-9 and r["info"]["iterations"] < 800
    assert abs(r["volume"] - volume) < (1e-12 if case == "shear" else 0.05)
    assert r["basis"].mesh.jac is not None
    with pytest.raises(ValueError, match="unknown case"):
        ex.run("bend", device=CPU)


def test_pullback_diffusion_is_the_affine_image_without_face_geometry():
    """``pullback_diffusion(F)`` on the box mesh: the reference's blocks,
    and the bulk term of the ``affine_image`` mesh (the face terms differ
    by the penalty's physical face measures)."""
    from hpdg_tpu.assemble import pullback_diffusion as r_pull
    from hpdg_tpu_torch.assemble import pullback_diffusion as t_pull
    from hpdg_tpu_torch.matrixfree.sumfact import laplace_bulk_operator
    rb = RBasis(rmesh.structured((3, 2)), np.full(6, 2))
    tb = TBasis(tmesh.structured((3, 2)), np.full(6, 2))
    kw = dict(penalty=4.0, dirichlet=True)
    assert_close(r_laplace(rb, diffusion=r_pull(SHEAR2), **kw).values,
                 t_laplace(tb, diffusion=t_pull(SHEAR2), device=CPU,
                           **kw).values, 1e-12)
    ta = TBasis(tgeo.affine_image(tb.mesh, SHEAR2), np.full(6, 2))
    x = convert.bucket_dict(rand_vec(tb, 3), device=CPU)
    assert_close(
        convert.to_numpy(laplace_bulk_operator(ta, device=CPU)(x)),
        laplace_bulk_operator(tb, diffusion=t_pull(SHEAR2), device=CPU)(x),
        1e-12)
