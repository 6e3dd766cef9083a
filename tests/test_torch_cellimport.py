"""Port vs reference: the general (non-lattice) hex/quad import.

``from_cell_vertices`` matches shared faces and assigns each element a
parametric frame by BFS; faces that no identity-aligned frame assignment
can serve get chart codes (``in_side``/``out_axis``/``out_side``/
``twist``).  The port keeps the reference's Python matcher and its
visiting order, so against the reference run with
``HPDG_NATIVE_TOPOLOGY=0`` the element frames, all seven face fields and
the boundary faces agree BITWISE, on

* shuffled lattices with per-cell rotated VTK numbering (2D, 3D),
* the cyclic annulus ring (2D, 3D; trapezoids: genuinely multilinear),
* disk3: three quads around a valence-3 vertex (twisted charts), flat
  and extruded, and the O-grid disk of the examples,

and where the reference's native matcher is built, its face SET agrees
too.  On the twisted meshes the assembled SIPG matrix is held against
the reference (1e-12) and the independent dense oracle (1e-11), the
sum-factorized apply against both, the face tables against the
reference's, and the energy of an interpolated smooth field does not
depend on cell order and numbering.  Guards: elasticity, diagonal blocks
and norms refuse twisted charts (``NotImplementedError``, as in the
reference), ``refine_local`` refuses per-element charts (``ValueError``;
the reference silently drops every interior face there).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import native as rnative
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.assemble.plan import build_plan as r_plan
from hpdg_tpu.assemble.plan import face_group_tables as r_tables
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.matrixfree.sumfact import sipg_operator as r_sipg
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.testing import oracle

from hpdg_tpu_torch import convert
from hpdg_tpu_torch.assemble import assemble_elasticity as t_elast
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble.plan import (apply_twist, build_plan as t_plan,
                                          face_group_tables as t_tables)
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.examples import meshes
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks as t_diag
from hpdg_tpu_torch.matrixfree.elasticity import elasticity_operator as t_eop
from hpdg_tpu_torch.matrixfree.norms import ipdg_local_norm as t_norm
from hpdg_tpu_torch.matrixfree.sumfact import sipg_operator as t_sipg
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.mesh import geometry as tgeo

from test_torch_galerkin import (assert_close, assert_same_pattern, jx,
                                 rand_vec)
from test_torch_geometry import assert_same_mesh, port_mesh

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    """The reference's Python matcher is the port's differential
    partner; its native one visits faces in another order."""
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def disk3(dim):
    """Three quads sharing the centre (a valence-3 singular vertex),
    extruded to three hexes around a singular edge in 3D."""
    ang_a = np.deg2rad([0.0, 120.0, 240.0])
    ang_b = ang_a + np.deg2rad(60.0)
    A = np.stack([np.cos(ang_a), np.sin(ang_a)], axis=1)
    B = 1.15 * np.stack([np.cos(ang_b), np.sin(ang_b)], axis=1)
    pts = np.concatenate([np.zeros((1, 2)), A, B])
    cells = np.array([[0, 1, 4, 2], [0, 2, 5, 3], [0, 3, 6, 1]])
    return (pts, cells) if dim == 2 else meshes.extrude(pts, cells, 1)


def annulus_ring(dim, nseg=8):
    """``nseg`` trapezoids around an annulus: cyclic topology."""
    th = np.linspace(0.0, 2 * np.pi, nseg, endpoint=False)
    ring = np.concatenate([np.stack([r * np.cos(th), r * np.sin(th)], -1)
                           for r in (1.0, 2.0)])
    cells = np.array([[i, nseg + i, nseg + (i + 1) % nseg, (i + 1) % nseg]
                      for i in range(nseg)])
    return (ring, cells) if dim == 2 else meshes.extrude(ring, cells, 1)


def scrambled_lattice(shape, seed=0):
    pts, cells = meshes.lattice(shape)
    return pts, meshes.shuffle_and_rotate(cells, np.random.default_rng(seed))


def ogrid(dim):
    if dim == 2:
        pts, cells, _ = meshes.ogrid_disk(2)
    else:
        pts, cells, _ = meshes.ogrid_cylinder(2, 2)
    return pts, meshes.shuffle_and_rotate(cells, np.random.default_rng(3))


FIXTURES = {
    "lattice2d": lambda: scrambled_lattice((3, 2)),
    "lattice3d": lambda: scrambled_lattice((2, 3, 2), 5),
    "ring2d": lambda: annulus_ring(2), "ring3d": lambda: annulus_ring(3),
    "disk3-2d": lambda: disk3(2), "disk3-3d": lambda: disk3(3),
    "ogrid2d": lambda: ogrid(2), "ogrid3d": lambda: ogrid(3)}
TWISTED = ["disk3-2d", "disk3-3d", "ogrid2d", "ogrid3d"]


def imported(name):
    pts, cells = FIXTURES[name]()
    return rgeo.from_cell_vertices(pts, cells), \
        tgeo.from_cell_vertices(pts, cells)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_import_matches_reference_bitwise(name):
    rm, tm = imported(name)
    assert_same_mesh(rm, tm)  # frames (corners / jac), faces, bfaces
    assert_same_mesh(rm, port_mesh(rm))
    assert tm.faces.is_classic == (name not in TWISTED)
    assert tgeo.has_element_charts(tm)
    np.testing.assert_array_equal(tm.volumes, rm.volumes)


@pytest.mark.skipif(not rnative.available(),
                    reason="the reference's native matcher is not built")
@pytest.mark.parametrize("name", ["lattice3d", "ring3d"])
def test_import_agrees_with_the_native_matcher(name, monkeypatch):
    pts, cells = FIXTURES[name]()
    tm = tgeo.from_cell_vertices(pts, cells)
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "1")
    rm = rgeo.from_cell_vertices(pts, cells)
    face_set = lambda m: {(int(i), int(o), int(a)) for i, o, a in zip(  # noqa: E731
        m.faces.inside, m.faces.outside, m.faces.axis)}
    assert face_set(rm) == face_set(tm)
    assert len(rm.bfaces) == len(tm.bfaces)
    src = tm.corners if tm.corners is not None else tm.jac
    ref = rm.corners if rm.corners is not None else rm.jac
    np.testing.assert_allclose(src, ref, rtol=0, atol=1e-14)


def test_counts_of_the_singular_meshes():
    for dim in (2, 3):
        _, tm = imported(f"disk3-{dim}d")
        assert tm.n_elements == 3 and len(tm.faces) == 3
        assert len(tm.bfaces) == (6 if dim == 2 else 12)
    pts, cells, (n_int, n_bnd) = meshes.ogrid_cylinder(3, 2)
    tm = tgeo.from_cell_vertices(pts, cells)
    assert tm.n_elements == 5 * 9 * 2
    assert (len(tm.faces), len(tm.bfaces)) == (n_int, n_bnd)
    assert not tm.faces.is_classic
    np.testing.assert_allclose(tm.volumes.sum(), np.pi, rtol=0.12)


def test_import_guards():
    pts, cells = meshes.lattice((2, 2))
    with pytest.raises(ValueError, match="disconnected"):
        tgeo.from_cell_vertices(np.concatenate([pts, pts + 100.0]),
                                np.concatenate([cells, cells + len(pts)]))
    pts, cells = meshes.lattice((2, 1))
    with pytest.raises(ValueError, match="more than two"):
        tgeo.from_cell_vertices(pts, np.concatenate([cells, cells[:1]]))
    with pytest.raises(ValueError, match="expected"):
        tgeo.from_cell_vertices(pts, cells[:, :3])
    with pytest.raises(ValueError, match="negative|inverted"):
        tgeo.from_cell_vertices(pts, cells[:, [0, 3, 2, 1]])


@pytest.mark.parametrize("twist", range(8))
def test_apply_twist_matches_reference(twist):
    from hpdg_tpu.assemble.plan import apply_twist as r_twist
    pts = np.random.default_rng(twist).random((5, 2))
    np.testing.assert_array_equal(apply_twist(pts, twist),
                                  r_twist(pts, twist))
    if twist < 2:
        np.testing.assert_array_equal(apply_twist(pts[:, :1], twist),
                                      r_twist(pts[:, :1], twist))


@pytest.mark.parametrize("name", TWISTED)
def test_twisted_face_tables_match_reference(name):
    rm, tm = imported(name)
    deg = np.arange(rm.n_elements) % 2 + 1
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    rp, tp = r_plan(rb), t_plan(tb)
    assert_same_pattern(rp.pattern, tp.pattern)
    assert len(rp.face_groups) == len(tp.face_groups)
    for rfg, tfg in zip(rp.face_groups, tp.face_groups):
        for f in ("p_in", "p_out", "axis", "nc_code", "in_side", "out_axis",
                  "out_side", "twist"):
            assert getattr(rfg, f) == getattr(tfg, f), f
        for rt, ttab in zip(r_tables(rb, rfg, 4), t_tables(tb, tfg, 4)):
            for key in ("points", "weights", "V", "Dn", "Dall"):
                np.testing.assert_array_equal(ttab[key], rt[key], err_msg=key)
    assert any(g.twist or g.in_side != 1 or g.out_side != 0
               or g.out_axis != g.axis for g in tp.face_groups)


@pytest.mark.parametrize("name,p", [
    ("disk3-2d", 3), ("disk3-3d", 2), ("ogrid2d", 2), ("ogrid3d", 1),
    ("ring2d", 2), ("ring3d", 2), ("lattice3d", 1)])
def test_assembled_matrix_matches_reference_and_oracle(name, p):
    rm, tm = imported(name)
    rb, tb = (RBasis(rm, np.full(rm.n_elements, p)),
              TBasis(tm, np.full(tm.n_elements, p)))
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
    RA, TA = r_laplace(rb, **kw), t_laplace(tb, device=CPU, **kw)
    assert_same_pattern(RA.pattern, TA.pattern)
    assert_close(RA.values, TA.values, 1e-12)
    Ad = np.asarray(tbm.to_dense(TA, tb))
    Ao = oracle.sipg_matrix(rb, **kw)
    assert np.abs(Ad - Ao).max() < 1e-11 * np.abs(Ao).max()
    assert np.abs(Ad - Ad.T).max() < 1e-11 * np.abs(Ad).max()
    assert np.linalg.eigvalsh(0.5 * (Ad + Ad.T)).min() > 0


@pytest.mark.parametrize("name,sigma1", [
    ("disk3-2d", 0.0), ("disk3-3d", 0.25), ("ogrid3d", 0.0), ("ring3d", 0.0)])
def test_sumfact_on_twisted_charts_matches_reference_and_assembly(name,
                                                                  sigma1):
    rm, tm = imported(name)
    deg = np.arange(rm.n_elements) % 2 + 2 if "disk3" in name \
        else np.full(rm.n_elements, 2)
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    kw = dict(penalty=2.0, dirichlet=True, sigma1=sigma1)
    x = rand_vec(rb, 13)
    xt = convert.bucket_dict(x, device=CPU)
    want = r_sipg(rb, **kw)(jx(x))
    got = t_sipg(tb, device=CPU, **kw)(xt)
    assert_close(want, got, 1e-12)
    TA = t_laplace(tb, device=CPU, **kw)
    assert_close(convert.to_numpy(tbm.matvec(TA, xt)), got, 1e-12)
    got32 = t_sipg(tb, device=CPU, dtype=torch.float32, **kw)(
        {k: v.float() for k, v in xt.items()})
    assert_close(want, got32, 1e-5)


def energy(tm, p):
    """a(u_I, u_I) of the interpolant of a fixed smooth field: depends
    on the physical mesh only, not on cell order or numbering."""
    tb = TBasis(tm, np.full(tm.n_elements, p))
    A = t_laplace(tb, penalty=2.0, dirichlet=True, penalty_scaling="normal",
                  device=CPU)
    xp = tb.node_positions(p)
    u = np.sin(xp[..., 0] + 0.3) * np.cos(0.7 * xp[..., 1])
    if tm.dim == 3:
        u = u * (1.0 + 0.2 * xp[..., 2])
    x = {p: torch.from_numpy(u)}
    return float(sum((x[q] * v).sum() for q, v in tbm.matvec(A, x).items()))


@pytest.mark.parametrize("dim", [2, 3])
def test_energy_does_not_depend_on_cell_order_and_numbering(dim):
    if dim == 2:
        pts, cells, _ = meshes.ogrid_disk(2)
    else:
        pts, cells, _ = meshes.ogrid_cylinder(2, 2)
    e_ref = energy(tgeo.from_cell_vertices(pts, cells), 2)
    for seed in (1, 2):
        scr = meshes.shuffle_and_rotate(cells, np.random.default_rng(seed))
        e = energy(tgeo.from_cell_vertices(pts, scr), 2)
        assert abs(e - e_ref) < 1e-10 * abs(e_ref), (e, e_ref)


def test_twisted_charts_are_refused_where_the_reference_refuses():
    _, tm = imported("disk3-3d")
    tb = TBasis(tm, np.full(3, 2))
    for call in (lambda: t_elast(tb, device=CPU),
                 lambda: t_diag(tb, device=CPU),
                 lambda: t_eop(tb, device=CPU),
                 lambda: t_norm(tb, device=CPU)):
        with pytest.raises(NotImplementedError, match="twisted"):
            call()


def test_refine_local_refuses_per_element_charts():
    """R1: the reference re-matches faces from the parametric boxes,
    which are disjoint here, and silently loses every interior face;
    the port raises.  Uniform ``refine`` shares the matcher, so a lattice
    import that came through ``from_hex_lattice`` is the way to refine."""
    rm, tm = imported("disk3-3d")
    marks = np.array([True, False, False])
    assert len(rm.faces) == 3
    lost = radapt.refine_local(rm, marks)
    between = lost.parent[lost.faces.inside] != lost.parent[
        lost.faces.outside]
    assert not between.any()  # the reference's loss: 3 faces -> 0
    assert len(lost.bfaces) > len(rm.bfaces) + 4 * 3  # now "boundary"
    with pytest.raises(ValueError, match="per-element"):
        tadapt.refine_local(tm, marks)
    _, ring = imported("ring2d")  # classic faces, still per-element charts
    with pytest.raises(ValueError, match="per-element"):
        tadapt.refine_local(ring, np.ones(ring.n_elements, bool))
