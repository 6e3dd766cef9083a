"""Port vs reference: state persistence and mesh coarsening.

* ``interpolate_to`` through a degree change and through two
  ``refine_local`` steps with mixed degrees (2D and 3D): 1e-13 of max;
* ``restrict_to_coarse`` in both layouts (undo of a ``refine_local``
  step; a mesh from ``unrefine``): 1e-13 of max;
* ``unrefine``, ``semicoarsen`` and ``semicoarsen_chain``: every array
  bitwise equal, links included;
* ``save_npz``/``load_npz`` across packages, both ways, and
  ``convert.saved_state``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks import persist as rper
from hpdg_tpu.mesh import adaptive as radapt

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import persist as tper
from hpdg_tpu_torch.mesh import adaptive as tadapt

from test_torch_adaptive import _assert_same_mesh
from test_torch_norms import coeffs

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def assert_close(got: dict, want: dict, tol):
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for p in want:
        assert got[p].dtype == torch.float64 and got[p].device.type == "cpu"
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                   rtol=0, atol=tol * scale)


def saved_pair(rb, tb, seed):
    x = coeffs(rb, seed)
    rs = rper.save_state(rb, {p: jnp.asarray(v) for p, v in x.items()})
    ts = tper.save_state(tb, convert.bucket_dict(x, device=CPU))
    np.testing.assert_array_equal(ts.flat, np.asarray(rs.flat))
    return rs, ts


@pytest.mark.parametrize("cells", [(3, 4), (2, 2, 3)])
def test_interpolate_to_degree_change_and_two_refinements(cells):
    rng = np.random.default_rng(len(cells))
    rm, tm = rmesh.structured(cells), tmesh.structured(cells)
    deg = rng.integers(1, 4, rm.n_elements)
    rb, tb = RBasis(rm, deg), TBasis(tm, deg)
    rs, ts = saved_pair(rb, tb, 1)
    # a degree change on the same mesh
    deg2 = np.clip(deg + rng.integers(-1, 2, len(deg)), 1, 4)
    want = rper.interpolate_to(rs, rb.with_degrees(deg2))
    assert_close(tper.interpolate_to(ts, tb.with_degrees(deg2), device=CPU),
                 want, 1e-13)
    # two refine_local steps, degrees carried and then changed
    rms, tms, d = rm, tm, deg
    for s in (2, 3):
        marks = np.random.default_rng(s).random(rms.n_elements) < 0.4
        rms, tms = radapt.refine_local(rms, marks), tadapt.refine_local(tms,
                                                                        marks)
        d_t = tper.degrees_after_refine(d, tms)
        d = rper.degrees_after_refine(d, rms)
        np.testing.assert_array_equal(d_t, d)
        assert d_t.dtype == d.dtype
    d[::3] = np.minimum(d[::3] + 1, 5)
    want = rper.interpolate_to(rs, RBasis(rms, d))
    assert_close(tper.interpolate_to(ts, TBasis(tms, d), device=CPU), want,
                 1e-13)
    np.testing.assert_array_equal(tper.save_degrees(TBasis(tms, d)), d)


def _refined_pair(cells, seed):
    r0, t0 = rmesh.structured(cells), tmesh.structured(cells)
    marks = np.random.default_rng(seed).random(r0.n_elements) < 0.5
    return r0, t0, radapt.refine_local(r0, marks), tadapt.refine_local(t0,
                                                                       marks)


@pytest.mark.parametrize("cells", [(3, 4), (2, 3, 2)])
def test_restrict_to_coarse_undoes_a_refinement(cells):
    r0, t0, rm, tm = _refined_pair(cells, 4)
    rng = np.random.default_rng(5)
    dfine = rng.integers(1, 4, rm.n_elements)
    dcoarse = rng.integers(1, 4, r0.n_elements)
    rs, ts = saved_pair(RBasis(rm, dfine), TBasis(tm, dfine), 6)
    want = rper.restrict_to_coarse(rs, RBasis(r0, dcoarse))
    got = tper.restrict_to_coarse(ts, TBasis(t0, dcoarse), device=CPU)
    assert_close(got, want, 1e-13)


@pytest.mark.parametrize("cells", [(3, 4), (2, 3, 2)])
def test_unrefine_then_restrict_to_coarse(cells):
    _, _, rm, tm = _refined_pair(cells, 7)
    marks = np.random.default_rng(8).random(rm.n_elements) < 0.8
    ru, tu = radapt.unrefine(rm, marks), tadapt.unrefine(tm, marks)
    _assert_same_mesh(ru, tu)
    assert tu.parent_mesh is tm and (tu.child_pos == -2).any()
    assert (tu.child_pos == -1).any()
    rng = np.random.default_rng(9)
    dfine = rng.integers(1, 4, rm.n_elements)
    dcoarse = rng.integers(1, 4, ru.n_elements)
    rs, ts = saved_pair(RBasis(rm, dfine), TBasis(tm, dfine), 10)
    want = rper.restrict_to_coarse(rs, RBasis(ru, dcoarse))
    got = tper.restrict_to_coarse(ts, TBasis(tu, dcoarse), device=CPU)
    assert_close(got, want, 1e-13)


def test_unrefine_refuses_and_keeps_partial_groups():
    tm = tmesh.structured((2, 2))
    with pytest.raises(ValueError):
        tadapt.unrefine(tm, np.ones(4, bool))
    _, _, rm, tm = _refined_pair((2, 2), 0)
    # every member marked except one per group: nothing merges
    marks = tm.child_pos != 0
    ru, tu = radapt.unrefine(rm, marks), tadapt.unrefine(tm, marks)
    _assert_same_mesh(ru, tu)
    assert (tu.child_pos == -1).all()
    with pytest.raises(ValueError):  # not the parent, not an unrefine
        tper.restrict_to_coarse(tper.save_state(
            TBasis(tm, np.ones(tm.n_elements)),
            {1: torch.zeros(tm.n_elements, 4)}),
            TBasis(tmesh.structured((2, 2)), np.ones(4)))


@pytest.mark.parametrize("cells,upper,axis", [
    ((4, 4), (1.0, 0.25), 1), ((4, 4), (1.0, 1.0), 0),
    ((2, 8, 2), (1.0, 1.0, 0.25), 2)])
def test_semicoarsen_matches_reference(cells, upper, axis):
    rm = rmesh.structured(cells, upper=upper)
    tm = tmesh.structured(cells, upper=upper)
    rf, rc = radapt.semicoarsen(rm, axis)
    tf, tc = tadapt.semicoarsen(tm, axis)
    _assert_same_mesh(rc, tc)
    _assert_same_mesh(rf, tf)
    assert tf.parent_mesh is tc and tm.parent is None


@pytest.mark.parametrize("cells,upper", [
    ((4, 16), (1.0, 0.25)), ((8, 2, 4), (0.25, 1.0, 1.0)), ((3, 3), None),
    ((3, 8), (1.0, 0.125))])
def test_semicoarsen_chain_matches_reference(cells, upper):
    rchain = radapt.semicoarsen_chain(rmesh.structured(cells, upper=upper))
    tchain = tadapt.semicoarsen_chain(tmesh.structured(cells, upper=upper))
    assert len(tchain) == len(rchain)
    for r, t in zip(rchain, tchain):
        _assert_same_mesh(r, t)
    for fine, coarse in zip(tchain[1:], tchain[:-1]):
        # links point at the coarse boxes (the object before its relink)
        np.testing.assert_array_equal(fine.parent_mesh.lower, coarse.lower)
        np.testing.assert_array_equal(fine.parent_mesh.extent, coarse.extent)


def test_semicoarsen_refuses_unpaired():
    tm = tmesh.structured((3, 2))
    with pytest.raises(ValueError, match="partner"):
        tadapt.semicoarsen(tm, 0)


def test_npz_checkpoint_across_packages(tmp_path):
    rng = np.random.default_rng(12)
    rm, tm = rmesh.structured((3, 2)), tmesh.structured((3, 2))
    deg = rng.integers(1, 4, 6)
    rs, ts = saved_pair(RBasis(rm, deg), TBasis(tm, deg), 13)
    rpath, tpath = str(tmp_path / "r.npz"), str(tmp_path / "t.npz")
    rper.save_npz(rpath, rs)
    tper.save_npz(tpath, ts)
    for path in (rpath, tpath):
        r, t = rper.load_npz(path), tper.load_npz(path)
        np.testing.assert_array_equal(t.flat, np.asarray(r.flat))
        np.testing.assert_array_equal(t.basis.degrees, r.basis.degrees)
        assert t.basis.family == r.basis.family
        _assert_same_mesh(r.basis.mesh, t.basis.mesh)
    with np.load(rpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_convert_saved_state_carries_a_reference_state():
    rng = np.random.default_rng(14)
    rm, tm = rmesh.structured((2, 3)), tmesh.structured((2, 3))
    deg = rng.integers(1, 4, 6)
    rs, _ = saved_pair(RBasis(rm, deg), TBasis(tm, deg), 15)
    tb = TBasis(tm, rs.basis.degrees)
    ts = convert.saved_state(tb, rs.flat)
    deg2 = deg + 1
    want = rper.interpolate_to(rs, RBasis(rm, deg2))
    assert_close(tper.interpolate_to(ts, TBasis(tm, deg2), device=CPU), want,
                 1e-13)
    with pytest.raises(ValueError):
        convert.saved_state(tb, rs.flat[:-1])
