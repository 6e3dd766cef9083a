"""Port vs reference: local refinement with 2:1 balance, bitwise.

refine_local / close_marks / _levels on 2D and 3D box meshes from the
same numpy marks: element boxes, refinement links, the interior face
lists (with the hanging-face codes) and the boundary faces must agree
bit for bit — both packages run the same host numpy algorithm.
"""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.mesh import adaptive as radapt

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.mesh import adaptive as tadapt


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def _assert_same_mesh(rm, tm):
    for name in ("lower", "extent", "parent", "child_pos"):
        a, b = getattr(rm, name), getattr(tm, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("inside", "outside", "axis", "nc_code"):
        np.testing.assert_array_equal(getattr(rm.faces, name),
                                      getattr(tm.faces, name), err_msg=name)
    for name in ("elem", "axis", "side"):
        np.testing.assert_array_equal(getattr(rm.bfaces, name),
                                      getattr(tm.bfaces, name), err_msg=name)


def _refine_both(cells, seeds, frac):
    """Refine both packages' meshes len(seeds) times with the same
    random marks (fraction ``frac`` per round)."""
    rm, tm = rmesh.structured(cells), tmesh.structured(cells)
    for s in seeds:
        marks = np.random.default_rng(s).random(rm.n_elements) < frac
        np.testing.assert_array_equal(radapt._levels(rm), tadapt._levels(tm))
        np.testing.assert_array_equal(radapt.close_marks(rm, marks),
                                      tadapt.close_marks(tm, marks))
        rm, tm = radapt.refine_local(rm, marks), tadapt.refine_local(tm, marks)
        _assert_same_mesh(rm, tm)
    return rm, tm


@pytest.mark.parametrize("cells,seeds,frac", [
    ((2, 2), (0,), 0.5), ((4, 4), (3, 4), 0.3), ((2, 2, 2), (3,), 0.3),
    ((2, 3, 2), (5, 6), 0.25), ((6,), (1, 2, 3), 0.4)])
def test_refine_local_matches_reference(cells, seeds, frac):
    rm, tm = _refine_both(cells, seeds, frac)
    assert tm.parent_mesh is not None


def test_close_marks_propagates_two_levels():
    """A mark next to a twice-refined corner forces its neighbours:
    the closure (not just the marks) must agree."""
    rm, tm = _refine_both((4, 4), (), 0.0)
    corner = np.zeros(16, bool)
    corner[0] = True
    rm, tm = radapt.refine_local(rm, corner), tadapt.refine_local(tm, corner)
    corner2 = np.zeros(rm.n_elements, bool)
    corner2[3] = True  # a child of element 0, at its inner corner
    rm, tm = radapt.refine_local(rm, corner2), tadapt.refine_local(tm, corner2)
    _assert_same_mesh(rm, tm)
    marks = np.zeros(rm.n_elements, bool)
    marks[rm.n_elements - 1] = True
    marks[int(np.argmin(rm.volumes))] = True
    closed = tadapt.close_marks(tm, marks)
    np.testing.assert_array_equal(radapt.close_marks(rm, marks), closed)
    assert closed.sum() > marks.sum()
    assert (tm.faces.nc_code > 0).any()


def test_hanging_fixture_faces():
    """The hanging-node fixture of the reference's tests (2x2 with two
    refined elements): 8 hanging half-faces."""
    marks = np.array([False, True, True, False])
    rm = radapt.refine_local(rmesh.structured((2, 2)), marks)
    tm = tadapt.refine_local(tmesh.structured((2, 2)), marks)
    _assert_same_mesh(rm, tm)
    assert int((tm.faces.nc_code > 0).sum()) == 8
    with pytest.raises(NotImplementedError, match="mesh.adaptive"):
        tmesh.refine(tm, marks=np.ones(tm.n_elements, bool))
