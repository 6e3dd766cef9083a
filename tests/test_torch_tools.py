"""Port vs reference: the penalty-only and weighted face-mass forms, the
grid-function and sub-grid tools, the VTU writer and the utilities, in
f64.

* ``assemble_penalty_only`` at 1e-12 on mixed-degree 2D and 3D boxes
  and a trilinear mesh, and the identity ``A(sigma) - A(0) = A_pen``;
  ``assemble_weighted_face_mass`` at 1e-12;
* ``gridfunction.locate`` bitwise and ``evaluate`` (values, gradients)
  at 1e-12, on boxes and a hanging-node mesh;
* ``subgrid``: the containment map bitwise, the host function on the
  sub quadrature, the cross functional and the sub-to-host interpolant
  at 1e-12;
* ``write_vtu``: the file BYTE-identical to the reference's;
* ``utils``: ``parse_cli`` trees equal to the reference's, ``Timer``,
  ``profile_region`` and a trace file, checkpoints restored bit for bit
  with the reference's metadata and the reference manager's rotation.
"""

import json

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble.sipg import assemble_penalty_only as r_pen
from hpdg_tpu.assemble.sipg import assemble_weighted_face_mass as r_wfm
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks import gridfunction as rgf
from hpdg_tpu.blocks import plot as rplot
from hpdg_tpu.blocks import subgrid as rsub
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.utils import checkpoint as rck
from hpdg_tpu.utils import config as rcfg

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble.sipg import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble.sipg import assemble_penalty_only as t_pen
from hpdg_tpu_torch.assemble.sipg import assemble_weighted_face_mass as t_wfm
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import gridfunction as tgf
from hpdg_tpu_torch.blocks import plot as tplot
from hpdg_tpu_torch.blocks import subgrid as tsub
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.mesh import geometry as tgeo
from hpdg_tpu_torch import utils as tutils
from hpdg_tpu_torch.utils import checkpoint as tck
from hpdg_tpu_torch.utils import config as tcfg
from hpdg_tpu_torch.utils import timer as ttimer

from test_torch_galerkin import assert_close, jx, rand_vec
from test_torch_trilinear import wavy2

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def tt(x):
    return {p: torch.as_tensor(np.asarray(v)) for p, v in x.items()}


def pair(case, seed=1, pmax=3):
    """(reference basis, port basis) with seeded degrees in 1..pmax."""
    if case == "box2":
        rm, tm = rmesh.structured((3, 3)), tmesh.structured((3, 3))
    elif case == "box3":
        rm, tm = rmesh.structured((2, 2, 2)), tmesh.structured((2, 2, 2))
    elif case == "hang2":
        marks = np.array([True, False, False, False])
        rm = radapt.refine_local(rmesh.structured((2, 2)), marks)
        tm = tadapt.refine_local(tmesh.structured((2, 2)), marks)
    elif case == "tri2":
        rm = rgeo.isoparametric(rmesh.structured((3, 2)), wavy2)
        tm = tgeo.isoparametric(tmesh.structured((3, 2)), wavy2)
    else:
        raise ValueError(case)
    deg = np.random.default_rng(seed).integers(1, pmax + 1, rm.n_elements)
    return RBasis(rm, deg), TBasis(tm, deg)


@pytest.mark.parametrize("case,dirichlet", [
    ("box2", True), ("box2", False), ("box3", True), ("box3", False),
    ("tri2", True), ("hang2", True)])
def test_penalty_only_matches_reference(case, dirichlet):
    rb, tb = pair(case)
    want = r_pen(rb, penalty=2.5, dirichlet=dirichlet)
    got = t_pen(tb, penalty=2.5, dirichlet=dirichlet, device=CPU)
    assert got.pattern.entries.keys() == want.pattern.entries.keys()
    assert_close(want.values, got.values, 1e-12)


@pytest.mark.parametrize("cells", [(3, 3), (4, 2), (2, 2, 2)])
def test_penalty_only_is_the_penalty_part(cells):
    """A(sigma) - A(0) = A_pen, as dense matrices (p = 2, Dirichlet)."""
    m = tmesh.structured(cells)
    tb = TBasis(m, np.full(m.n_elements, 2))
    A1 = t_laplace(tb, penalty=3.0, dirichlet=True, device=CPU)
    A0 = t_laplace(tb, penalty=0.0, dirichlet=True, device=CPU)
    P = t_pen(tb, penalty=3.0, dirichlet=True, device=CPU)
    D = tbm.to_dense(A1, tb) - tbm.to_dense(A0, tb)
    Pd = tbm.to_dense(P, tb)
    assert np.abs(Pd - D).max() <= 1e-12 * np.abs(Pd).max()
    assert np.linalg.eigvalsh(Pd).min() > -1e-11


@pytest.mark.parametrize("case", ["box2", "box3", "tri2"])
def test_weighted_face_mass_matches_reference(case):
    rb, tb = pair(case, seed=2)
    w = rand_vec(rb, 4)
    want = r_wfm(rb, jx(w), penalty=3.0)
    got = t_wfm(tb, tt(w), penalty=3.0, device=CPU)
    assert_close(want.values, got.values, 1e-12)
    # a continuous weight field gives the zero form
    lin = {p: torch.as_tensor(tb.node_positions(p).sum(-1))
           for p in tb.bucket_degrees}
    if case != "tri2":
        Z = t_wfm(tb, lin, penalty=3.0, device=CPU)
        assert max(float(v.abs().max()) for v in Z.values.values()) < 1e-12


@pytest.mark.parametrize("case", ["box2", "box3", "hang2"])
def test_locate_and_evaluate(case):
    rb, tb = pair(case, seed=3)
    dim = rb.mesh.dim
    x = rand_vec(rb, 5)
    pts = np.random.default_rng(6).random((40, dim))
    pts[0] = 0.0      # a shared corner: the lowest id wins
    pts[1] = 0.5      # an interior vertex
    np.testing.assert_array_equal(tgf.locate(tb.mesh, pts),
                                  rgf.locate(rb.mesh, pts))
    rv = rgf.evaluate(rb, jx(x), pts)
    tv_ = tgf.evaluate(tb, tt(x), pts)
    np.testing.assert_allclose(tv_, rv, rtol=0,
                               atol=1e-12 * np.abs(rv).max())
    rv, rg = rgf.evaluate(rb, jx(x), pts, gradient=True)
    tv_, tg = tgf.evaluate(tb, tt(x), pts, gradient=True)
    np.testing.assert_allclose(tv_, rv, rtol=0,
                               atol=1e-12 * np.abs(rv).max())
    np.testing.assert_allclose(tg, rg, rtol=0,
                               atol=1e-12 * np.abs(rg).max())
    with pytest.raises(ValueError):
        tgf.evaluate(tb, tt(x), np.full((1, dim), 7.0))


def _lshape_mask(n):
    mask = np.ones((n, n), dtype=bool)
    mask[n // 2:, n // 2:] = False
    return mask


@pytest.mark.parametrize("refined", [False, True])
def test_subgrid_maps_and_cross_evaluation(refined):
    rh, th = rmesh.structured((4, 4)), tmesh.structured((4, 4))
    rs = rmesh.structured((4, 4), mask=_lshape_mask(4))
    ts = tmesh.structured((4, 4), mask=_lshape_mask(4))
    if refined:
        marks = np.random.default_rng(3).random(12) < 0.4
        rs, ts = radapt.refine_local(rs, marks), tadapt.refine_local(ts, marks)
    rmap, tmap = rsub.subgrid_map(rh, rs), tsub.subgrid_map(th, ts)
    np.testing.assert_array_equal(tmap.sub_to_host, rmap.sub_to_host)
    np.testing.assert_array_equal(tmap.host_to_sub, rmap.host_to_sub)
    rng = np.random.default_rng(4)
    hdeg = rng.integers(1, 4, 16)
    sdeg = rng.integers(1, 4, rs.n_elements)
    rhb, thb = RBasis(rh, hdeg), TBasis(th, hdeg)
    rsb, tsb = RBasis(rs, sdeg), TBasis(ts, sdeg)
    xh = rand_vec(rhb, 7)
    rq, rw = rsub.host_function_on_sub_quad(rhb, jx(xh), rsb, rmap)
    tq, tw = tsub.host_function_on_sub_quad(thb, tt(xh), tsb, tmap)
    for p in rq:
        np.testing.assert_allclose(tq[p], np.asarray(rq[p]), rtol=0,
                                   atol=1e-12 * np.abs(rq[p]).max())
        np.testing.assert_array_equal(tw[p], rw[p])
    assert_close(rsub.l2_functional_from_host(rsb, rhb, jx(xh), rmap),
                 tsub.l2_functional_from_host(tsb, thb, tt(xh), tmap,
                                              device=CPU), 1e-12)
    if not refined:
        xs = rand_vec(rsb, 8)
        assert_close(rsub.sub_function_on_host(rsb, jx(xs), rhb, rmap,
                                               fill=7.0),
                     tsub.sub_function_on_host(tsb, tt(xs), thb, tmap,
                                               fill=7.0, device=CPU), 1e-12)


@pytest.mark.parametrize("case,with_x", [("box2", True), ("box2", False),
                                         ("box3", True), ("hang2", True),
                                         ("tri2", True)])
def test_write_vtu_byte_identical(case, with_x, tmp_path):
    rb, tb = pair(case, seed=5)
    x = rand_vec(rb, 9) if with_x else None
    rplot.write_vtu(str(tmp_path / "r.vtu"), rb,
                    jx(x) if with_x else None, name="phi")
    tplot.write_vtu(str(tmp_path / "t.vtu"), tb,
                    tt(x) if with_x else None, name="phi")
    assert (tmp_path / "t.vtu").read_bytes() == \
        (tmp_path / "r.vtu").read_bytes()


@pytest.mark.parametrize("argv", [
    [], ["--n", "6", "--p=3"], ["--solver.tol", "1e-9", "--verbose"],
    ["--cells", "8,2,2", "--x64", "false", "--name", "run1"]])
def test_parse_cli_matches_reference(argv):
    want = rcfg.parse_cli(argv)
    got = tcfg.parse_cli(argv)
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    t = tcfg.ParameterTree()
    t.set("a.b.c", 1)
    assert t.get_path("a.b.c") == 1 and t.get_path("a.x", 5) == 5
    assert isinstance(t.sub("a"), tcfg.ParameterTree)
    with pytest.raises(ValueError):
        tcfg.parse_cli(["positional"])


def test_utils_exports_the_reference_names():
    import hpdg_tpu.utils as rutils
    for n in ("ParameterTree", "parse_cli", "Timer", "profile_region"):
        assert hasattr(rutils, n) and hasattr(tutils, n)


def test_timer_and_trace(tmp_path):
    t = tutils.Timer()
    y = {1: torch.ones(3) * 2}
    s = t.elapsed(y)
    assert s >= 0.0 and t.elapsed() >= s
    t.reset()
    assert t.elapsed() < s + 1.0
    ttimer.start_trace(str(tmp_path))
    with tutils.profile_region("hpdg-region"):
        z = torch.ones(8) @ torch.ones(8)
    path = ttimer.stop_trace()
    assert float(z) == 8.0
    assert path.startswith(str(tmp_path))
    assert "hpdg-region" in open(path).read()


def test_solver_state_checkpoint_roundtrip(tmp_path):
    rb, tb = pair("box2", seed=6)
    x = rand_vec(rb, 10)
    tck.save_solver_state(tmp_path / "t", tt(x), tb.degrees, iteration=7,
                          cells=(3, 3), extra={"tag": "a"})
    rck.save_solver_state(tmp_path / "r", jx(x), rb.degrees, iteration=7,
                          cells=(3, 3), extra={"tag": "a"})
    y, meta = tck.load_sharded(tmp_path / "t", device=CPU)
    assert meta == json.loads((tmp_path / "r" / "meta.json").read_text())
    assert y.keys() == x.keys()
    for p in x:
        assert torch.equal(y[p], torch.as_tensor(x[p]))
    # restoring into a one-process shard layout slices its rows
    from hpdg_tpu_torch.parallel.comm import ShardGroup, Sharding
    g = ShardGroup(1, CPU)
    lay = {p: Sharding(g, x[p].shape[0]) for p in x}
    z, _ = tck.load_sharded(tmp_path / "t", shardings=lay)
    assert all(torch.equal(z[p], y[p]) for p in x)


def test_checkpoint_manager_rotation_and_restore(tmp_path):
    rb, tb = pair("box3", seed=7)
    states = [rand_vec(rb, s) for s in range(7)]
    tm = tck.SolverCheckpointManager(tmp_path / "t", max_to_keep=3,
                                     save_every=2)
    rm = rck.SolverCheckpointManager(tmp_path / "r", max_to_keep=3,
                                     save_every=2)
    saved = [tm.save(s, tt(x)) for s, x in enumerate(states)]
    rsaved = [rm.save(s, jx(x)) for s, x in enumerate(states)]
    rm.close()
    assert saved == rsaved
    assert tm.steps() == sorted(rm.steps()) == [2, 4, 6]
    assert tm.latest_step() == rm.latest_step() == 6
    assert tm.save(6, tt(states[0])) is False   # not later than the latest
    for step in (None, 4):
        got = tm.restore(step, device=CPU)
        want = states[6 if step is None else step]
        for p in want:
            assert torch.equal(got[p], torch.as_tensor(want[p]))
    from hpdg_tpu_torch.parallel.comm import ShardGroup, Sharding
    g = ShardGroup(1, CPU)
    lay = {p: Sharding(g, states[6][p].shape[0]) for p in states[6]}
    got = tm.restore(shardings=lay)
    assert all(torch.equal(got[p], torch.as_tensor(states[6][p]))
               for p in lay)
    tm.close()
