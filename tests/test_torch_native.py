"""The port's native host kernels (``hpdg_tpu_torch.native``, built from
``cpp/meshkit.cc`` into ``hpdg_tpu_torch/_build/``) against the
reference's Python and XLA routes.

* ``build_faces`` against the port's and the reference's numpy face
  matchers, compared canonically (the native kernel orders faces its own
  way): conforming 2D and 3D, 2:1 hanging-node meshes and a mesh with
  more interior faces than ``dim * n``; ``from_boxes(topology=)``
  routes and refusals;
* ``frame_cells`` against the Python BFS of ``from_cell_vertices``:
  equal frames and faces, None (the Python route) on twisted imports,
  and each refusal;
* ``uniform_sipg_factorized_host`` against the port's torch f64
  ``uniform_sipg_factorized`` and the reference's XLA one at 1e-12, and
  its guards;
* four processes building the library at once into an empty directory
  all load it and agree; a compile failure raises.

The reference's own native library is never built here (its in-place
``g++ -o`` races under parallel workers).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.matrixfree.uniform import uniform_sipg_factorized as r_fact
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.mesh.adaptive import refine_local as r_refine_local

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch import native
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.matrixfree.uniform import (uniform_sipg_factorized,
                                               uniform_sipg_factorized_host)
from hpdg_tpu_torch.mesh import geometry as tgeo
from hpdg_tpu_torch.mesh.adaptive import refine_local as t_refine_local

from test_torch_cellimport import FIXTURES, TWISTED

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ on the PATH: the native "
                                "host kernels cannot be built")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    # the reference takes its Python routes (its native library would be
    # built in place); the port's native routes are asked for explicitly
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def canon(faces):
    return sorted(zip(faces.inside.tolist(), faces.outside.tolist(),
                      faces.axis.tolist(), faces.nc_code.tolist()))


def canon_b(bf):
    return sorted(zip(bf.elem.tolist(), bf.axis.tolist(), bf.side.tolist()))


def checkerboard():
    m = rmesh.structured((8, 8))
    idx = np.arange(64)
    return r_refine_local(m, (idx // 8 + idx % 8) % 2 == 0)


BOX_MESHES = {
    "conforming2d": lambda: rmesh.structured((5, 4)),
    "conforming3d": lambda: rmesh.structured((3, 2, 4)),
    "hanging2d": lambda: r_refine_local(rmesh.structured((2, 2)),
                                        np.array([True, False, False, True])),
    "hanging3d": lambda: r_refine_local(rmesh.structured((2, 1, 1)),
                                        np.array([True, False])),
    "above_naive_cap": checkerboard,
}


@pytest.mark.parametrize("name", sorted(BOX_MESHES))
def test_build_faces_matches_the_python_matchers(name):
    rm = BOX_MESHES[name]()
    nat = tmesh.from_boxes(rm.lower, rm.extent, topology="native")
    py = tmesh.from_boxes(rm.lower, rm.extent, topology="python")
    assert canon(nat.faces) == canon(py.faces) == canon(rm.faces)
    assert canon_b(nat.bfaces) == canon_b(py.bfaces) == canon_b(rm.bfaces)
    if name == "above_naive_cap":
        assert len(nat.faces) > nat.dim * nat.n_elements


def test_from_boxes_routes(monkeypatch):
    m = rmesh.structured((16, 16, 16))  # 4096 elements: "auto" is native
    py = tmesh.from_boxes(m.lower, m.extent, topology="python")
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "1")
    auto = tmesh.from_boxes(m.lower, m.extent)
    nat = tmesh.from_boxes(m.lower, m.extent, topology="native")
    for f in ("inside", "outside", "axis", "nc_code"):
        np.testing.assert_array_equal(getattr(auto.faces, f),
                                      getattr(nat.faces, f))
    assert canon(auto.faces) == canon(py.faces)
    assert canon_b(auto.bfaces) == canon_b(py.bfaces)
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")
    off = tmesh.from_boxes(m.lower, m.extent)
    np.testing.assert_array_equal(off.faces.inside, py.faces.inside)
    with pytest.raises(ValueError, match="topology"):
        tmesh.from_boxes(m.lower, m.extent, topology="cpp")
    # without g++: "auto" takes the Python matcher, "native" refuses
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "1")
    assert not native.available()
    auto = tmesh.from_boxes(m.lower, m.extent)
    np.testing.assert_array_equal(auto.faces.inside, py.faces.inside)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tmesh.from_boxes(m.lower, m.extent, topology="native")


@pytest.mark.parametrize("name", ["lattice2d", "lattice3d", "ring2d",
                                  "ring3d"] + TWISTED)
def test_frame_cells_matches_the_python_bfs(name, monkeypatch):
    pts, cells = FIXTURES[name]()
    seen = []
    frame_cells = native.frame_cells

    def spy(cells_bit, dim):
        seen.append(frame_cells(cells_bit, dim))
        return seen[-1]

    monkeypatch.setattr(native, "frame_cells", spy)
    py = tgeo.from_cell_vertices(pts, cells)
    rm = rgeo.from_cell_vertices(pts, cells)
    assert not seen
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "1")
    nat = tgeo.from_cell_vertices(pts, cells)
    assert len(seen) == 1
    # twisted faces: rc 2, the Python path assigns the twist codes
    assert (seen[0] is None) == (name in TWISTED)
    face_set = lambda m: {(int(i), int(o), int(a)) for i, o, a in zip(  # noqa: E731
        m.faces.inside, m.faces.outside, m.faces.axis)}
    assert face_set(nat) == face_set(py) == face_set(rm)
    assert canon_b(nat.bfaces) == canon_b(py.bfaces)
    for f in ("corners", "jac", "shift", "lower", "extent"):
        a, b = getattr(nat, f), getattr(py, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_frame_cells_refusals(monkeypatch):
    from hpdg_tpu_torch.examples import meshes
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "1")
    pts, cells = meshes.lattice((2, 2))
    with pytest.raises(ValueError, match="disconnected"):  # rc 3
        tgeo.from_cell_vertices(np.concatenate([pts, pts + 100.0]),
                                np.concatenate([cells, cells + len(pts)]))
    pts, cells = meshes.lattice((2, 1))
    with pytest.raises(ValueError, match="more than two"):  # rc 1
        tgeo.from_cell_vertices(pts, np.concatenate([cells, cells[:1]]))
    with pytest.raises(ValueError, match="degenerate"):  # rc 4
        native.frame_cells(np.arange(4, dtype=np.int64).reshape(2, 2), 1)


FACT_CASES = [((4, 4, 4), 2), ((3, 3, 3), 4), ((6, 2, 3), 3), ((1, 4, 2), 2)]


@pytest.mark.parametrize("cells,p", FACT_CASES,
                         ids=["x".join(map(str, c)) + f"-p{p}"
                              for c, p in FACT_CASES])
def test_factorized_host_matches_torch_and_xla(cells, p):
    n = int(np.prod(cells))
    tb = TBasis(tmesh.structured(cells), np.full(n, p))
    rb = RBasis(rmesh.structured(cells), np.full(n, p))
    u = np.random.default_rng(1887).standard_normal((n, (p + 1) ** 3))
    for diri in (False, True):
        for sc in ("measure", "normal"):
            nat = uniform_sipg_factorized_host(tb, 2.0, diri, sc)(u)
            tt = uniform_sipg_factorized(tb, 2.0, diri, torch.float64, sc,
                                         device=CPU)
            xla = r_fact(rb, 2.0, diri, jnp.float64, sc)
            for other in (tt({p: torch.as_tensor(u)})[p].numpy(),
                          np.asarray(xla({p: jnp.asarray(u)})[p])):
                err = np.abs(nat - other).max() / np.abs(other).max()
                assert err <= 1e-12, (diri, sc, err)


def test_factorized_host_guards():
    with pytest.raises(ValueError, match="3D"):
        uniform_sipg_factorized_host(TBasis(tmesh.structured((3, 3)),
                                            np.full(9, 2)))
    m3 = tmesh.structured((2, 2, 2))
    with pytest.raises(ValueError, match="single degree"):
        uniform_sipg_factorized_host(TBasis(m3, np.array([2] * 4 + [3] * 4)))
    with pytest.raises(ValueError, match="uniform extents"):
        fine = t_refine_local(m3, np.arange(8) == 0)
        uniform_sipg_factorized_host(TBasis(fine,
                                            np.full(fine.n_elements, 2)))
    with pytest.raises(ValueError, match="general geometry"):
        uniform_sipg_factorized_host(TBasis(
            tgeo.affine_image(m3, np.diag([1.0, 1.0, 1.0])), np.full(8, 2)))
    nat = uniform_sipg_factorized_host(TBasis(m3, np.full(8, 1)))
    with pytest.raises(ValueError, match="size mismatch"):
        nat(np.zeros((8, 7)))


BUILD = r'''
import sys
import numpy as np
from hpdg_tpu_torch import native
native.build(sys.argv[1])
lower = np.stack(np.meshgrid(*[np.arange(c) for c in (6, 5, 4)],
                             indexing="ij"), -1).reshape(-1, 3) * 1.0
res = native.build_faces(lower, np.ones_like(lower), 1e-6)
print(sum(int(np.asarray(a, np.int64) @ np.arange(len(a))) for a in res))
'''


def test_concurrent_builds_are_atomic(tmp_path):
    out = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for _ in range(4)]
    logs = [pr.communicate(timeout=120)[0].decode() for pr in procs]
    assert all(pr.returncode == 0 for pr in procs), logs
    assert len(set(logs)) == 1, logs
    files = sorted(f.name for f in out.iterdir())
    assert files == [native.library_path(build_dir=out).name], files


def test_compile_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed"):
        native.build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*"))
