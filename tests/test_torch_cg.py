"""Port vs reference: the continuous Q_k space, its assembly and the
DG->CG coarse space, in f64.

* ``cg_basis``: ``wdof``, ``wval``, ``entity_dim``, ``boundary`` and
  ``n_dofs`` BITWISE on boxes (2D, 3D, k = 1..4), 2:1 hanging-node
  meshes, trilinear meshes and an imported annulus ring; ``gather``,
  ``scatter``, ``prolong``/``restrict`` and ``interpolate`` at 1e-13;
* ``assemble_cg_laplace``/``_mass``: the COO indices bitwise, the values
  at 1e-12, with scalar and tensor media and with geometry;
  ``cg_laplace_operator`` against the reference and against the
  assembled SpMV, ``cg_l2_functional``, at 1e-12;
* ``dg_to_cg_transfer`` (conforming and the hanging-node variant):
  tables bitwise, transfers at 1e-13, ``galerkin_dense`` at 1e-12;
  ``cg_coarse_solver`` (P1 and the Q_k route) at 1e-11;
* R9: on a mesh with per-element charts the reference's
  ``dg_to_cg_transfer`` unifies nothing (128 "vertices" on the 64-point
  annulus, where ``cg_basis(m, 1)`` has 64 dofs); the port refuses.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.assemble import cg as rcg
from hpdg_tpu.basis import cgbasis as rcgb
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.transfer import dgtocg as rdc

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import cg as tcg
from hpdg_tpu_torch.basis import cgbasis as tcgb
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.examples import unstructured_cg as tex
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.mesh import geometry as tgeo
from hpdg_tpu_torch.transfer import dgtocg as tdc

from test_torch_galerkin import assert_close, jx, rand_vec, to_port
from test_torch_trilinear import wavy2, wavy3

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    """The reference's Python matcher is the port's differential
    partner (and no test here builds the reference's native library)."""
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def _hanging(lib, adapt, dim):
    m0 = lib.structured((2,) * dim)
    marks = np.zeros(m0.n_elements, bool)
    marks[0] = True
    return adapt.refine_local(m0, adapt.close_marks(m0, marks))


@functools.lru_cache(maxsize=None)
def mesh_pair(case):
    """(reference mesh, port mesh), each built by its own package."""
    if case.startswith("box"):
        cells = {"box2": (3, 3), "box2r": (3, 2), "box3": (2, 2, 2),
                 "box3r": (3, 2, 2)}[case]
        return rmesh.structured(cells), tmesh.structured(cells)
    if case == "hang2":
        return _hanging(rmesh, radapt, 2), _hanging(tmesh, tadapt, 2)
    if case == "hang3":
        return _hanging(rmesh, radapt, 3), _hanging(tmesh, tadapt, 3)
    if case == "hang2x":  # several hanging faces, chains through corners
        marks = np.arange(9) % 2 == 0
        return (radapt.refine_local(rmesh.structured((3, 3)), marks),
                tadapt.refine_local(tmesh.structured((3, 3)), marks))
    if case == "tri2":
        return (rgeo.isoparametric(rmesh.structured((3, 2)), wavy2),
                tgeo.isoparametric(tmesh.structured((3, 2)), wavy2))
    if case == "tri3":
        return (rgeo.isoparametric(rmesh.structured((2, 2, 2)), wavy3),
                tgeo.isoparametric(tmesh.structured((2, 2, 2)), wavy3))
    if case == "ring":
        pts, cells = tex.annulus(8)
        return (rgeo.from_cell_vertices(pts, cells),
                tgeo.from_cell_vertices(pts, cells))
    raise ValueError(case)


@functools.lru_cache(maxsize=None)
def cg_pair(case, k):
    rm, tm = mesh_pair(case)
    return rcgb.cg_basis(rm, k), tcgb.cg_basis(tm, k, device=CPU)


def tv(a):
    return torch.as_tensor(np.asarray(a))


def close(want, got, tol):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    scale = max(float(np.abs(want).max()), 1e-300)
    assert np.abs(got - want).max() <= tol * scale


SPACES = [("box2", 1), ("box2", 2), ("box2r", 4), ("box3", 2),
          ("box3r", 3), ("hang2", 1), ("hang2", 3), ("hang2x", 2),
          ("hang3", 2), ("tri2", 2), ("tri3", 2), ("ring", 2)]


@pytest.mark.parametrize("case,k", SPACES)
def test_cg_basis_tables_bitwise(case, k):
    r, t = cg_pair(case, k)
    assert t.n_dofs == r.n_dofs and t.degree == r.degree
    for name in ("wdof", "wval", "entity_dim", "boundary"):
        a, b = getattr(r, name), getattr(t, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert t.conforming == r.conforming
    if case.startswith("hang"):
        assert not t.conforming


@pytest.mark.parametrize("case,k", SPACES)
def test_gather_scatter_prolong_restrict(case, k):
    r, t = cg_pair(case, k)
    rng = np.random.default_rng(k)
    x = rng.standard_normal(r.n_dofs)
    y = rng.standard_normal(r.wdof.shape[:2])
    close(r.gather(jnp.asarray(x)), t.gather(tv(x)), 1e-13)
    close(r.scatter(jnp.asarray(y)), t.scatter(tv(y)), 1e-13)
    close(r.prolong(jnp.asarray(x))[k], t.prolong(tv(x))[k], 1e-13)
    close(r.restrict({k: jnp.asarray(y)}), t.restrict({k: tv(y)}), 1e-13)
    # the two ops are adjoint, in f32 too
    lhs = float(torch.dot(t.gather(tv(x)).reshape(-1), tv(y).reshape(-1)))
    assert abs(lhs - float(torch.dot(tv(x), t.scatter(tv(y))))) \
        <= 1e-12 * max(1.0, abs(lhs))
    g32 = t.gather(tv(x).float())
    assert g32.dtype == torch.float32
    close(r.gather(jnp.asarray(x)), g32, 1e-6)
    f = lambda p: np.sin(p[..., 0]) * (1 + p[..., 1] ** 2)  # noqa: E731
    np.testing.assert_array_equal(t.interpolate(f), r.interpolate(f))


def test_cg_basis_refuses_what_the_reference_refuses():
    _, tm = mesh_pair("box2")
    with pytest.raises(ValueError):
        tcgb.cg_basis(tm, 0, device=CPU)
    with pytest.raises(ValueError, match="endpoint"):
        tcgb.cg_basis(tm, 2, family="legendre", device=CPU)


def k_scalar(x, lib):
    return 1.0 + 0.5 * lib.sin(3.0 * x[..., 0]) * x[..., 1] ** 2


def k_tensor(x, lib):
    d = x.shape[-1]
    eye = lib.eye(d, dtype=x.dtype)
    if lib is torch:
        eye = eye.to(x.device)
    s = (1.0 + 0.3 * x[..., 0] ** 2)[..., None, None]
    off = 0.2 * (lib.ones((d, d), dtype=x.dtype) - eye)
    if lib is torch:
        off = off.to(x.device)
    return s * eye + off


ASSEMBLED = [("box2", 2, None, False), ("box2", 3, "scalar", True),
             ("box3", 2, "tensor", True), ("hang2", 2, None, True),
             ("hang2x", 1, "scalar", False), ("tri2", 2, None, True),
             ("tri3", 2, "scalar", False), ("ring", 2, None, True)]


def media(kind):
    if kind is None:
        return None, None
    f = k_scalar if kind == "scalar" else k_tensor
    return (lambda x: f(x, jnp)), (lambda x: f(x, torch))


@pytest.mark.parametrize("case,k,medium,dirichlet", ASSEMBLED)
def test_assembled_cg_matrices(case, k, medium, dirichlet):
    r, t = cg_pair(case, k)
    rk, tk = media(medium)
    for R, T in ((rcg.assemble_cg_laplace(r, rk, dirichlet=dirichlet),
                  tcg.assemble_cg_laplace(t, tk, dirichlet=dirichlet)),
                 (rcg.assemble_cg_mass(r, dirichlet=dirichlet),
                  tcg.assemble_cg_mass(t, dirichlet=dirichlet))):
        assert T.n == R.n
        np.testing.assert_array_equal(T.rows, R.rows)
        np.testing.assert_array_equal(T.cols, R.cols)
        close(R.vals, T.vals, 1e-12)
        x = np.random.default_rng(3).standard_normal(R.n)
        close(R.matvec(jnp.asarray(x)), T.matvec(tv(x)), 1e-12)
        np.testing.assert_allclose(T.todense(), R.todense(), rtol=0,
                                   atol=1e-12 * np.abs(R.todense()).max())


@pytest.mark.parametrize("case,k,medium,dirichlet", ASSEMBLED)
def test_matrixfree_cg_operator_and_functional(case, k, medium, dirichlet):
    r, t = cg_pair(case, k)
    rk, tk = media(medium)
    x = np.random.default_rng(4).standard_normal(r.n_dofs)
    want = rcg.cg_laplace_operator(r, rk, dirichlet=dirichlet)(
        jnp.asarray(x))
    got = tcg.cg_laplace_operator(t, tk, dirichlet=dirichlet)(tv(x))
    close(want, got, 1e-12)
    close(tcg.assemble_cg_laplace(t, tk, dirichlet=dirichlet).matvec(tv(x)),
          got, 1e-12)
    f = lambda p, lib: lib.exp(-p[..., 0] ** 2) * (1 + p[..., 1])  # noqa: E731
    close(rcg.cg_l2_functional(r, lambda p: f(p, jnp), dirichlet=dirichlet),
          tcg.cg_l2_functional(t, lambda p: f(p, torch),
                               dirichlet=dirichlet), 1e-12)


@pytest.mark.parametrize("case", ["box2r", "box3", "hang2x", "hang3"])
def test_dg_to_cg_transfer(case):
    rm, tm = mesh_pair(case)
    rb = RBasis(rm, np.ones(rm.n_elements, np.int32))
    tb = TBasis(tm, np.ones(tm.n_elements, np.int32))
    R, T = rdc.dg_to_cg_transfer(rb), tdc.dg_to_cg_transfer(tb)
    assert type(T).__name__ == type(R).__name__
    assert T.n_vertices == R.n_vertices
    names = ("wdof", "wval") if case.startswith("hang") else \
        ("vertices", "vmap")
    for name in names:
        a, b = getattr(R, name), getattr(T, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    xv = np.random.default_rng(1).standard_normal(R.n_vertices)
    close(R.prolong(jnp.asarray(xv))[1], T.prolong(tv(xv))[1], 1e-13)
    r = rand_vec(rb, 2)
    close(R.restrict(jx(r)), T.restrict({1: tv(r[1])}), 1e-13)
    RA = r_laplace(rb, penalty=3.0, dirichlet=True)
    close(R.galerkin_dense(RA), T.galerkin_dense(to_port(RA)), 1e-12)


@pytest.mark.parametrize("case,k", [("box2", 1), ("hang2x", 1),
                                    ("box2r", 2), ("tri2", 2), ("ring", 2),
                                    ("hang3", 2)])
def test_cg_coarse_solvers(case, k):
    rm, tm = mesh_pair(case)
    rb = RBasis(rm, np.full(rm.n_elements, k))
    tb = TBasis(tm, np.full(tm.n_elements, k))
    RA = r_laplace(rb, penalty=4.0, dirichlet=True)
    TA = to_port(RA)
    b = rand_vec(rb, 9)
    want = rdc.cg_coarse_solver(rb, RA)(jx(b))
    got = tdc.cg_coarse_solver(tb, TA)({k: tv(b[k])})
    assert_close(want, got, 1e-11)
    if k > 1:
        r_cg, t_cg = cg_pair(case, k)
        close(rdc.cg_qk_galerkin_dense(r_cg, rb, RA),
              tdc.cg_qk_galerkin_dense(t_cg, tb, TA), 1e-12)
        got32 = tdc.cg_qk_coarse_solver(tb, TA, dtype=torch.float32)(
            {k: tv(b[k])})
        assert got32[k].dtype == torch.float32
        assert_close(want, got32, 1e-6)


def test_r9_per_element_charts_are_refused():
    """R9: the reference's annulus (16 hexes on 64 points) through its own
    ``dg_to_cg_transfer`` gives 128 'vertices' (the parametric boxes of
    per-element charts share no corner), while the physical CG-P1 space
    has 64 dofs; the port refuses the transfer and the P1 coarse solver,
    and its CG-Q_k route unifies the physical nodes."""
    pts, cells = tex.annulus(16)
    rm = rgeo.from_cell_vertices(pts, cells)
    tm = tgeo.from_cell_vertices(pts, cells)
    assert len(pts) == 64 and rm.n_elements == 16
    rb = RBasis(rm, np.ones(16, np.int32))
    assert rdc.dg_to_cg_transfer(rb).n_vertices == 128
    assert rcgb.cg_basis(rm, 1).n_dofs == 64
    assert tcgb.cg_basis(tm, 1, device=CPU).n_dofs == 64
    tb = TBasis(tm, np.ones(16, np.int32))
    assert tgeo.has_element_charts(tm)
    with pytest.raises(ValueError, match="per-element charts"):
        tdc.dg_to_cg_transfer(tb)
    with pytest.raises(ValueError, match="per-element charts"):
        tdc.dg_to_cg_transfer_nc(tb)
    TA = to_port(r_laplace(rb, penalty=4.0, dirichlet=True))
    with pytest.raises(ValueError, match="per-element charts"):
        tdc.cg_coarse_solver(tb, TA)
    # the one global chart of a lattice import is served
    lm = tgeo.from_hex_lattice(*_lattice_hexes(), (2, 2, 1))
    assert not tgeo.has_element_charts(lm)
    lb = TBasis(lm, np.ones(lm.n_elements, np.int32))
    assert tdc.dg_to_cg_transfer(lb).n_vertices == 18


def _lattice_hexes():
    g = np.stack(np.meshgrid(np.arange(3.0), np.arange(3.0), np.arange(2.0),
                             indexing="ij"), -1).reshape(-1, 3)
    idx = lambda i, j, k: (i * 3 + j) * 2 + k  # noqa: E731
    cells = [[idx(i, j, 0), idx(i + 1, j, 0), idx(i + 1, j + 1, 0),
              idx(i, j + 1, 0), idx(i, j, 1), idx(i + 1, j, 1),
              idx(i + 1, j + 1, 1), idx(i, j + 1, 1)]
             for i in range(2) for j in range(2)]
    return g, np.asarray(cells)
