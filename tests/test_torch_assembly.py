"""Port vs reference: SIPG assembly and the L2 load vector, in f64.

assemble_laplace values at 1e-12 of max|A| (both penalty scalings,
Dirichlet on and off, uniform and mixed degrees); l2_functional at 1e-13
of max|b|.  The sums of the two packages run in another order, so the
bounds sit a few hundred ulps above f64 roundoff.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_assemble
from hpdg_tpu.assemble import l2_functional as r_l2
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_assemble
from hpdg_tpu_torch.assemble import l2_functional as t_l2
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the tests run in several worker processes on one machine: one
    # thread each for torch and numpy's BLAS keeps them from
    # oversubscribing its cores
    with threadpool_limits(1):
        yield


def _pair(cells, degrees, upper=None):
    rm = rmesh.structured(cells, upper=upper)
    tm = tmesh.structured(cells, upper=upper)
    return RBasis(rm, degrees), TBasis(tm, degrees)


CASES = [((4, 2, 3), 2, (1.0, 0.5, 1.5)), ((3, 3), 4, None),
         ((2, 2, 2), 1, None)]


@pytest.mark.parametrize("cells,p,upper", CASES)
@pytest.mark.parametrize("scaling", ["measure", "normal"])
@pytest.mark.parametrize("dirichlet", [True, False])
def test_assemble_laplace_matches_reference(cells, p, upper, scaling,
                                            dirichlet):
    n = int(np.prod(cells))
    rb, tb = _pair(cells, np.full(n, p), upper)
    kw = dict(penalty=3.0, dirichlet=dirichlet, penalty_scaling=scaling)
    RA = r_assemble(rb, dtype=jnp.float64, **kw)
    TA = t_assemble(tb, dtype=torch.float64, **kw, device=CPU)
    assert RA.values.keys() == TA.values.keys()
    scale = max(float(np.abs(np.asarray(v)).max()) for v in RA.values.values())
    for k in RA.values:
        d = np.abs(np.asarray(RA.values[k]) - TA.values[k].numpy()).max()
        assert d <= 1e-12 * scale, (k, d / scale)
    np.testing.assert_allclose(rbm.to_dense(RA, rb), tbm.to_dense(TA, tb),
                               rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("dg_form,sigma1", [("sipg", 0.0), ("nipg", 0.7)])
def test_assemble_mixed_degrees_and_forms(dg_form, sigma1):
    degrees = np.array([1, 2, 3, 2, 1, 2])
    rb, tb = _pair((3, 2), degrees)
    kw = dict(penalty=4.0, dirichlet=True, dg_form=dg_form, sigma1=sigma1)
    Rd = rbm.to_dense(r_assemble(rb, dtype=jnp.float64, **kw), rb)
    Td = tbm.to_dense(t_assemble(tb, **kw, device=CPU), tb)
    np.testing.assert_allclose(Rd, Td, rtol=0, atol=1e-12 * np.abs(Rd).max())


def test_assembled_matvec_matches_reference():
    """The port's bmm + index_add_ SpMV against bm.matvec on the same
    matrix, carried across with convert.block_sparse_matrix."""
    degrees = np.array([2, 1, 2, 2, 1, 1, 2, 2])
    rb, _ = _pair((2, 2, 2), degrees)
    RA = r_assemble(rb, penalty=2.0, dirichlet=True, dtype=jnp.float64)
    TA = convert.block_sparse_matrix(
        RA.pattern.row_sizes, RA.pattern.col_sizes, RA.pattern.entries,
        {k: np.asarray(v) for k, v in RA.values.items()}, RA.dim, device=CPU)
    rng = np.random.default_rng(3)
    x = {p: rng.standard_normal((rb.bucket_size(p), rb.n_local(p)))
         for p in rb.bucket_degrees}
    ry = rbm.matvec(RA, {p: jnp.asarray(v) for p, v in x.items()})
    ty = tbm.matvec(TA, convert.bucket_dict(x, device=CPU))
    for p in x:
        np.testing.assert_allclose(np.asarray(ry[p]), ty[p].numpy(),
                                   rtol=0, atol=1e-13 * np.abs(ry[p]).max())


@pytest.mark.parametrize("cells,p", [((3, 2, 2), 4), ((4, 3), 2)])
def test_l2_functional_matches_reference(cells, p):
    rb, tb = _pair(cells, np.full(int(np.prod(cells)), p))

    def f_ref(x):
        return jnp.sin(jnp.pi * x[..., 0]) * (1.0 + x[..., -1] ** 2)

    def f_port(x):
        return torch.sin(np.pi * x[..., 0]) * (1.0 + x[..., -1] ** 2)

    rbv = r_l2(rb, f_ref, dtype=jnp.float64)
    tbv = t_l2(tb, f_port, dtype=torch.float64, device=CPU)
    for q in rbv:
        want = np.asarray(rbv[q])
        np.testing.assert_allclose(tbv[q].numpy(), want, rtol=0,
                                   atol=1e-13 * np.abs(want).max())


def test_blockvector_ops_match_reference():
    from hpdg_tpu.linalg import blockvector as rbv
    from hpdg_tpu_torch.linalg import blockvector as tbv
    degrees = np.array([2, 1, 3, 2, 1, 2])
    rb, tb = _pair((3, 2), degrees)
    rng = np.random.default_rng(9)
    f1, f2 = rng.standard_normal(rb.ndof), rng.standard_normal(rb.ndof)
    rx, ry = rbv.from_flat(rb, f1), rbv.from_flat(rb, f2)
    tx = tbv.from_flat(tb, f1, device=CPU)
    ty = tbv.from_flat(tb, f2, device=CPU)
    for p in rb.bucket_degrees:
        np.testing.assert_array_equal(np.asarray(rx[p]), tx[p].numpy())
    np.testing.assert_array_equal(tbv.to_flat(tb, tx), f1)
    assert float(tbv.dot(tx, ty)) == pytest.approx(float(rbv.dot(rx, ry)),
                                                   rel=1e-14)
    assert float(tbv.norm(tx)) == pytest.approx(float(rbv.norm(rx)), rel=1e-14)
    pairs = [(rbv.axpy(0.3, rx, ry), tbv.axpy(0.3, tx, ty)),
             (rbv.add(rx, ry), tbv.add(tx, ty)),
             (rbv.sub(rx, ry), tbv.sub(tx, ty)),
             (rbv.scale(-2.5, rx), tbv.scale(-2.5, tx)),
             (rbv.zeros(rb), tbv.zeros(tb, device=CPU))]
    for want, got in pairs:
        np.testing.assert_allclose(rbv.to_flat(rb, want), tbv.to_flat(tb, got),
                                   rtol=0, atol=1e-15 * np.abs(f1).max() * 4)


@pytest.mark.parametrize("case", ["2d", "3d"])
@pytest.mark.parametrize("kind,dg_form,sigma1", [
    ("scalar", "sipg", 0.0), ("scalar", "nipg", 0.6),
    ("tensor", "sipg", 0.0), ("tensor", "iipg", 0.5)])
def test_assemble_diffusion_matches_reference(case, kind, dg_form, sigma1):
    """The per-quadrature-point builder (scalar and tensor media) on
    hanging-node, mixed-degree meshes, at 1e-12 of max|A|."""
    from test_torch_sumfact import DIFFUSION, hanging_pair
    rb, tb = hanging_pair(case)
    k_ref, k_port = DIFFUSION[kind]
    kw = dict(penalty=3.0, dirichlet=True, penalty_scaling="normal",
              dg_form=dg_form, sigma1=sigma1)
    RA = r_assemble(rb, diffusion=k_ref, dtype=jnp.float64, **kw)
    TA = t_assemble(tb, diffusion=k_port, **kw, device=CPU)
    assert RA.values.keys() == TA.values.keys()
    Rd = rbm.to_dense(RA, rb)
    np.testing.assert_allclose(Rd, tbm.to_dense(TA, tb), rtol=0,
                               atol=1e-12 * np.abs(Rd).max())


@pytest.mark.parametrize("case", ["2d", "3d"])
@pytest.mark.parametrize("dirichlet,scaling", [(True, "normal"),
                                               (False, "measure")])
def test_assemble_coef_parts_matches_reference(case, dirichlet, scaling):
    """coef_parts=True: the factors multiply out to the reference's
    values (1e-12 of max|A|); no diffusion allowed."""
    from test_torch_sumfact import hanging_pair
    rb, tb = hanging_pair(case)
    kw = dict(penalty=2.0, dirichlet=dirichlet, penalty_scaling=scaling)
    RA = r_assemble(rb, dtype=jnp.float64, **kw)
    parts = t_assemble(tb, coef_parts=True, **kw, device=CPU)
    assert parts.keys() == RA.values.keys()
    scale = max(float(np.abs(np.asarray(v)).max()) for v in RA.values.values())
    for key, (coef, D) in parts.items():
        want = np.asarray(RA.values[key])
        got = (coef @ D).reshape(want.shape)
        assert np.abs(got - want).max() <= 1e-12 * scale, key
    with pytest.raises(ValueError, match="coef_parts"):
        t_assemble(tb, coef_parts=True, diffusion=lambda x: x[..., 0],
                   device=CPU)


GEOM_SCALE_CASES = [((4, 3), "box"), ((3, 2, 2), "box"), ((4, 3), "affine"),
                    ((3, 2, 2), "medium")]


@pytest.mark.parametrize("cells,kind", GEOM_SCALE_CASES,
                         ids=[f"{len(c)}d-{k}" for c, k in GEOM_SCALE_CASES])
@pytest.mark.parametrize("scaling", ["measure", "normal"])
@pytest.mark.parametrize("s", [0.5, 2.0])
def test_assemble_geom_scale_matches_reference(cells, kind, scaling, s):
    """``geom_scale=s``: the operator of the mesh scaled by s (the
    consistency terms by s^(dim-2), the penalty by the same under
    "normal", the sigma1 term by s^-2); s given to the port as a float
    and as a 0-dim tensor."""
    from hpdg_tpu.mesh import geometry as rgeo
    from hpdg_tpu_torch.mesh import geometry as tgeo
    dim = len(cells)
    n = int(np.prod(cells))
    degrees = np.random.default_rng(n).choice([1, 2], size=n)
    rm, tm = rmesh.structured(cells), tmesh.structured(cells)
    if kind == "affine":
        A = np.eye(dim) + 0.2 * np.triu(np.ones((dim, dim)), 1)
        rm, tm = rgeo.affine_image(rm, A), tgeo.affine_image(tm, A)
    rb, tb = RBasis(rm, degrees), TBasis(tm, degrees)
    kw = dict(penalty=3.0, dirichlet=True, penalty_scaling=scaling,
              sigma1=0.5)
    if kind == "medium":
        kw["diffusion"] = lambda x: 1.0 + x[..., 0] ** 2
    RA = r_assemble(rb, dtype=jnp.float64, geom_scale=s, **kw)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in RA.values.values())
    for gs in (s, torch.tensor(s, dtype=torch.float64)):
        TA = t_assemble(tb, geom_scale=gs, **kw, device=CPU)
        assert RA.values.keys() == TA.values.keys()
        for k in RA.values:
            d = np.abs(np.asarray(RA.values[k]) - TA.values[k].numpy()).max()
            assert d <= 1e-12 * scale, (k, d / scale)


def test_geom_scale_equals_the_scaled_mesh():
    """At s = 0.5 the values equal those of the mesh with halved
    extents, and s = 1 those of no scaling."""
    cells, p = (3, 2, 2), 2
    n = int(np.prod(cells))
    tb = TBasis(tmesh.structured(cells), np.full(n, p))
    half = TBasis(tmesh.structured(cells, upper=(0.5, 0.5, 0.5)),
                  np.full(n, p))
    for sc in ("measure", "normal"):
        kw = dict(penalty=3.0, dirichlet=True, penalty_scaling=sc,
                  device=CPU)
        A1, A0 = t_assemble(tb, geom_scale=1.0, **kw), t_assemble(tb, **kw)
        Ah, Aw = t_assemble(tb, geom_scale=0.5, **kw), t_assemble(half, **kw)
        for k in A0.values:
            assert torch.equal(A1.values[k], A0.values[k])
            m = Aw.values[k].abs().max()
            assert (Ah.values[k] - Aw.values[k]).abs().max() <= 1e-12 * m
