"""Port vs reference: the host-side numpy layer of hpdg_tpu_torch.

Quadrature rules, 1D and tensor tables, DGBasis buckets, structured
meshes with their refinement hierarchy, and the assembly plan must equal
hpdg_tpu's bitwise (the code is numpy in both packages), or to 1e-15
where noted.
"""

import numpy as np
import pytest

from hpdg_tpu import quadrature as rq
from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble.plan import build_plan as r_build_plan
from hpdg_tpu.basis import lagrange as rlag, legendre as rleg, tensor as rten
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis

from hpdg_tpu_torch import quadrature as tq
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble.plan import build_plan as t_build_plan
from hpdg_tpu_torch.basis import lagrange as tlag, legendre as tleg, tensor as tten
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis

DIMS = [2, 3]
DEGREES = [1, 2, 4]


def _cells(dim):
    return (3, 2) if dim == 2 else (2, 3, 2)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_quadrature_rules_bitwise(n):
    for rule in ("gauss_legendre", "gauss_kronrod"):
        for a, b in zip(getattr(rq, rule)(n), getattr(tq, rule)(n)):
            np.testing.assert_array_equal(a, b)
    if n >= 2:
        for a, b in zip(rq.gauss_lobatto(n), tq.gauss_lobatto(n)):
            np.testing.assert_array_equal(a, b)
    for order in (n, 2 * n):
        for a, b in zip(rq.gauss_legendre_for_order(order),
                        tq.gauss_legendre_for_order(order)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(rq.gauss_lobatto_for_order(order),
                        tq.gauss_lobatto_for_order(order)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p", DEGREES)
def test_1d_tables_bitwise(p):
    for fam in ("lobatto", "legendre", "kronrod"):
        np.testing.assert_array_equal(rlag.nodes_1d(p, fam),
                                      tlag.nodes_1d(p, fam))
    r, t = rlag.tables(p, p + 2), tlag.tables(p, p + 2)
    for name in ("qnodes", "qweights", "values", "derivatives",
                 "at0", "at1", "dat0", "dat1"):
        np.testing.assert_array_equal(getattr(r, name), getattr(t, name))
    x = np.linspace(0.0, 1.0, 11)
    np.testing.assert_array_equal(rleg.legendre_values(p, x),
                                  tleg.legendre_values(p, x))


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("p", DEGREES)
def test_tensor_tables_bitwise(dim, p):
    rv, tv = rten.volume_tables(p, dim, p + 2), tten.volume_tables(p, dim, p + 2)
    for name in ("points", "weights", "V", "G"):
        np.testing.assert_array_equal(rv[name], tv[name])
    for ax in range(dim):
        for side in (0, 1):
            rf = rten.face_tables(p, dim, ax, side, p + 2)
            tf = tten.face_tables(p, dim, ax, side, p + 2)
            for name in ("points", "weights", "V", "Dn", "Dall"):
                np.testing.assert_array_equal(rf[name], tf[name])
    for pc in range(1, p + 1):
        np.testing.assert_array_equal(rten.interpolation_matrix(pc, p, dim),
                                      tten.interpolation_matrix(pc, p, dim))
    np.testing.assert_array_equal(rten.multiindices(p, dim),
                                  tten.multiindices(p, dim))


def _mesh_equal(rm, tm):
    for name in ("lower", "extent"):
        np.testing.assert_array_equal(getattr(rm, name), getattr(tm, name))
    for name in ("inside", "outside", "axis", "nc_code", "in_side",
                 "out_axis", "out_side", "twist"):
        np.testing.assert_array_equal(getattr(rm.faces, name),
                                      getattr(tm.faces, name))
    for name in ("elem", "axis", "side"):
        np.testing.assert_array_equal(getattr(rm.bfaces, name),
                                      getattr(tm.bfaces, name))
    np.testing.assert_array_equal(rm.face_measure(), tm.face_measure())
    np.testing.assert_array_equal(rm.bface_measure(), tm.bface_measure())
    np.testing.assert_array_equal(rm.volumes, tm.volumes)
    for name in ("parent", "child_pos"):
        a, b = getattr(rm, name), getattr(tm, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim", DIMS)
def test_structured_refine_hierarchy_bitwise(dim):
    """Element order after refinement is C-lattice order in both
    packages: the stencil kernel's strides depend on it."""
    rms = rmesh.hierarchy(rmesh.structured(_cells(dim)), 2)
    tms = tmesh.hierarchy(tmesh.structured(_cells(dim)), 2)
    assert len(rms) == len(tms) == 3
    for rm, tm in zip(rms, tms):
        _mesh_equal(rm, tm)
    # the finest level is numbered in C-lattice order
    fine = tms[-1]
    h = fine.extent[0]
    ic = np.rint(fine.lower / h).astype(np.int64)
    cells = tuple(int(c) for c in ic.max(axis=0) + 1)
    np.testing.assert_array_equal(np.ravel_multi_index(ic.T, cells),
                                  np.arange(fine.n_elements))


def test_structured_anisotropic_box_bitwise():
    rm = rmesh.structured((4, 2, 3), lower=(0.0, -1.0, 0.5),
                          upper=(2.0, 1.0, 1.0))
    tm = tmesh.structured((4, 2, 3), lower=(0.0, -1.0, 0.5),
                          upper=(2.0, 1.0, 1.0))
    _mesh_equal(rm, tm)
    _mesh_equal(rmesh.refine(rm), tmesh.refine(tm))


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("p", DEGREES)
def test_dgbasis_buckets(dim, p):
    rng = np.random.default_rng(7 + p)
    rm, tm = rmesh.structured(_cells(dim)), tmesh.structured(_cells(dim))
    for degrees in (np.full(rm.n_elements, p),
                    rng.integers(1, p + 1, size=rm.n_elements)):
        rb, tb = RBasis(rm, degrees), TBasis(tm, degrees)
        assert rb.bucket_degrees == tb.bucket_degrees
        assert rb.ndof == tb.ndof
        for q in rb.bucket_degrees:
            np.testing.assert_array_equal(rb.bucket_elems[q],
                                          tb.bucket_elems[q])
            assert rb.n_local(q) == tb.n_local(q)
        for name in ("degrees", "elem_bucket_pos", "offsets", "block_sizes"):
            np.testing.assert_array_equal(getattr(rb, name), getattr(tb, name))
        low = np.maximum(degrees - 1, 1)
        np.testing.assert_array_equal(rb.with_degrees(low).offsets,
                                      tb.with_degrees(low).offsets)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("p", DEGREES)
def test_build_plan_groups(dim, p):
    rng = np.random.default_rng(11 * p + dim)
    rm, tm = rmesh.structured(_cells(dim)), tmesh.structured(_cells(dim))
    degrees = rng.integers(1, p + 1, size=rm.n_elements)
    rp = r_build_plan(RBasis(rm, degrees))
    tp = t_build_plan(TBasis(tm, degrees))
    assert rp.pattern.entries.keys() == tp.pattern.entries.keys()
    for k, (rr, rc) in rp.pattern.entries.items():
        tr, tc = tp.pattern.entries[k]
        np.testing.assert_array_equal(rr, tr)
        np.testing.assert_array_equal(rc, tc)
    assert rp.pattern.row_sizes == tp.pattern.row_sizes
    assert len(rp.face_groups) == len(tp.face_groups)
    for rg, tg in zip(rp.face_groups, tp.face_groups):
        for name in ("p_in", "p_out", "axis", "nc_code", "in_side",
                     "out_axis", "out_side", "twist"):
            assert getattr(rg, name) == getattr(tg, name)
        for name in ("face_ids", "in_pos", "out_pos", "slot12", "slot21"):
            np.testing.assert_array_equal(getattr(rg, name), getattr(tg, name))
        for name in ("fmeas", "inv_h_in", "inv_h_out"):
            np.testing.assert_allclose(getattr(rg, name), getattr(tg, name),
                                       rtol=1e-15, atol=0)
    assert len(rp.boundary_groups) == len(tp.boundary_groups)
    for rg, tg in zip(rp.boundary_groups, tp.boundary_groups):
        assert (rg.p, rg.axis, rg.side) == (tg.p, tg.axis, tg.side)
        np.testing.assert_array_equal(rg.face_ids, tg.face_ids)
        np.testing.assert_array_equal(rg.pos, tg.pos)
        np.testing.assert_allclose(rg.fmeas, tg.fmeas, rtol=1e-15, atol=0)
        np.testing.assert_allclose(rg.inv_h, tg.inv_h, rtol=1e-15, atol=0)
