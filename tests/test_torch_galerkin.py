"""Port vs reference: vector-valued block linear algebra, the transfers
with ``ncomp`` and the Galerkin coarse matrices, in f64.

* blockvector ``ncomp`` layouts and ``random`` bitwise; ``matvec``,
  ``matvec_t``, ``add_scaled``, ``to_dense`` and ``extract_diagonal`` on
  vector-valued blocks at 1e-12; the pattern's slot lookups;
* prolong/restrict for ``ncomp`` = 1, 2, 3 at 1e-13;
* ``ElementTransfer.galerkin`` for p- and h-transfers, scalar and
  vector-valued, mixed degrees: coarse patterns bitwise (entry order
  included), values at 1e-12; the symbolic plan is cached per pattern.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.assemble.elasticity import assemble_elasticity as r_elast
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.linalg import blockvector as rbv
from hpdg_tpu.transfer import h_transfer as r_h, p_transfer as r_p

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.transfer import h_transfer as t_h, p_transfer as t_p

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the tests run in several worker processes on one machine: one
    # thread each for torch and numpy's BLAS keeps them from
    # oversubscribing its cores
    with threadpool_limits(1):
        yield


def to_port(RA, device=CPU):
    """A reference BlockSparseMatrix -> the port's, through numpy."""
    pat = RA.pattern
    return convert.block_sparse_matrix(
        pat.row_sizes, pat.col_sizes, pat.entries,
        {k: np.asarray(v) for k, v in RA.values.items()}, RA.dim,
        device=device, block_shape=RA.block_shape)


def rand_vec(basis, seed, ncomp=1):
    rng = np.random.default_rng(seed)
    return {p: rng.standard_normal((basis.bucket_size(p),
                                    ncomp * basis.n_local(p)))
            for p in basis.bucket_degrees}


def jx(x):
    return {p: jnp.asarray(v) for p, v in x.items()}


def assert_close(want: dict, got: dict, tol: float):
    """max|got - want| <= tol * max|want| over all buckets (keys equal)."""
    assert want.keys() == got.keys()
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k in want:
        d = np.abs(np.asarray(want[k]) - got[k].detach().cpu().numpy()).max()
        assert d <= tol * scale, (k, d / scale)


def assert_same_pattern(rp, tp):
    assert rp.row_sizes == tp.row_sizes and rp.col_sizes == tp.col_sizes
    assert rp.entries.keys() == tp.entries.keys()
    for k in rp.entries:
        for a, b in zip(rp.entries[k], tp.entries[k]):
            np.testing.assert_array_equal(a, b)


def pair(cells, degrees, levels=0):
    """(reference, port) mesh hierarchies and finest bases."""
    rms = rmesh.hierarchy(rmesh.structured(cells), levels)
    tms = tmesh.hierarchy(tmesh.structured(cells), levels)
    deg = degrees(rms[-1].n_elements) if callable(degrees) \
        else np.full(rms[-1].n_elements, degrees)
    return rms, tms, RBasis(rms[-1], deg), TBasis(tms[-1], deg)


def mixed(n):
    return np.random.default_rng(7).integers(1, 4, size=n)


def assembled(kind, rb, tb=None):
    """(reference matrix, port matrix) of a SIPG Laplace ("laplace") or
    elasticity ("elast") problem."""
    if kind == "laplace":
        RA = r_laplace(rb, penalty=3.0, dirichlet=True,
                       penalty_scaling="normal")
    else:
        RA = r_elast(rb, mu=1.0, lam=0.8, penalty=4.0, dirichlet=True)
    return RA, to_port(RA)


@pytest.mark.parametrize("ncomp", [1, 2, 3])
def test_blockvector_ncomp_layouts(ncomp):
    _, _, rb, tb = pair((3, 2), mixed)
    flat = np.random.default_rng(ncomp).standard_normal(ncomp * rb.ndof)
    want = rbv.from_flat(rb, flat, ncomp=ncomp)
    got = tbv.from_flat(tb, flat, device=CPU, ncomp=ncomp)
    for p in want:
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want[p]))
    np.testing.assert_array_equal(tbv.to_flat(tb, got, ncomp=ncomp), flat)
    rr = rbv.random(rb, seed=5, ncomp=ncomp)
    tr = tbv.random(tb, seed=5, device=CPU, ncomp=ncomp)
    tz = tbv.zeros(tb, device=CPU, ncomp=ncomp)
    for p in rr:
        np.testing.assert_array_equal(tr[p].numpy(), np.asarray(rr[p]))
        assert tz[p].shape == tr[p].shape


@pytest.mark.parametrize("kind,cells", [("laplace", (3, 2, 2)),
                                        ("elast", (3, 3)),
                                        ("elast", (2, 2, 2))])
def test_blockmatrix_ops_match_reference(kind, cells):
    _, _, rb, tb = pair(cells, mixed)
    RA, TA = assembled(kind, rb)
    ncomp = RA.block_shape[0]
    assert TA.block_shape == RA.block_shape
    assert [TA.br(p) for p in tb.bucket_degrees] == \
        [RA.br(p) for p in rb.bucket_degrees]
    x = rand_vec(rb, 1, ncomp)
    xt = convert.bucket_dict(x, device=CPU)
    assert_close(jax.jit(lambda v: rbm.matvec(RA, v))(jx(x)),
                 tbm.matvec(TA, xt), 1e-12)
    assert_close(jax.jit(lambda v: rbm.matvec_t(RA, v))(jx(x)),
                 tbm.matvec_t(TA, xt), 1e-12)
    assert_close(rbm.extract_diagonal(RA), tbm.extract_diagonal(TA), 0)
    np.testing.assert_allclose(tbm.to_dense(TA, tb), rbm.to_dense(RA, rb),
                               rtol=0, atol=1e-14)
    RS, TS = rbm.add_scaled(RA, RA, -0.25), tbm.add_scaled(TA, TA, -0.25)
    assert TS.pattern is TA.pattern and TS.block_shape == TA.block_shape
    assert_close(RS.values, TS.values, 1e-15)
    zv = tbm.zeros_values(TA.pattern, TA.dim, TA.block_shape, device=CPU)
    assert {k: tuple(v.shape) for k, v in zv.items()} == \
        {k: tuple(v.shape) for k, v in TA.values.items()}


def test_pattern_slot_lookups_match_reference():
    _, _, rb, tb = pair((3, 3), mixed)
    RA, TA = assembled("laplace", rb)
    rp, tp = RA.pattern, TA.pattern
    for (pr, pc), (rows, cols) in rp.entries.items():
        perm = np.random.default_rng(pr * 7 + pc).permutation(len(rows))
        np.testing.assert_array_equal(
            tp.slots(pr, pc, rows[perm], cols[perm]),
            rp.slots(pr, pc, rows[perm], cols[perm]))
        assert tp.nnz(pr, pc) == rp.nnz(pr, pc)
        assert tp.slot(pr, pc, int(rows[-1]), int(cols[-1])) == \
            rp.slot(pr, pc, int(rows[-1]), int(cols[-1]))
    # a block the pattern lacks: -1 from lookup, KeyError from slots
    (p,) = [q for q in tb.bucket_degrees if (q, q) in tp.entries][:1]
    n = tp.row_sizes[p]
    far = np.array([0]), np.array([n - 1])
    if n > 2 and tp.lookup(p, p, *far)[0] < 0:
        with pytest.raises(KeyError):
            tp.slots(p, p, *far)


@pytest.mark.parametrize("ncomp", [1, 2, 3])
@pytest.mark.parametrize("kind", ["p", "h"])
def test_transfers_with_ncomp_match_reference(kind, ncomp):
    if kind == "p":
        _, _, rb, tb = pair((2, 3, 2), mixed)
        RT, TT = r_p(rb, 1), t_p(tb, 1)
    else:
        rms, tms, rb, tb = pair((3, 2), 2, levels=1)
        RT = r_h(rb, RBasis(rms[0], np.full(rms[0].n_elements, 2)))
        TT = t_h(tb, TBasis(tms[0], np.full(tms[0].n_elements, 2)))
    np.testing.assert_array_equal(RT.group_of_fine, TT.group_of_fine)
    np.testing.assert_array_equal(RT.coarse_elem, TT.coarse_elem)
    xc = rand_vec(RT.coarse, 3, ncomp)
    rf = rand_vec(RT.fine, 4, ncomp)
    assert_close(RT.prolong(jx(xc), ncomp=ncomp),
                 TT.prolong(convert.bucket_dict(xc, device=CPU), ncomp=ncomp),
                 1e-13)
    assert_close(RT.restrict(jx(rf), ncomp=ncomp),
                 TT.restrict(convert.bucket_dict(rf, device=CPU),
                             ncomp=ncomp), 1e-13)


GALERKIN_CASES = [  # kind, transfer, cells, degrees, levels
    ("laplace", "p", (3, 2, 2), 4, 0),
    ("laplace", "p", (3, 3), mixed, 0),
    ("laplace", "h", (2, 3), 2, 1),
    ("laplace", "h", (2, 2, 2), 1, 1),
    ("elast", "p", (3, 3), mixed, 0),
    ("elast", "p", (2, 2, 2), 2, 0),
    ("elast", "h", (2, 2), 1, 1),
    ("elast", "h", (1, 2, 2), 1, 1),
]


@pytest.mark.parametrize("kind,tr,cells,degrees,levels", GALERKIN_CASES)
def test_galerkin_matches_reference(kind, tr, cells, degrees, levels):
    rms, tms, rb, tb = pair(cells, degrees, levels)
    RA, TA = assembled(kind, rb)
    if tr == "p":
        RT, TT = r_p(rb, max(1, rb.max_degree() // 2)), \
            t_p(tb, max(1, tb.max_degree() // 2))
    else:
        RT = r_h(rb, RBasis(rms[0], np.full(rms[0].n_elements,
                                             rb.max_degree())))
        TT = t_h(tb, TBasis(tms[0], np.full(tms[0].n_elements,
                                             tb.max_degree())))
    RC, TC = RT.galerkin(RA), TT.galerkin(TA)
    assert TC.block_shape == RC.block_shape == RA.block_shape
    assert_same_pattern(RC.pattern, TC.pattern)
    assert_close(RC.values, TC.values, 1e-12)
    # the symbolic phase is cached: same coarse pattern object, same values
    TC2 = TT.galerkin(TA)
    assert TC2.pattern is TC.pattern
    assert_close(TC.values, TC2.values, 0)


def test_galerkin_equals_dense_triple_product():
    """RtAR of the port against the dense product built from prolong."""
    _, _, rb, tb = pair((3, 2), mixed)
    _, TA = assembled("elast", rb)
    TT = t_p(tb, 1)
    TC = TT.galerkin(TA)
    nc = TT.coarse.ndof * 2
    P = np.zeros((tb.ndof * 2, nc))
    for j in range(nc):
        e = np.zeros(nc)
        e[j] = 1.0
        xf = TT.prolong(tbv.from_flat(TT.coarse, e, device=CPU, ncomp=2),
                        ncomp=2)
        P[:, j] = tbv.to_flat(tb, xf, ncomp=2)
    want = P.T @ tbm.to_dense(TA, tb) @ P
    np.testing.assert_allclose(tbm.to_dense(TC, TT.coarse), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
