"""Port vs reference: p- and h-transfer prolong/restrict, 1e-13 in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.transfer import h_transfer as r_h, p_transfer as r_p

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.transfer import h_transfer as t_h, p_transfer as t_p

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the tests run in several worker processes on one machine: one
    # thread each for torch and numpy's BLAS keeps them from
    # oversubscribing its cores
    with threadpool_limits(1):
        yield


def _rand(basis, seed):
    rng = np.random.default_rng(seed)
    return {p: rng.standard_normal((basis.bucket_size(p), basis.n_local(p)))
            for p in basis.bucket_degrees}


def _check(RT, TT, seed):
    xc = _rand(RT.coarse, seed)
    rf = _rand(RT.fine, seed + 1)
    pr = RT.prolong({p: jnp.asarray(v) for p, v in xc.items()})
    pt = TT.prolong(convert.bucket_dict(xc, device=CPU), dtype=torch.float64)
    rr = RT.restrict({p: jnp.asarray(v) for p, v in rf.items()})
    rt = TT.restrict(convert.bucket_dict(rf, device=CPU), dtype=torch.float64)
    for ref, got in ((pr, pt), (rr, rt)):
        assert ref.keys() == got.keys()
        for p in ref:
            want = np.asarray(ref[p])
            np.testing.assert_allclose(got[p].numpy(), want, rtol=0,
                                       atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p,order", [(4, 2), (2, 1), (3, 1)])
def test_p_transfer_matches_reference(dim, p, order):
    cells = (3, 2) if dim == 2 else (2, 2, 3)
    rng = np.random.default_rng(p + dim)
    degrees = rng.integers(1, p + 1, size=int(np.prod(cells)))
    degrees[0] = p
    RT = r_p(RBasis(rmesh.structured(cells), degrees), order)
    TT = t_p(TBasis(tmesh.structured(cells), degrees), order)
    np.testing.assert_array_equal(RT.coarse.degrees, TT.coarse.degrees)
    _check(RT, TT, seed=10 * p + dim)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", [1, 2])
def test_h_transfer_matches_reference(dim, p):
    cells = (3, 2) if dim == 2 else (3, 2, 2)
    rms = rmesh.hierarchy(rmesh.structured(cells), 1)
    tms = tmesh.hierarchy(tmesh.structured(cells), 1)
    rf = RBasis(rms[1], np.full(rms[1].n_elements, p))
    tf = TBasis(tms[1], np.full(tms[1].n_elements, p))
    rc = RBasis(rms[0], np.full(rms[0].n_elements, p))
    tc = TBasis(tms[0], np.full(tms[0].n_elements, p))
    RT, TT = r_h(rf, rc), t_h(tf, tc)
    assert len(RT.groups) == len(TT.groups) == 2 ** dim
    for rg, tg in zip(RT.groups, TT.groups):
        np.testing.assert_array_equal(rg.fine_pos, tg.fine_pos)
        np.testing.assert_array_equal(rg.coarse_pos, tg.coarse_pos)
        np.testing.assert_array_equal(rg.T, tg.T)
    _check(RT, TT, seed=20 * p + dim)
