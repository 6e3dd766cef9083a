"""Port vs reference: the h-first and general-mesh sharded hierarchies
of ``parallel/hp.py``, in f64 on the 8 virtual CPU devices against a
one-process group of 8 shards.

* ``build_hp_sharded_hmg`` with a semicoarsening ``cells_chain`` and
  ``h_first``, with ``h_first_rule="geometric-max"`` and with the line
  smoother: the level degree maps exactly, one V-cycle at 1e-10;
the general-mesh hierarchies (``build_hp_sharded_pmg(gmesh=...)``,
``build_hp_sharded_hmg_general``) are held through the ``mg-pcg`` solver
of ``test_torch_parallel_adaptive.py``.
"""

import jax
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from hpdg_tpu.parallel import hp as rhp

from hpdg_tpu_torch.parallel import hp as thp
from hpdg_tpu_torch.parallel.comm import ShardGroup

from test_torch_parallel_hp import KW, rel_err
from test_torch_parallel_mg import assert_same_maps, vcycle_pair

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    # the reference's native topology builds its library in place (R10)
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def group(n=8):
    return ShardGroup(n, CPU)


HFIRST_CASES = {
    "semi_hfirst": dict(cells=(16, 2), degs=[2, 3],
                        kw=dict(cells_chain=[(8, 2), (16, 2)],
                                h_first=True)),
    "geomax": dict(cells=(16, 4), degs=[1, 2],
                   kw=dict(h_levels=1, h_first=True,
                           h_first_rule="geometric-max")),
    "line": dict(cells=(16, 2), degs=[2], kw=dict(
        cells_chain=[(8, 2), (16, 2)], h_first=True, smoother="line")),
}


@pytest.mark.parametrize("case", list(HFIRST_CASES))
def test_hmg_h_first_vcycle(case):
    c = HFIRST_CASES[case]
    cells = c["cells"]
    deg = np.random.default_rng(24).choice(c["degs"],
                                           size=int(np.prod(cells)))
    R = rhp.build_hp_sharded_hmg(cells, deg, devices=jax.devices(),
                                 coarse_cg_iters=4, cheb_degree=3,
                                 **c["kw"], **KW)
    T = thp.build_hp_sharded_hmg(cells, deg, group=group(),
                                 coarse_cg_iters=4, cheb_degree=3,
                                 **c["kw"], **KW)
    assert_same_maps(R, T)
    zr, zt = vcycle_pair(R, T, 25)
    assert rel_err(zr, zt) <= 1e-10
