"""Port vs reference: the uniform-degree sharded multigrid of
``parallel/multigrid.py`` and ``parallel/patches.py``, and the sharded
examples, in f64 on the 8 virtual CPU devices against a one-process
group of 8 shards.

* ``build_sharded_pmg`` + ``solve_sharded_pmg`` with the ``jacobi``,
  ``line`` and ``patch`` smoothers: the iterate after a fixed number of
  V-cycles at 1e-10; ``sharded_patch_sweeps`` forward and backward at
  1e-11;
* ``hpdg_tpu_torch.examples.parallel_poisson`` and the ``--sharded``
  branch of ``anisotropic_line_mg``: every printed line agrees with the
  reference script's (integers exactly, reported numbers to their
  printed digits), as ``test_torch_models.py`` checks the other
  examples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.parallel import multigrid as rmg
from hpdg_tpu.parallel import patches as rpat
from hpdg_tpu.parallel import sharded as rsh

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.examples import anisotropic_line_mg, parallel_poisson
from hpdg_tpu_torch.parallel import multigrid as tmg
from hpdg_tpu_torch.parallel import patches as tpat
from hpdg_tpu_torch.parallel import sharded as tsh
from hpdg_tpu_torch.parallel.comm import ShardGroup

from test_torch_models import assert_same_report, reference_lines
from test_torch_parallel_comm import rel_err

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    # the reference's native topology builds its library in place (R10)
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


@pytest.mark.parametrize("smoother", ["jacobi", "line", "patch"])
def test_uniform_sharded_pmg_cycles(smoother):
    cells, p = (16, 2), 2
    kw = dict(penalty=4.0, dirichlet=True, pre_steps=2, post_steps=2,
              coarse_cg_iters=5, smoother=smoother)
    R = rmg.build_sharded_pmg(cells, p, devices=jax.devices(),
                              dtype=jnp.float64, **kw)
    T = tmg.build_sharded_pmg(cells, p, group=ShardGroup(8, CPU),
                              dtype=torch.float64, **kw)
    n, bs = R.levels[-1].n_global, (p + 1) ** 2
    b = np.random.default_rng(40).standard_normal((n, bs))
    xr, nr = rmg.solve_sharded_pmg(
        R, jax.device_put(jnp.asarray(b), R.levels[-1].sharding), cycles=2)
    xt, nt = tmg.solve_sharded_pmg(T, torch.as_tensor(b), cycles=2)
    assert rel_err(xr, xt) <= 1e-10
    assert abs(float(nr) - float(nt)) <= 1e-9 * float(nr)


def test_patch_sweeps():
    cells, p = (16, 4), 1
    R = rsh.build_sharded_poisson(cells, p, devices=jax.devices(),
                                  penalty=4.0, dtype=jnp.float64)
    T = tsh.build_sharded_poisson(cells, p, group=ShardGroup(8, CPU),
                                  penalty=4.0, dtype=torch.float64)
    deg = np.full(64, p)
    rb = RBasis(rmesh.structured(cells), deg)
    tb = TBasis(tmesh.structured(cells), deg)
    Ar = r_laplace(rb, penalty=4.0, dirichlet=True)
    At = t_laplace(tb, penalty=4.0, dirichlet=True, device=CPU)
    fr, br = rpat.sharded_patch_sweeps(R, Ar, rb)
    ft, bt = tpat.sharded_patch_sweeps(T, At, tb)
    rng = np.random.default_rng(41)
    x = rng.standard_normal((R.n_global, 4))
    b = rng.standard_normal((R.n_global, 4))
    J = lambda a: jax.device_put(jnp.asarray(a), R.sharding)  # noqa: E731
    assert rel_err(fr(J(x), J(b)), ft(torch.as_tensor(x),
                                      torch.as_tensor(b))) <= 1e-11
    assert rel_err(br(J(x), J(b)), bt(torch.as_tensor(x),
                                      torch.as_tensor(b))) <= 1e-11


@pytest.mark.parametrize("name,mod,argv", [
    ("parallel_poisson.py", parallel_poisson,
     ["--cells", "8,4", "--iters", "6"]),
    ("anisotropic_line_mg.py", anisotropic_line_mg,
     ["--sharded", "1", "--cells", "16,8,4", "--p", "1", "--cycles", "3"]),
], ids=["parallel_poisson", "anisotropic_sharded"])
def test_sharded_example_reports_match_reference(name, mod, argv, capsys):
    want = reference_lines(name, argv, capsys)
    mod.main(argv + ["--shards", "8", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert_same_report(want, got)


def test_parallel_poisson_checkpoint(tmp_path):
    from hpdg_tpu_torch.utils.checkpoint import load_sharded
    out = parallel_poisson.run((8, 4), (2, 3), iters=3, shards=4,
                               checkpoint=str(tmp_path / "ck"), device=CPU)
    fine = out["pmg"].levels[-1]
    x, meta = load_sharded(tmp_path / "ck", shardings=fine.shardings)
    assert meta["iteration"] == 3 and meta["cells"] == [8, 4]
    assert all(torch.equal(x[p], out["x"][p]) for p in x)
