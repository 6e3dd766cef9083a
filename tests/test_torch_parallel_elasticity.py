"""Port vs reference: the sharded elasticity of ``parallel/elasticity.py``,
in f64 on the 8 virtual CPU devices against one-process groups of 1, 2
and 8 shards, arrays compared one to one in the reference's global
``[N, bs]`` layout.

* the box apply (2D and 3D, both boundary kinds, both penalty
  scalings) against the reference's sharded apply and the port's serial
  operator, at 1e-11 of max;
* the curved apply (isoparametric and affine meshes) likewise;
* ``elasticity_pcg_solve`` after a fixed count at 1e-10;
* gloo ranks (2 x 4 shards, a worker script in ``tmp_path``) against
  the one-process group at 1e-13 (the apply, the PCG and one V-cycle);
* the ``--sharded`` branch of ``hpdg_tpu_torch.examples.elasticity``
  against the reference script's report.

The multigrid hierarchy is held against the reference in
``test_torch_parallel_elasticity_pmg.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.parallel import elasticity as rel

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.examples import elasticity as texample
from hpdg_tpu_torch.matrixfree.elasticity import elasticity_operator
from hpdg_tpu_torch.mesh import geometry as tgeo
from hpdg_tpu_torch.parallel import elasticity as tel
from hpdg_tpu_torch.parallel.comm import ShardGroup

from test_torch_models import assert_same_report, reference_lines
from test_torch_parallel_comm import rel_err

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    # the reference's native topology builds its library in place (R10)
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def wavy(xx):
    xx = np.asarray(xx, np.float64)
    out = [xx[..., 0] + 0.06 * np.sin(np.pi * xx[..., 1]),
           xx[..., 1] + 0.05 * np.sin(np.pi * xx[..., 0] / 2)]
    if xx.shape[-1] == 3:
        out.append(xx[..., 2] + 0.04 * np.sin(np.pi * xx[..., 0]))
    return np.stack(out, -1)


def meshes(cells, kind):
    """(reference gmesh, port gmesh) over ``cells``; None for boxes."""
    if kind == "box":
        return None, None
    if kind == "tri":
        return (rgeo.isoparametric(rmesh.structured(cells), wavy),
                tgeo.isoparametric(tmesh.structured(cells), wavy))
    dim = len(cells)
    A = np.eye(dim) + 0.15 * np.triu(np.ones((dim, dim)), 1)
    b = 0.1 * np.arange(dim)
    return (rgeo.affine_image(rmesh.structured(cells), A, b=b),
            tgeo.affine_image(tmesh.structured(cells), A, b=b))


def ref_apply(R, x):
    return np.asarray(R.apply(jax.device_put(jnp.asarray(x), R.sharding)))


APPLY_CASES = [
    # cells, p, ndev, dirichlet, scaling, mesh kind
    ((8, 3), 2, 8, True, "normal", "box"),
    ((8, 3), 3, 2, False, "measure", "box"),
    ((4, 3), 2, 1, False, "normal", "box"),
    ((8, 2, 2), 2, 8, False, "normal", "box"),
    ((8, 2, 2), 1, 2, True, "measure", "box"),
    ((4, 2, 2), 2, 1, True, "measure", "box"),
    ((8, 3), 2, 8, True, "normal", "tri"),
    ((8, 3), 2, 2, False, "measure", "tri"),
    ((8, 2, 2), 1, 8, False, "normal", "tri"),
    ((8, 2, 2), 2, 1, True, "measure", "affine"),
]


@pytest.mark.parametrize("cells,p,ndev,diri,scaling,kind", APPLY_CASES,
                         ids=["-".join(map(str, (len(c[0]), c[1], c[2],
                                                 "D" if c[3] else "N",
                                                 c[4], c[5])))
                              for c in APPLY_CASES])
def test_sharded_elasticity_apply_matches_reference(cells, p, ndev, diri,
                                                    scaling, kind):
    kw = dict(mu=1.0, lam=2.0, penalty=8.0, dirichlet=diri,
              penalty_scaling=scaling)
    gr, gt = meshes(cells, kind)
    R = rel.build_sharded_elasticity(cells, p, devices=jax.devices()[:ndev],
                                     gmesh=gr, **kw)
    T = tel.build_sharded_elasticity(cells, p, group=ShardGroup(ndev, CPU),
                                     gmesh=gt, **kw)
    assert (T.n_global, T.bs, T.layer) == (R.n_global, R.bs, R.layer)
    assert (T.shard_ebases is None) == (kind == "box")
    x = np.random.default_rng(1887).standard_normal((R.n_global, R.bs))
    want = ref_apply(R, x)
    got = T.apply(torch.as_tensor(x)).numpy()
    assert rel_err(want, got) <= 1e-11
    # ... and the port's own serial operator on the global mesh
    smesh = gt if gt is not None else tmesh.structured(cells)
    op = elasticity_operator(TBasis(smesh, np.full(R.n_global, p)),
                             device=CPU, **kw)
    assert rel_err(op({p: torch.as_tensor(x)})[p].numpy(), got) <= 1e-11


@pytest.mark.parametrize("kind", ["box", "tri"])
def test_sharded_elasticity_pcg_fixed_count(kind):
    cells, p = (8, 3), 2
    kw = dict(mu=1.0, lam=1.5, penalty=8.0, dirichlet=True,
              penalty_scaling="normal")
    gr, gt = meshes(cells, kind)
    R = rel.build_sharded_elasticity(cells, p, devices=jax.devices(),
                                     gmesh=gr, **kw)
    T = tel.build_sharded_elasticity(cells, p, group=ShardGroup(8, CPU),
                                     gmesh=gt, **kw)
    b = np.random.default_rng(7).standard_normal((R.n_global, R.bs))
    xr, nr = rel.elasticity_pcg_solve(
        R, jax.device_put(jnp.asarray(b), R.sharding), iters=20, **kw)
    xt, nt = tel.elasticity_pcg_solve(T, torch.as_tensor(b), iters=20, **kw)
    assert rel_err(xr, xt) <= 1e-10
    assert abs(float(nr) - float(nt)) <= 1e-10 * float(nr)


def test_sharded_elasticity_refuses_bad_layouts():
    with pytest.raises(ValueError, match="not divisible"):
        tel.build_sharded_elasticity((6, 2), 1, group=ShardGroup(4, CPU))
    _, gt = meshes((8, 2), "tri")
    with pytest.raises(ValueError, match="does not match"):
        tel.build_sharded_elasticity((8, 4), 1, group=ShardGroup(4, CPU),
                                     gmesh=gt)
    with pytest.raises(ValueError, match="coarsenable"):
        tel.build_sharded_elasticity_pmg((6, 2), 2, h_levels=2,
                                         group=ShardGroup(2, CPU))


WORKER = r'''
import sys
import numpy as np
import torch


def compute(g):
    """The rank-independent results; ``g`` any group of 8 shards."""
    from hpdg_tpu_torch import mesh as tmesh
    from hpdg_tpu_torch.mesh import geometry as tgeo
    from hpdg_tpu_torch.parallel import elasticity as tel

    def wavy(xx):
        return np.stack([xx[..., 0] + 0.06 * np.sin(np.pi * xx[..., 1]),
                         xx[..., 1] + 0.05 * np.sin(np.pi * xx[..., 0] / 2)],
                        -1)

    rows = lambda a, m: torch.as_tensor(g.local_rows(a, m))  # noqa: E731
    out = {}
    kw = dict(mu=1.0, lam=1.5, penalty=8.0, penalty_scaling="normal")
    rng = np.random.default_rng(9)
    gm = tgeo.isoparametric(tmesh.structured((16, 2)), wavy)
    for name, gmesh, diri in (("box", None, False), ("tri", gm, True)):
        prob = tel.build_sharded_elasticity((16, 2), 2, group=g,
                                            gmesh=gmesh, dirichlet=diri,
                                            **kw)
        x = rows(rng.standard_normal((prob.n_global, prob.bs)),
                 prob.n_local)
        out[f"{name}_apply"] = g.all_rows(prob.apply(x))
        xs, nr = tel.elasticity_pcg_solve(prob, x, iters=5, dirichlet=diri,
                                          **kw)
        out[f"{name}_pcg"] = g.all_rows(xs)
        out[f"{name}_pcg_norm"] = nr
        pmg = tel.build_sharded_elasticity_pmg(
            (16, 2), 2, group=g, gmesh=gmesh, dirichlet=diri, h_levels=1,
            coarse_cg_iters=5, smoother="cheb" if diri else "patch", **kw)
        out[f"{name}_lmax"] = torch.tensor(pmg.lmaxs)
        out[f"{name}_vcycle"] = g.all_rows(pmg.step(torch.zeros_like(x), x))
    return {k: torch.as_tensor(v).detach().cpu().numpy()
            for k, v in out.items()}


if __name__ == "__main__":
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    res = compute(ShardGroup.from_process_group(8, device="cpu"))
    assert "jax" not in sys.modules and "hpdg_tpu" not in sys.modules
    if rank == 0:
        np.savez(tmp + "/result.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
'''


def test_gloo_ranks_match_one_process_elasticity(tmp_path):
    ns = {"__name__": "worker"}
    exec(compile(WORKER, "worker", "exec"), ns)
    want = ns["compute"](ShardGroup(8, CPU))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path / "store"),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    for pr in procs:
        try:
            logs.append(pr.communicate(timeout=100)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(pr.returncode == 0 for pr in procs), "\n".join(logs)
    got = np.load(tmp_path / "result.npz")
    assert sorted(got.files) == sorted(want)
    for k in want:
        assert rel_err(want[k], got[k]) <= 1e-13, k


def test_sharded_elasticity_example_report_matches_reference(capsys):
    argv = ["--n", "2", "--levels", "1", "--p", "1", "--sharded", "1"]
    want = reference_lines("elasticity.py", argv, capsys)
    out = texample.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert_same_report(want, got)
    assert out["sharded"]["ndev"] == 8 and out["sharded"]["rel"] < 1e-3
