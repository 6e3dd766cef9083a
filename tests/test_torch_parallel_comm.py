"""Port vs reference: the shard group and the uniform-degree slab layer.

* ``ShardGroup.ppermute`` against ``jax.lax.ppermute`` inside
  ``jax.shard_map`` on the 8 virtual CPU devices, on a 1D grid and
  along each axis of a (4, 2) grid: exact, a shard no pair targets
  receives zeros; ``psum`` against the sharded ``jnp.sum``;
* ``parallel.sharded``: ``ShardedPoisson``'s apply, block-Jacobi
  preconditioner and fixed-iteration PCG at 1e-12;
* gloo ranks (2 x 4 and 4 x 2 shards, a ``FileStore`` in ``tmp_path``,
  one thread per rank, the workers importing only ``hpdg_tpu_torch``)
  give the one-process group's ppermute, hp apply, PCG iterates, one
  hp-multigrid V-cycle and ``sharded_adaptive_solve`` meshes within
  1e-13 relative; the sharded checkpoint round trip is exact at 1 and 2
  ranks;
* ``import hpdg_tpu_torch.parallel`` loads neither ``jax`` nor
  ``hpdg_tpu``.
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from threadpoolctl import threadpool_limits

from hpdg_tpu.parallel import sharded as rsh

from hpdg_tpu_torch import convert
from hpdg_tpu_torch.parallel import sharded as tsh
from hpdg_tpu_torch.parallel.comm import ShardGroup
from hpdg_tpu_torch.utils import checkpoint as tck

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


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


# ------------------------------------------------------------ ppermute/psum
@pytest.mark.parametrize("grid,axis,perm", [
    ((8,), 0, [(i, i + 1) for i in range(7)]),
    ((8,), 0, [(i + 1, i) for i in range(7)]),
    ((8,), 0, [(0, 5), (3, 1), (7, 7)]),
    ((4, 2), 0, [(i, i + 1) for i in range(3)]),
    ((4, 2), 1, [(1, 0)]),
], ids=["ring-up", "ring-down", "scatter", "grid-x", "grid-y"])
def test_ppermute_matches_shard_map(grid, axis, perm):
    names = ("x",) if len(grid) == 1 else ("x", "y")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(grid), names)
    buf = np.random.default_rng(3).standard_normal((8 * 3, 5))
    spec = P(names, None)
    fn = jax.jit(jax.shard_map(
        lambda b: jax.lax.ppermute(b, names[axis], perm), mesh=mesh,
        in_specs=spec, out_specs=spec))
    want = np.asarray(fn(jax.device_put(jnp.asarray(buf),
                                        NamedSharding(mesh, spec))))
    g = ShardGroup(8, CPU)
    got = g.ppermute(torch.as_tensor(buf).reshape(8, 3, 5), axis, perm,
                     grid=grid).reshape(24, 5).numpy()
    assert np.array_equal(got, want)
    targeted = {d for _, d in g.grid_pairs(axis, perm, grid)}
    for s in range(8):
        if s not in targeted:
            assert not got[3 * s:3 * s + 3].any()


def test_psum_matches_sharded_sum():
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    a = np.random.default_rng(4).standard_normal((8 * 4, 3))
    want = float(jnp.sum(jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, P("x", None)))))
    g = ShardGroup(8, CPU)
    got = g.psum(torch.as_tensor(a).sum())
    assert abs(float(got) - want) <= 1e-13 * abs(want)


def test_group_refusals():
    with pytest.raises(ValueError, match="at least one shard"):
        ShardGroup(0, CPU)
    g = ShardGroup(8, CPU)
    with pytest.raises(ValueError, match="twice"):
        g.permute(torch.zeros(8, 1), ((0, 1), (2, 1)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardGroup(8)


def test_convert_sharded_round_trip():
    g = ShardGroup(8, CPU)
    x = {2: np.arange(8 * 3 * 9, dtype=np.float64).reshape(24, 9)}
    t = convert.sharded(x, g)
    assert torch.equal(t[2], torch.as_tensor(x[2]))
    assert np.array_equal(convert.unsharded(t, g)[2], x[2])


# ------------------------------------------------------- uniform slab layer
@pytest.mark.parametrize("cells,p,dtype", [((16, 2), 2, "f64"),
                                           ((8, 2, 2), 1, "f64"),
                                           ((16, 2), 2, "f32")])
def test_sharded_poisson_matches_reference(cells, p, dtype):
    jd = jnp.float64 if dtype == "f64" else jnp.float32
    td = torch.float64 if dtype == "f64" else torch.float32
    R = rsh.build_sharded_poisson(cells, p, devices=jax.devices(),
                                  penalty=2.0, dirichlet=True, dtype=jd)
    T = tsh.build_sharded_poisson(cells, p, group=ShardGroup(8, CPU),
                                  penalty=2.0, dirichlet=True, dtype=td)
    bs = (p + 1) ** len(cells)
    x = np.random.default_rng(5).standard_normal((R.n_global, bs))
    tol = 1e-12 if dtype == "f64" else 2e-6
    xr = jax.device_put(jnp.asarray(x, jd), R.sharding)
    xt = torch.as_tensor(x, dtype=td)
    assert rel_err(R.apply(xr), T.apply(xt)) <= tol
    assert rel_err(R.precond(xr), T.precond(xt)) <= tol
    b = jax.device_put(jnp.ones((R.n_global, bs), jd), R.sharding)
    xs, nr = rsh.pcg_solve(R, b, 6)
    ys, nt = tsh.pcg_solve(T, torch.ones((T.n_global, bs), dtype=td), 6)
    assert rel_err(xs, ys) <= (1e-10 if dtype == "f64" else 1e-4)
    assert abs(float(nr) - float(nt)) <= (1e-9 if dtype == "f64" else 1e-3) \
        * float(nr) + 1e-12
    # the step/init pair equals the loop
    st = tsh.init_state(T, torch.ones((T.n_global, bs), dtype=td))
    step = tsh.pcg_step(T)
    for _ in range(6):
        st = step(st)
    assert torch.equal(st[0], ys)


# ------------------------------------------------------------- gloo ranks
WORKER = r'''
import sys
import numpy as np
import torch


def compute(g, tmp):
    """The rank-independent checks; ``g`` any group of 8 shards."""
    from hpdg_tpu_torch import convert, mesh as tmesh
    from hpdg_tpu_torch.parallel import hp
    from hpdg_tpu_torch.parallel.adaptive import sharded_adaptive_solve
    from hpdg_tpu_torch.utils import checkpoint as ck
    out = {}
    buf = torch.arange(8 * 2 * 3, dtype=torch.float64).reshape(8, 2, 3)
    buf = buf[g.shards.start:g.shards.stop]
    out["perm"] = g.all_rows(g.ppermute(buf, 0, [(i, i + 2) for i in
                                                 range(6)]).reshape(-1, 3))
    rng = np.random.default_rng(11)
    cells = (16, 4)
    deg = rng.choice([1, 2, 3], size=64)
    prob = hp.build_hp_sharded(cells, deg, group=g, penalty_scaling="normal")
    xg = {p: rng.standard_normal((8 * prob.m_own[p], (p + 1) ** 2))
          for p in prob.degree_set}
    x = prob.apply(convert.sharded(xg, g))  # zero padding rows
    y = prob.apply(x)
    out.update({f"apply{p}": g.all_rows(v) for p, v in y.items()})
    xs, nr = hp.hp_pcg_solve(prob, x, iters=10)
    out.update({f"pcg{p}": g.all_rows(v) for p, v in xs.items()})
    out["pcg_norm"] = nr
    pmg = hp.build_hp_sharded_hmg(cells, deg, h_levels=1, group=g,
                                  penalty_scaling="normal",
                                  coarse_cg_iters=5, cheb_degree=3)
    z = pmg.step({p: torch.zeros_like(v) for p, v in x.items()}, x)
    out.update({f"vcyc{p}": g.all_rows(v) for p, v in z.items()})
    m0 = tmesh.structured((16, 2))
    for mode in ("planes", "inherit"):
        mesh, degs, xa, info = sharded_adaptive_solve(
            m0, np.full(32, 2), lambda q: torch.ones_like(q[..., 0]),
            group=g, cycles=2, frac=0.3, cg_iters=40, dtype=torch.float64,
            partition=mode)
        out[f"{mode}_lower"] = torch.as_tensor(mesh.lower)
        out[f"{mode}_deg"] = torch.as_tensor(degs)
        out.update({f"{mode}_x{p}": v for p, v in xa.items()})
    ck.save_sharded(tmp, x, meta={"n": 1}, group=g)
    back, meta = ck.load_sharded(tmp, shardings=prob.shardings)
    out["ckpt_exact"] = torch.tensor(float(
        meta == {"n": 1} and all(torch.equal(back[p], x[p]) for p in x)))
    return {k: torch.as_tensor(v).detach().cpu().numpy()
            for k, v in out.items()}


if __name__ == "__main__":
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    import hpdg_tpu_torch.parallel  # noqa: F401
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    assert "jax" not in sys.modules and "hpdg_tpu" not in sys.modules
    res = compute(ShardGroup.from_process_group(8, device="cpu"),
                  tmp + "/ckpt")
    if rank == 0:
        np.savez(tmp + "/result.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
'''


def _worker_ns():
    ns = {"__name__": "worker"}
    exec(compile(WORKER, "worker", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def one_process_result(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    return _worker_ns()["compute"](ShardGroup(8, CPU), str(tmp / "ckpt"))


@pytest.mark.parametrize("ranks", [2, 4], ids=["2x4", "4x2"])
def test_gloo_ranks_match_one_process(ranks, tmp_path, one_process_result):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(ranks),
         str(tmp_path / "store"), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(ranks)]
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
    want = one_process_result
    assert sorted(got.files) == sorted(want)
    for k in want:
        if k.endswith(("_lower", "_deg")) or k == "perm":
            assert np.array_equal(got[k], want[k]), k
        elif k == "ckpt_exact":
            assert got[k] == 1.0 and want[k] == 1.0
        else:
            assert rel_err(want[k], got[k]) <= 1e-13, k
    # shards 0 and 1 are no pair's target: zeros
    assert not got["perm"][:4].any()


def test_port_parallel_imports_no_jax():
    code = ("import sys, hpdg_tpu_torch.parallel, hpdg_tpu_torch.parallel.hp,"
            " hpdg_tpu_torch.parallel.adaptive, hpdg_tpu_torch.parallel.heat,"
            " hpdg_tpu_torch.parallel.lines, hpdg_tpu_torch.parallel.obstacle,"
            " hpdg_tpu_torch.parallel.patches,"
            " hpdg_tpu_torch.parallel.multigrid,"
            " hpdg_tpu_torch.examples.parallel_poisson;"
            " bad = [m for m in sys.modules if m == 'jax' or"
            " m.startswith(('jax.', 'hpdg_tpu.')) or m == 'hpdg_tpu'];"
            " assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr


def test_sharded_checkpoint_one_rank(tmp_path):
    g = ShardGroup(4, CPU)
    from hpdg_tpu_torch.parallel.comm import Sharding
    x = {1: torch.arange(4 * 2 * 4, dtype=torch.float64).reshape(8, 4),
         2: torch.randn(12, 9, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(1))}
    sh = {1: Sharding(g, 2), 2: Sharding(g, 3)}
    tck.save_sharded(tmp_path / "s", x, meta={"k": 2}, group=g)
    assert sorted(os.listdir(tmp_path / "s")) == sorted(
        ["meta.json"] + [f"state.shard{s}.pt" for s in range(4)])
    y, meta = tck.load_sharded(tmp_path / "s", shardings=sh)
    assert meta == {"k": 2}
    assert all(torch.equal(y[p], x[p]) for p in x)
    # a checkpoint written without a group restores into the layout
    tck.save_sharded(tmp_path / "u", x)
    y2, _ = tck.load_sharded(tmp_path / "u", shardings=sh)
    assert all(torch.equal(y2[p], x[p]) for p in x)
    bad = {1: Sharding(g, 3)}
    with pytest.raises(ValueError, match="rows"):
        tck.load_sharded(tmp_path / "s", shardings=bad)
