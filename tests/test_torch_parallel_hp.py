"""Port vs reference: the sharded mixed-degree operator of
``parallel/hp.py`` and the layer's element-local operators, in f64 on
the 8 virtual CPU devices against a one-process group of 8 shards.

* ``build_hp_sharded`` on 1-axis slabs, a (4, 2) and a (2, 2, 2) device
  grid: ``m_own``, ``owned_slots`` and the ``ext``/``send`` index tables
  EXACTLY equal, the apply at 1e-12 of max|y| (its f32 retype
  ``astype`` at 1e-5), the diagonal blocks at 1e-12; the scalar-medium,
  tensor-medium, affine and trilinear branches of ``_finish_sharded``
  likewise;
* ``build_hp_sharded_general`` on 2:1 hanging-node meshes: the slab,
  balanced and Morton partitions exactly equal, the apply at 1e-12
  (offset channels included), the plan cache's (hits, misses) equal;
* ``hp_dot``/``hp_norm``/``hp_pcg_solve`` after a fixed iteration count
  and ``_hp_rho_est`` at 1e-10;
* ``parallel.heat``: the mass (with and without a weight) and heat
  applies at 1e-12; ``parallel.lines.hp_line_precond`` at 1e-11.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.mesh import adaptive as radapt
from hpdg_tpu.mesh import geometry as rgeo
from hpdg_tpu.parallel import heat as rheat
from hpdg_tpu.parallel import hp as rhp
from hpdg_tpu.parallel import lines as rlines

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.mesh import adaptive as tadapt
from hpdg_tpu_torch.parallel import heat as theat
from hpdg_tpu_torch.parallel import hp as thp
from hpdg_tpu_torch.parallel import lines as tlines
from hpdg_tpu_torch.parallel.comm import ShardGroup

from test_torch_geometry import port_mesh

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
KW = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")


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


def rel_err(a: dict, b: dict) -> float:
    num = max(float(np.abs(np.asarray(a[p]) - np.asarray(b[p])).max())
              for p in a)
    den = max(float(np.abs(np.asarray(a[p])).max()) for p in a)
    return num / max(den, 1e-300)


def ref_data(R):
    """The reference's stacked per-shard plan data (the closure of its
    apply)."""
    return inspect.getclosurevars(R.apply).nonlocals["data_dev"]


def rand_sharded(R, seed):
    """A random sharded vector with zero padding rows (the reference's
    apply of random data: it masks the padding)."""
    rng = np.random.default_rng(seed)
    x = {p: jnp.asarray(rng.standard_normal(np.asarray(v).shape))
         for p, v in R.zeros().items()}
    return {p: np.asarray(v) for p, v in R.apply(x).items()}


def pair_apply(R, T, seed=1):
    x = rand_sharded(R, seed)
    yr = R.apply({p: jnp.asarray(v) for p, v in x.items()})
    yt = T.apply(convert.sharded(x, T.group))
    return x, yr, yt


def assert_same_layout(R, T, check_tables=True):
    assert R.degree_set == T.degree_set
    assert R.m_own == T.m_own
    assert R.owned_slots.keys() == T.owned_slots.keys()
    for k in R.owned_slots:
        np.testing.assert_array_equal(R.owned_slots[k], T.owned_slots[k])
    if check_tables:
        d = ref_data(R)
        for p in R.degree_set:
            np.testing.assert_array_equal(np.asarray(d["ext_kind"][p]),
                                          T.tables["ext_kind"][p])
            np.testing.assert_array_equal(np.asarray(d["ext_idx"][p]),
                                          T.tables["ext_idx"][p])
        assert d["send"].keys() == T.tables["send"].keys()
        for k in d["send"]:
            np.testing.assert_array_equal(np.asarray(d["send"][k]),
                                          T.tables["send"][k])


# ------------------------------------------------------------ structured
@pytest.mark.parametrize("cells,grid,degs", [
    ((16, 4), None, [1, 2, 3]),
    ((8, 4), (4, 2), [1, 2]),
    ((4, 4, 2), (2, 2, 2), [1, 2]),
], ids=["slab2d", "grid42", "grid222"])
def test_build_hp_sharded_layout_and_apply(cells, grid, degs):
    deg = np.random.default_rng(2).choice(degs, size=int(np.prod(cells)))
    R = rhp.build_hp_sharded(cells, deg, devices=jax.devices(),
                             device_grid=grid, **KW)
    T = thp.build_hp_sharded(cells, deg, group=group(), device_grid=grid,
                             **KW)
    assert_same_layout(R, T)
    assert T.device_grid == (grid or (8,))
    _, yr, yt = pair_apply(R, T)
    assert rel_err(yr, yt) <= 1e-12
    assert rel_err(R.diag, T.diag) <= 1e-12
    r = {p: jnp.asarray(v) for p, v in yr.items()}
    assert rel_err(R.dinv_mul(r), T.dinv_mul(convert.sharded(yr, T.group))) \
        <= 1e-11
    assert T.halo["elements"] > 0
    # the f32 retype of the same plan data
    T32 = T.astype(torch.float32)
    x = {p: v.float() for p, v in convert.sharded(
        rand_sharded(R, 1), T.group).items()}
    y32 = T32.apply(x)
    assert all(v.dtype == torch.float32 for v in y32.values())
    assert rel_err(yt, y32) <= 1e-5


def _wav(x):
    x = np.asarray(x, np.float64)
    return np.stack([x[..., 0] + 0.05 * np.sin(np.pi * x[..., 1] / 2),
                     x[..., 1] + 0.04 * np.sin(np.pi * x[..., 0] / 16)], -1)


def _scalar_k(lib):
    return lambda x: 1.0 + 0.5 * x[..., 0] * x[..., 1]


def _tensor_k(lib):
    def k(x):
        a = 1.0 + x[..., 0]
        b = 0.2 * x[..., 1]
        return lib.stack([lib.stack([a, b], -1),
                          lib.stack([b, 1.5 + 0.0 * a], -1)], -2)
    return k


@pytest.mark.parametrize("case", ["scalar", "tensor", "affine", "trilinear"])
def test_finish_sharded_branches(case):
    cells = (16, 2)
    deg = np.random.default_rng(3).choice([1, 2], size=32)
    kr = kt = None
    rm = None
    if case == "scalar":
        kr, kt = _scalar_k(jnp), _scalar_k(torch)
    elif case == "tensor":
        kr, kt = _tensor_k(jnp), _tensor_k(torch)
    elif case == "affine":
        rm = rgeo.affine_image(rmesh.structured(cells),
                               np.array([[1.0, 0.4], [0.0, 0.8]]))
    else:
        rm = rgeo.isoparametric(rmesh.structured(cells), _wav)
    R = rhp.build_hp_sharded(cells, deg, devices=jax.devices(),
                             diffusion=kr, gmesh=rm, **KW)
    T = thp.build_hp_sharded(cells, deg, group=group(), diffusion=kt,
                             gmesh=port_mesh(rm), **KW)
    assert_same_layout(R, T, check_tables=False)
    _, yr, yt = pair_apply(R, T, seed=4)
    assert rel_err(yr, yt) <= 1e-12
    assert rel_err(R.diag, T.diag) <= 1e-12


def test_scatter_gather_global_round_trip():
    from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
    from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
    cells = (16, 2)
    deg = np.random.default_rng(5).choice([1, 2, 3], size=32)
    R = rhp.build_hp_sharded(cells, deg, devices=jax.devices(), **KW)
    T = thp.build_hp_sharded(cells, deg, group=group(), **KW)
    rb = RBasis(rmesh.structured(cells), deg)
    tb = TBasis(tmesh.structured(cells), deg)
    rng = np.random.default_rng(6)
    xg = {p: rng.standard_normal((rb.bucket_size(p), (p + 1) ** 2))
          for p in rb.bucket_degrees}
    xs_r = R.scatter_global({p: jnp.asarray(v) for p, v in xg.items()}, rb)
    xs_t = T.scatter_global(convert.bucket_dict(xg, device=CPU), tb)
    for p in xs_r:
        np.testing.assert_array_equal(np.asarray(xs_r[p]), xs_t[p].numpy())
    back = T.gather_global(xs_t, tb)
    for p in xg:
        np.testing.assert_array_equal(back[p].numpy(), xg[p])


# ---------------------------------------------------------------- general
def hanging_pair(seed=7, cells=(16, 2), frac=0.3):
    rng = np.random.default_rng(seed)
    m0 = rmesh.structured(cells)
    marks = radapt.close_marks(m0, rng.random(m0.n_elements) < frac)
    return (radapt.refine_local(m0, marks),
            tadapt.refine_local(tmesh.structured(cells), marks))


def test_partitions_equal():
    rm, tm = hanging_pair()
    np.testing.assert_array_equal(rm.lower, tm.lower)
    for name in ("slab_partition", "balanced_partition", "morton_partition"):
        np.testing.assert_array_equal(getattr(rhp, name)(rm, 8),
                                      getattr(thp, name)(tm, 8))
    np.testing.assert_array_equal(rhp.slab_partition(rm, 4, axis=1 - 1),
                                  thp.slab_partition(tm, 4, axis=0))
    with pytest.raises(ValueError, match="uncut planes"):
        thp.slab_partition(tm, 64)


@pytest.mark.parametrize("part", ["slab", "balanced"])
def test_general_apply_on_hanging_mesh(part):
    rm, tm = hanging_pair()
    deg = np.random.default_rng(8).choice([1, 2], size=rm.n_elements)
    shard = (None if part == "slab"
             else rhp.balanced_partition(rm, 8))
    R = rhp.build_hp_sharded_general(rm, deg, devices=jax.devices(),
                                     elem_shard=shard, **KW)
    T = thp.build_hp_sharded_general(tm, deg, group=group(),
                                     elem_shard=shard, **KW)
    assert_same_layout(R, T)
    _, yr, yt = pair_apply(R, T, seed=9)
    assert rel_err(yr, yt) <= 1e-12
    assert rel_err(R.diag, T.diag) <= 1e-12


def test_plan_cache_hits_and_misses():
    rm, tm = hanging_pair(seed=10)
    deg = np.full(rm.n_elements, 2)
    cr, ct = {}, {}
    shard = rhp.balanced_partition(rm, 8)
    for _ in range(2):
        R = rhp.build_hp_sharded_general(rm, deg, devices=jax.devices(),
                                         elem_shard=shard, plan_cache=cr,
                                         **KW)
        T = thp.build_hp_sharded_general(tm, deg, group=group(),
                                         elem_shard=shard, plan_cache=ct,
                                         **KW)
    # refine one corner: only the shards it touches miss
    marks = np.zeros(rm.n_elements, bool)
    marks[0] = True
    rm2 = radapt.refine_local(rm, radapt.close_marks(rm, marks))
    tm2 = tadapt.refine_local(tm, tadapt.close_marks(tm, marks))
    sh2 = shard[rm2.parent]
    deg2 = np.full(rm2.n_elements, 2)
    R = rhp.build_hp_sharded_general(rm2, deg2, devices=jax.devices(),
                                     elem_shard=sh2, plan_cache=cr, **KW)
    T = thp.build_hp_sharded_general(tm2, deg2, group=group(),
                                     elem_shard=sh2, plan_cache=ct, **KW)
    assert cr["__stats__"] == ct["__stats__"]
    assert ct["__stats__"][1] == (8, 0)
    assert 0 < ct["__stats__"][2][0] < 8
    _, yr, yt = pair_apply(R, T, seed=11)
    assert rel_err(yr, yt) <= 1e-12


# ------------------------------------------------- reductions, PCG, rho
def test_hp_pcg_dot_norm_and_rho():
    cells = (16, 4)
    deg = np.random.default_rng(12).choice([1, 2, 3], size=64)
    R = rhp.build_hp_sharded(cells, deg, devices=jax.devices(), **KW)
    T = thp.build_hp_sharded(cells, deg, group=group(), **KW)
    b = rand_sharded(R, 13)
    br = {p: jnp.asarray(v) for p, v in b.items()}
    bt = convert.sharded(b, T.group)
    assert abs(float(rhp.hp_dot(br, br)) - float(thp.hp_dot(bt, bt, T.group))
               ) <= 1e-13 * float(rhp.hp_dot(br, br))
    assert abs(float(rhp.hp_norm(br)) - float(thp.hp_norm(bt))) \
        <= 1e-13 * float(rhp.hp_norm(br))
    # one solve from a start vector (each reference call compiles its
    # loop anew); the zero start runs in the adaptive tests' first cycle
    x0 = {p: 0.5 * v for p, v in b.items()}
    xr, nr = rhp.hp_pcg_solve(R, br, iters=12,
                              x0={p: jnp.asarray(v) for p, v in x0.items()})
    xt, nt = thp.hp_pcg_solve(T, bt, iters=12,
                              x0=convert.sharded(x0, T.group))
    assert rel_err(xr, xt) <= 1e-10
    assert abs(float(nr) - float(nt)) <= 1e-8 * float(nr)
    rho_r = rhp._hp_rho_est(R, jnp.float64)
    rho_t = thp._hp_rho_est(T, torch.float64)
    assert abs(rho_r - rho_t) <= 1e-10 * rho_r


# ------------------------------------------------------------ heat, lines
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weight"])
def test_mass_and_heat_applies(weighted):
    cells = (16, 4)
    deg = np.random.default_rng(14).choice([1, 2], size=64)
    R = rhp.build_hp_sharded(cells, deg, devices=jax.devices(), **KW)
    T = thp.build_hp_sharded(cells, deg, group=group(), **KW)
    wr = (lambda x: 1.0 + x[..., 0] ** 2) if weighted else None
    wt = (lambda x: 1.0 + x[..., 0] ** 2) if weighted else None
    x = rand_sharded(R, 15)
    xr = {p: jnp.asarray(v) for p, v in x.items()}
    xt = convert.sharded(x, T.group)
    assert rel_err(rheat.hp_mass_apply(R, weight=wr)(xr),
                   theat.hp_mass_apply(T, weight=wt)(xt)) <= 1e-12
    assert rel_err(rheat.hp_heat_apply(R, 0.01, weight=wr)(xr),
                   theat.hp_heat_apply(T, 0.01, weight=wt)(xt)) <= 1e-12


@pytest.mark.parametrize("grid", [None, (1, 8)], ids=["cut", "whole"])
def test_hp_line_precond(grid):
    cells = (8, 8)
    deg = np.random.default_rng(16).choice([1, 2], size=64)
    rm = rmesh.structured(cells, upper=(1.0, 0.25))
    R = rhp.build_hp_sharded(cells, deg, devices=jax.devices(),
                             device_grid=grid, gmesh=rm, **KW)
    T = thp.build_hp_sharded(cells, deg, group=group(), device_grid=grid,
                             gmesh=port_mesh(rm), **KW)
    Mr = rlines.hp_line_precond(R, deg, **KW)
    Mt = tlines.hp_line_precond(T, deg, **KW)
    x = rand_sharded(R, 17)
    assert rel_err(Mr({p: jnp.asarray(v) for p, v in x.items()}),
                   Mt(convert.sharded(x, T.group))) <= 1e-11
