"""The reference's device loops in the port: ``pcg``'s ``while_loop``,
``loop_solve``'s step, and the sharded drivers' ``fori_loop``s and
jitted TNNMG step, each a ``solvers.graphs.DeviceLoop`` over static
buffers (a replayed CUDA graph on a card, the same body run eagerly on
CPU tensors here).

* Each driver against its ``hpdg_tpu`` counterpart in f64: equal
  iteration counts, histories within 1e-12 of their first entry, x
  within 1e-12 of max|x|.  The serial problem is a 3D SIPG (3, 3, 3)
  lattice at degrees 2-3; the sharded ones are 2D (8, 4) at p=2 in 4
  shards, the reference on 4 of the conftest's 8 virtual devices, the
  port on ``ShardGroup(4, "cpu")``.  (On mixed degrees 1-3 plain CG
  loses orthogonality: two f64 runs that sum in another order then part
  by 1e-5 of ||r_0|| and by an iteration, so the unpreconditioned case
  runs on degrees 2-3.)
* ``pcg``'s edge cases: no preconditioner, block Jacobi, a start
  vector, ``rtol=False``, ``maxiter`` reached (a padded history),
  converged at k = 0, b = 0, a stop inside a block, ``tol=0`` as a
  fixed count.
* The static-state route against the eager loop, bit for bit: ``pcg``
  and ``loop_solve`` against the host loops they replaced (kept here as
  the reference), every driver against the same bodies run as a plain
  functional loop (``DeviceLoop`` patched out).
* A guard: while each body runs, ``Tensor.item/tolist/__float__/
  __int__/__bool__/cpu/numpy`` and host data handed to ``torch.tensor``,
  ``torch.as_tensor`` or ``torch.from_numpy`` raise, so a body that a
  card could not capture fails here first.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.assemble import assemble_laplace as r_laplace
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks.api import l2_functional as r_l2
from hpdg_tpu.linalg import blockmatrix as rbm
from hpdg_tpu.parallel import elasticity as rel
from hpdg_tpu.parallel import hp as rhp
from hpdg_tpu.parallel import multigrid as rmg
from hpdg_tpu.parallel import obstacle as robs
from hpdg_tpu.parallel import sharded as rsh
from hpdg_tpu.solvers import cg as rcg
from hpdg_tpu.solvers import smoothers as rsm

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import assemble_laplace as t_laplace
from hpdg_tpu_torch.assemble import l2_functional as t_l2
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import api as tapi
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.linalg import blockvector as tbv
from hpdg_tpu_torch.parallel import elasticity as tel
from hpdg_tpu_torch.parallel import hp as thp
from hpdg_tpu_torch.parallel import multigrid as tmg
from hpdg_tpu_torch.parallel import obstacle as tobs
from hpdg_tpu_torch.parallel import sharded as tsh
from hpdg_tpu_torch.parallel.comm import ShardGroup
from hpdg_tpu_torch.solvers import cg as tcg
from hpdg_tpu_torch.solvers import graphs
from hpdg_tpu_torch.solvers import smoothers as tsm

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
KW = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
TOL = 1e-12
CELLS, P, NDEV = (8, 4), 2, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _python_matcher(monkeypatch):
    # the reference's native topology builds its library in place (R10)
    monkeypatch.setenv("HPDG_NATIVE_TOPOLOGY", "0")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flat(v) -> np.ndarray:
    if isinstance(v, dict):
        return np.concatenate([_np(v[k]).reshape(-1) for k in sorted(v)])
    return _np(v).reshape(-1)


def assert_x(want, got, tol=TOL):
    """``got`` within ``tol`` of max|want| (exactly equal where want is
    zero)."""
    w, g = _flat(want), _flat(got)
    assert w.shape == g.shape
    assert np.abs(w - g).max() <= tol * np.abs(w).max(), \
        np.abs(w - g).max() / max(np.abs(w).max(), 1e-300)


def assert_hist(want, got, tol=TOL, scale=None):
    """Histories within ``tol`` of their first entry (or of ``scale``)."""
    w, g = np.asarray(want, np.float64), np.asarray(got, np.float64)
    scale = abs(w[0]) if scale is None else scale
    assert w.shape == g.shape
    assert np.abs(w - g).max() <= tol * scale, \
        np.abs(w - g).max() / max(scale, 1e-300)


def assert_same(a, b):
    """Bit for bit: tensors, dicts, tuples, lists and floats."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert_same(u, v)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b or (np.isnan(a) and np.isnan(b))


# ------------------------------------------------------------ serial pcg
@functools.lru_cache(maxsize=None)
def serial_pair():
    """A 3D SIPG (3, 3, 3) lattice at degrees 2-3 in both packages, and a
    random right-hand side."""
    cells = (3, 3, 3)
    deg = np.random.default_rng(1).integers(2, 4, size=27)
    rb = RBasis(rmesh.structured(cells), deg)
    tb = TBasis(tmesh.structured(cells), deg)
    RA, TA = r_laplace(rb, **KW), t_laplace(tb, device=CPU, **KW)
    rng = np.random.default_rng(2)
    b = {q: rng.standard_normal((tb.bucket_size(q), tb.n_local(q)))
         for q in tb.bucket_degrees}
    x0 = {q: 0.5 * rng.standard_normal(v.shape) for q, v in b.items()}
    Ax0 = {q: v.numpy() for q, v in tbm.matvec(
        TA, {q: torch.as_tensor(v) for q, v in x0.items()}).items()}
    return rb, tb, RA, TA, b, x0, Ax0


PCG_CASES = {  # name: (rhs, x0, preconditioned, tol, maxiter, rtol)
    "block_jacobi": ("b", None, True, 1e-8, 500, True),
    "no_precond": ("b", None, False, 1e-8, 500, True),
    "x0": ("b", "x0", True, 1e-8, 500, True),
    "rtol_false": ("b", None, True, 1e-5, 500, False),
    "maxiter": ("b", None, True, 1e-8, 13, True),
    "converged_at_0": ("Ax0", "x0", True, 1e-8, 500, True),
    "b_zero": ("zero", None, True, 1e-8, 500, True),
    "stop_inside_block": ("b", None, True, 1e-6, 500, True),
    "tol0_fixed_count": ("b", None, True, 0.0, 10, True),
}


def _pcg_inputs(case):
    rb, tb, RA, TA, b, x0, Ax0 = serial_pair()
    rhs, start, pre, tol, maxiter, rtol = PCG_CASES[case]
    rhs = {"b": b, "Ax0": Ax0,
           "zero": {q: np.zeros_like(v) for q, v in b.items()}}[rhs]
    start = x0 if start else None
    return RA, TA, rhs, start, pre, dict(tol=tol, maxiter=maxiter,
                                          rtol=rtol)


def _port_pcg(case, solver=None):
    _, TA, rhs, start, pre, kw = _pcg_inputs(case)
    T = lambda d: None if d is None else {  # noqa: E731
        q: torch.as_tensor(v) for q, v in d.items()}
    return (solver or tcg.pcg)(
        lambda v: tbm.matvec(TA, v), T(rhs), x0=T(start),
        precond=tsm.block_jacobi_preconditioner(TA) if pre else None, **kw)


def host_loop_pcg(matvec_fn, b, x0=None, precond=None, tol=1e-8,
                  maxiter=500, rtol=True):
    """The port's pcg before its loop moved onto the device: a host loop
    with one sync per iteration (the eager reference of the static-state
    route)."""
    x = tbv.zeros_like(b) if x0 is None else x0
    M = precond or (lambda r: r)
    r = tbv.sub(b, matvec_fn(x))
    z = M(r)
    pdir = z
    rz = tbv.dot(r, z)
    nb = float(tbv.norm(b))
    target = tol * (nb if nb > 0 else 1.0) if rtol else tol
    hist = [float(tbv.norm(r))]
    k = 0
    while k < maxiter and hist[k] > target:
        Ap = matvec_fn(pdir)
        alpha = rz / tbv.dot(pdir, Ap)
        x = tbv.axpy(alpha, pdir, x)
        r = tbv.axpy(-alpha, Ap, r)
        z = M(r)
        rz_new = tbv.dot(r, z)
        pdir = tbv.axpy(rz_new / rz, pdir, z)
        rz = rz_new
        hist.append(float(tbv.norm(r)))
        k += 1
    hist += [hist[k]] * (maxiter - k)
    return x, {"iterations": k,
               "residuals": torch.tensor(hist, dtype=torch.float64)}


@pytest.mark.parametrize("case", list(PCG_CASES))
def test_pcg_matches_reference(case):
    RA, _, rhs, start, pre, kw = _pcg_inputs(case)
    J = lambda d: None if d is None else {  # noqa: E731
        q: jnp.asarray(v) for q, v in d.items()}
    rx, ri = rcg.pcg(lambda v: rbm.matvec(RA, v), J(rhs), x0=J(start),
                     precond=rsm.block_jacobi_preconditioner(RA)
                     if pre else None, **kw)
    tx, ti = _port_pcg(case)
    k = ti["iterations"]
    assert isinstance(k, int) and k == int(ri["iterations"])
    rh, th = np.asarray(ri["residuals"]), ti["residuals"].numpy()
    assert th.shape == (kw["maxiter"] + 1,) and th.dtype == np.float64
    assert (th[k:] == th[k]).all()
    if case == "b_zero":
        assert k == 0 and not th.any() and not _flat(tx).any()
        return
    # converged at k = 0 the history is the roundoff of b - A x0: held
    # to ||b||
    assert_hist(rh, th, scale=np.linalg.norm(_flat(rhs))
                if case == "converged_at_0" else None)
    assert_x(rx, tx)
    expect = {"maxiter": 13, "converged_at_0": 0, "tol0_fixed_count": 10}
    if case in expect:
        assert k == expect[case]
    if case == "stop_inside_block":
        assert k % tcg.PCG_BLOCK and 0 < k < kw["maxiter"]


@pytest.mark.parametrize("case", list(PCG_CASES))
def test_pcg_static_route_equals_host_loop(case):
    x, info = _port_pcg(case)
    xe, ie = _port_pcg(case, solver=host_loop_pcg)
    assert info["iterations"] == ie["iterations"]
    assert_same(info["residuals"], ie["residuals"])
    assert_same(x, xe)


# ------------------------------------------------------------ loop_solve
def host_loop_solve(step_fn, x0, b, matvec_fn=None, tol=1e-8, maxiter=100,
                    norm_fn=None):
    """The port's loop_solve before its step became one captured body."""
    if norm_fn is None:
        if matvec_fn is not None:
            norm_fn = lambda c: torch.sqrt(torch.abs(  # noqa: E731
                tbv.dot(c, matvec_fn(c))))
        else:
            norm_fn = tbv.norm
    x = x0
    history = []
    for _ in range(maxiter):
        xn = step_fn(x, b)
        err = float(norm_fn(tbv.sub(xn, x)))
        history.append(err)
        x = xn
        if err < tol:
            break
    return x, {"iterations": len(history), "history": history}


def _jacobi_step(bm, A, sm):
    """x + 0.8 D^-1 (b - A x): one damped block-Jacobi step."""
    M = sm.block_jacobi_preconditioner(A)

    def step(x, b):
        r = {q: b[q] - v for q, v in bm.matvec(A, x).items()}
        return {q: x[q] + 0.8 * v for q, v in M(r).items()}

    return step


def _port_loop_solve(energy, solver=None):
    _, _, _, TA, b, x0, _ = serial_pair()
    T = lambda d: {q: torch.as_tensor(v) for q, v in d.items()}  # noqa: E731
    return (solver or tcg.loop_solve)(
        _jacobi_step(tbm, TA, tsm), T(x0), T(b),
        matvec_fn=(lambda v: tbm.matvec(TA, v)) if energy else None,
        tol=1.0 if energy else 5.0, maxiter=40)


@pytest.mark.parametrize("energy", [True, False], ids=["energy", "2norm"])
def test_loop_solve_matches_reference(energy):
    _, _, RA, _, b, x0, _ = serial_pair()
    J = lambda d: {q: jnp.asarray(v) for q, v in d.items()}  # noqa: E731
    rx, ri = rcg.loop_solve(
        _jacobi_step(rbm, RA, rsm), J(x0), J(b),
        matvec_fn=(lambda v: rbm.matvec(RA, v)) if energy else None,
        tol=1.0 if energy else 5.0, maxiter=40)
    tx, ti = _port_loop_solve(energy)
    assert ti["iterations"] == ri["iterations"]
    assert 1 < ti["iterations"] < 40
    assert_hist(ri["history"], ti["history"])
    assert_x(rx, tx)


@pytest.mark.parametrize("energy", [True, False], ids=["energy", "2norm"])
def test_loop_solve_static_route_equals_host_loop(energy):
    x, info = _port_loop_solve(energy)
    xe, ie = _port_loop_solve(energy, solver=host_loop_solve)
    assert info["iterations"] == ie["iterations"]
    assert info["history"] == ie["history"]
    assert_same(x, xe)


# ------------------------------------------------------ sharded drivers
def _group():
    return ShardGroup(NDEV, CPU)


def _devices():
    return jax.devices()[:NDEV]


@functools.lru_cache(maxsize=None)
def hp_pair():
    deg = np.full(int(np.prod(CELLS)), P)
    R = rhp.build_hp_sharded_pmg(CELLS, deg, devices=_devices(),
                                 coarse_cg_iters=3, **KW)
    T = thp.build_hp_sharded_pmg(CELLS, deg, group=_group(),
                                 coarse_cg_iters=3, **KW)
    rb = RBasis(rmesh.structured(CELLS), deg)
    tb = TBasis(tmesh.structured(CELLS), deg)
    b = {q: np.asarray(v) for q, v in R.levels[-1].scatter_global(
        r_l2(rb, lambda x: jnp.sin(3 * x[..., 0]) + x[..., 1]), rb).items()}
    return R, T, rb, tb, b


@functools.lru_cache(maxsize=None)
def uniform_pair():
    kw = dict(penalty=4.0, dirichlet=True)
    R = rsh.build_sharded_poisson(CELLS, P, devices=_devices(),
                                  dtype=jnp.float64, **kw)
    T = tsh.build_sharded_poisson(CELLS, P, group=_group(),
                                  dtype=torch.float64, **kw)
    mg = dict(pre_steps=2, post_steps=2, coarse_cg_iters=3, **kw)
    RM = rmg.build_sharded_pmg(CELLS, P, devices=_devices(),
                               dtype=jnp.float64, **mg)
    TM = tmg.build_sharded_pmg(CELLS, P, group=_group(),
                               dtype=torch.float64, **mg)
    b = np.random.default_rng(40).standard_normal(
        (R.n_global, (P + 1) ** len(CELLS)))
    return R, T, RM, TM, b


EKW = dict(mu=1.0, lam=1.5, penalty=8.0, dirichlet=True,
           penalty_scaling="measure")


@functools.lru_cache(maxsize=None)
def elasticity_pair():
    R = rel.build_sharded_elasticity(CELLS, P, devices=_devices(), **EKW)
    T = tel.build_sharded_elasticity(CELLS, P, group=_group(), **EKW)
    mg = dict(coarse_cg_iters=3, smoother="cheb", h_levels=0, **EKW)
    RM = rel.build_sharded_elasticity_pmg(CELLS, P, devices=_devices(), **mg)
    TM = tel.build_sharded_elasticity_pmg(CELLS, P, group=_group(), **mg)
    b = np.random.default_rng(7).standard_normal((R.n_global, R.bs))
    return R, T, RM, TM, b


TNNMG_KW = dict(tol=0.0, maxiter=4, pre_sweeps=2, inner_cg_iters=2)


def _obstacle(pmg, basis, b, lib):
    fine = pmg.levels[-1]
    lo = {q: lib.full_like(v, -np.inf) for q, v in b.items()}
    up = {q: lib.full_like(v, 0.01) for q, v in b.items()}
    return [fine.scatter_global(v, basis) for v in (b, lo, up)]


def port_driver(name):
    """The port's driver ``name`` on the CPU: its outputs by name."""
    if name == "tnnmg_sharded":
        _, T, _, tb, _ = hp_pair()
        b = t_l2(tb, lambda x: torch.ones_like(x[..., 0]), device=CPU)
        x, h = tobs.solve_tnnmg_sharded(T, *_obstacle(T, tb, b, torch),
                                        **TNNMG_KW)
        return dict(x=x, correction=h["correction"], damping=h["damping"],
                    energy=h["energy"], truncated=h["truncated"],
                    iterations=h["iterations"])
    if name in ("hp_pcg", "hp_rho", "hp_pmg_pcg"):
        _, T, _, _, b = hp_pair()
        fine = T.levels[-1]
        bt = convert.sharded(b, fine.group)
        if name == "hp_pcg":
            x, n = thp.hp_pcg_solve(fine, bt, iters=12)
        elif name == "hp_pmg_pcg":
            x, n = thp.hp_pmg_pcg_solve(T, bt, iters=4)
        else:
            return dict(rho=thp._hp_rho_est(fine, torch.float64))
        return dict(x=x, norm=n)
    if name in ("sharded_pcg", "sharded_pmg"):
        _, T, _, TM, b = uniform_pair()
        if name == "sharded_pcg":
            x, n = tsh.pcg_solve(T, torch.as_tensor(b), 6)
        else:
            x, n = tmg.solve_sharded_pmg(TM, torch.as_tensor(b), cycles=2)
        return dict(x=x, norm=n)
    _, T, _, TM, b = elasticity_pair()
    if name == "elasticity_pcg":
        x, n = tel.elasticity_pcg_solve(T, torch.as_tensor(b), iters=8,
                                        mu=1.0, lam=1.5, penalty=8.0)
    elif name == "elasticity_pmg":
        x, n = tel.solve_sharded_elasticity_pmg(TM, torch.as_tensor(b),
                                                cycles=2)
    else:
        x, n = tel.elasticity_pmg_pcg_solve(TM, torch.as_tensor(b), iters=3)
    return dict(x=x, norm=n)


def ref_driver(name):
    """The reference's driver ``name``: its outputs by name."""
    if name == "tnnmg_sharded":
        R, _, rb, _, _ = hp_pair()
        b = r_l2(rb, lambda x: jnp.ones_like(x[..., 0]))
        x, h = robs.solve_tnnmg_sharded(R, *_obstacle(R, rb, b, jnp),
                                        **TNNMG_KW)
        return dict(x=x, correction=h["correction"], damping=h["damping"],
                    energy=h["energy"], truncated=h["truncated"],
                    iterations=h["iterations"])
    if name in ("hp_pcg", "hp_rho", "hp_pmg_pcg"):
        R, _, _, _, b = hp_pair()
        fine = R.levels[-1]
        br = {q: jnp.asarray(v) for q, v in b.items()}
        if name == "hp_pcg":
            x, n = rhp.hp_pcg_solve(fine, br, iters=12)
        elif name == "hp_pmg_pcg":
            x, n = rhp.hp_pmg_pcg_solve(R, br, iters=4)
        else:
            return dict(rho=rhp._hp_rho_est(fine, jnp.float64))
        return dict(x=x, norm=n)
    if name in ("sharded_pcg", "sharded_pmg"):
        R, _, RM, _, b = uniform_pair()
        B = jax.device_put(jnp.asarray(b), R.sharding)
        if name == "sharded_pcg":
            x, n = rsh.pcg_solve(R, B, 6)
        else:
            x, n = rmg.solve_sharded_pmg(RM, B, cycles=2)
        return dict(x=x, norm=n)
    R, _, RM, _, b = elasticity_pair()
    B = jax.device_put(jnp.asarray(b), R.sharding)
    if name == "elasticity_pcg":
        x, n = rel.elasticity_pcg_solve(R, B, iters=8, mu=1.0, lam=1.5,
                                        penalty=8.0)
    elif name == "elasticity_pmg":
        x, n = rel.solve_sharded_elasticity_pmg(RM, B, cycles=2)
    else:
        x, n = rel.elasticity_pmg_pcg_solve(RM, B, iters=3)
    return dict(x=x, norm=n)


SHARDED = ["tnnmg_sharded", "sharded_pcg", "sharded_pmg", "hp_pcg", "hp_rho",
           "hp_pmg_pcg", "elasticity_pcg", "elasticity_pmg",
           "elasticity_pmg_pcg"]


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_driver_matches_reference(name):
    want, got = ref_driver(name), port_driver(name)
    assert want.keys() == got.keys()
    for key in want:
        w, g = want[key], got[key]
        if key in ("iterations", "truncated"):
            assert w == g
        elif key in ("correction", "damping", "energy"):
            assert_hist(np.abs(w), np.abs(g))
            assert np.array_equal(np.sign(w), np.sign(g))
        elif key == "x":
            assert_x(w, g)
        else:  # norms and rho estimates
            assert abs(float(w) - float(g)) <= TOL * abs(float(w))
    if name == "tnnmg_sharded":
        assert got["iterations"] == TNNMG_KW["maxiter"]
        assert max(got["truncated"]) > 0


class PlainLoop:
    """A ``DeviceLoop`` stand-in with no static buffers: ``state =
    body(state)[0]``, the functional loop the static route must equal."""

    def __init__(self, body, state, block=1):
        self.body, self.state, self.block = body, state, block

    def step(self):
        out = None
        for _ in range(self.block):
            self.state, out = self.body(self.state)
        return out

    def repeat(self, n):
        for _ in range(n):
            self.step()
        return self.state


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_static_route_equals_functional_loop(name, monkeypatch):
    got = port_driver(name)
    for mod in (graphs, tobs):
        monkeypatch.setattr(mod, "DeviceLoop", PlainLoop)
    assert_same(got, port_driver(name))


# ----------------------------------------------------------------- guard
def _refuse(what):
    def raiser(*args, **kwargs):
        raise AssertionError(f"{what} inside a loop body: a card cannot "
                             f"capture it")
    return raiser


def _device_only(what, fn):
    def guarded(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise AssertionError(f"host data to {what} inside a loop body")
        return fn(data, *args, **kwargs)
    return guarded


@contextlib.contextmanager
def no_host_reads():
    """Host reads and host-to-device copies raise inside."""
    saved = []
    patches = [(torch.Tensor, n, _refuse(f"Tensor.{n}"))
               for n in ("item", "tolist", "__float__", "__int__",
                         "__bool__", "cpu", "numpy")]
    patches += [(torch, n, _device_only(f"torch.{n}", getattr(torch, n)))
                for n in ("tensor", "as_tensor", "from_numpy")]
    try:
        for owner, name, fn in patches:
            saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, fn)
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@pytest.fixture
def guarded_bodies(monkeypatch):
    """Every block of a ``DeviceLoop`` after its first runs under
    :func:`no_host_reads` (on a card the first block is the capture's
    eager warm-up, which may build tables lazily; the capture and every
    replay run the body as the later blocks do); yields the count of
    guarded blocks."""
    runs = {"blocks": 0}
    run_block = graphs.DeviceLoop._run_block

    def guarded(self):
        if not getattr(self, "_warm", False):
            self._warm = True
            return run_block(self)
        runs["blocks"] += 1
        with no_host_reads():
            return run_block(self)

    monkeypatch.setattr(graphs.DeviceLoop, "_run_block", guarded)
    return runs


def test_guard_catches_a_host_read(guarded_bodies):
    with pytest.raises(AssertionError, match="inside a loop body"):
        graphs.repeat(lambda v: v * float(v.sum()), torch.ones(3), 2)


def _api_solve(method, **mg_kwargs):
    _, tb, _, TA, b, _, _ = serial_pair()
    bt = {q: torch.as_tensor(v) for q, v in b.items()}
    kw = dict(method=method, tol=1e-10, maxiter=20, **mg_kwargs)
    if method == "mf":
        kw.update(penalty=2.0, penalty_scaling="normal")
    return tapi.solve_linear(tb, TA, bt, **kw)


def _hmg_pcg():
    cells = (16, 4)
    deg = np.random.default_rng(20).choice([1, 2, 3], size=64)
    pmg = thp.build_hp_sharded_hmg(cells, deg, h_levels=1, group=_group(),
                                   coarse_cg_iters=3, **KW)
    b = thp._zeros_like(pmg.levels[-1].zeros())
    b = {q: v + 1.0 for q, v in b.items()}
    return thp.hp_pmg_pcg_solve(pmg, b, iters=2)


def _elasticity_patch_pmg():
    pmg = tel.build_sharded_elasticity_pmg(
        (8, 4, 2), 2, group=ShardGroup(2, CPU), coarse_cg_iters=2,
        smoother="patch", h_levels=1, **EKW)
    b = torch.ones((pmg.levels[-1].n_global, pmg.levels[-1].bs),
                   dtype=torch.float64)
    return tel.elasticity_pmg_pcg_solve(pmg, b, iters=2)


GUARDED = {
    **{f"pcg_{c}": functools.partial(_port_pcg, c)
       for c in ("block_jacobi", "x0", "stop_inside_block")},
    "loop_solve": functools.partial(_port_loop_solve, True),
    **{f"solve_linear_{m}": functools.partial(_api_solve, m)
       for m in ("mf", "multigrid", "cg+mg")},
    # the heat preset's hierarchy (chip_smoke phase 14d)
    "solve_linear_multigrid_dgcg": functools.partial(
        _api_solve, "multigrid", coarse="dgcg"),
    **{name: functools.partial(port_driver, name) for name in SHARDED},
    "hmg_pcg": _hmg_pcg,
    "elasticity_patch_pmg": _elasticity_patch_pmg,
}


@pytest.mark.parametrize("name", list(GUARDED))
def test_bodies_make_no_host_read(name, guarded_bodies):
    GUARDED[name]()
    assert guarded_bodies["blocks"] > 0
