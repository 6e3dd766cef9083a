"""K1 and the slice on a CUDA card (``cuda`` marker; skipped without one).

This file imports neither JAX nor ``hpdg_tpu``, so it also runs on a
machine with the card but without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

K1 is held against its plain twin (1e-5 of max|y|: f32 sums in another
order); the CUDA V-cycle against the same cycle on CPU tensors (the twin
path, f32); the refinement solve on the card is verified to 1e-8; the
matrix-free solver's default route in f64 on the card, and its refusal
of levels K1 cannot take when asked for the kernel.  The fused
refinement solve (two captured CUDA graphs per step) against the
stepwise one, bit for bit (nothing on that path sums with atomics); a
step that syncs with the host makes it raise; K1 replayed from a graph
equals K1 eager bit for bit.  Config 5's two programs, the fused TNNMG
(one captured iteration) and the PDAS inner solve (anchor and chain
graphs over static buffers), against their eager routes to the bounds
of two f32 routes that sum in another order; an iteration that syncs
with the host makes the fused TNNMG raise; the verified obstacle solve
on the card verifies.  The device loops (``solvers.graphs``): each
driver replayed from its graph against the same bodies run eagerly on
the card (equal iterations, x within 1e-10 of max|x|: f64 sums whose
atomics collide), a pcg whose matvec syncs with the host makes the
capture raise, pcg under a caller's capture equals pcg called alone, and
an NCCL group of world size 1 replays its psums within 1e-13 of one
process.
"""

import numpy as np
import pytest
import torch

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import l2_functional
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.matrixfree.uniform import (uniform_sipg_factorized,
                                               uniform_sipg_operator)
from hpdg_tpu_torch.ops import uniform_stencil as us
from hpdg_tpu_torch.solvers import matrixfree_multigrid_solver, refinement_solve
from hpdg_tpu_torch.solvers.refine import capture_graph

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU

pytestmark = pytest.mark.cuda
KW = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _basis(cells, p):
    m = tmesh.structured(cells)
    return DGBasis(m, np.full(m.n_elements, p))


# every instantiation (gemm125, small27, small8, generic) on lattices that
# are no multiple of its tile, plus degenerate and 2D shapes
@pytest.mark.parametrize("cells,p", [((4, 2, 3), 2), ((3, 3, 3), 1),
                                     ((1, 3, 2), 2), ((6, 5, 4), 4),
                                     ((5, 3), 4), ((7, 9, 11), 4),
                                     ((13, 5, 7), 2), ((9, 11, 13), 1),
                                     ((5, 6, 7), 3)])
@pytest.mark.parametrize("dirichlet", [True, False])
def test_kernel_matches_twin(dev, cells, p, dirichlet):
    tb = _basis(cells, p)
    op = us.uniform_stencil_operator(tb, 2.0, dirichlet, "normal", device=dev)
    twin = uniform_sipg_operator(tb, 2.0, dirichlet, torch.float32, "normal",
                                 device=dev, tables=op.tables)
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (tb.mesh.n_elements, tb.n_local(p))), dtype=torch.float32, device=dev)
    yk, yt = op({p: u})[p], twin({p: u})[p]
    torch.cuda.synchronize()
    assert op.launches == 1
    assert float((yk - yt).abs().max()) <= 1e-5 * float(yt.abs().max())


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    tb = _basis((3, 2, 2), 2)
    op = us.uniform_stencil_operator(tb, device=dev)
    u = torch.zeros((12, 27), dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        op({2: u.double()})
    with pytest.raises(ValueError):
        op({2: u[:, :26]})
    with pytest.raises(ValueError):
        op({2: torch.zeros((27, 12), device=dev).t()})  # not contiguous
    assert op.launches == 0


def test_vcycle_on_card_matches_cpu_twin_path(dev):
    meshes = tmesh.hierarchy(tmesh.structured((3, 3, 3)), 1)
    tb = DGBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    gstep, info = matrixfree_multigrid_solver(tb, meshes=meshes,
                                              smoother="patch",
                                              use_kernel=True,
                                              dtype=torch.float32,
                                              device=dev, **KW)
    cstep, _ = matrixfree_multigrid_solver(tb, meshes=meshes,
                                           smoother="patch", use_kernel=True,
                                           dtype=torch.float32, **KW,
                                           device=CPU)
    rng = np.random.default_rng(6)
    x = {2: rng.standard_normal((216, 27))}
    b = {2: rng.standard_normal((216, 27))}
    yg = gstep(convert.bucket_dict(x, torch.float32, dev),
               convert.bucket_dict(b, torch.float32, dev))[2].cpu()
    yc = cstep(convert.bucket_dict(x, torch.float32, device=CPU),
               convert.bucket_dict(b, torch.float32, device=CPU))[2]
    assert float((yg - yc).norm() / yc.norm()) < 1e-5
    # one V-cycle: 2 sweeps x 8 colors + 1 residual on each of 2 levels
    assert sum(op.launches for op in info["operators"]) == 34


def test_refinement_solve_on_card_verifies(dev):
    meshes = tmesh.hierarchy(tmesh.structured((3, 3, 3)), 1)
    tb = DGBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    step, _ = matrixfree_multigrid_solver(tb, meshes=meshes,
                                          smoother="patch", use_kernel=True,
                                          dtype=torch.float32,
                                          device=dev, **KW)
    f = lambda x: torch.sin(np.pi * x[..., 0]) * (1.0 + x[..., 1])  # noqa: E731
    b64 = l2_functional(tb, f, device=dev)
    A64 = uniform_sipg_factorized(tb, device=dev, **KW)
    A_host = uniform_sipg_factorized(tb, **KW, device=CPU)
    b_host = {k: v.cpu() for k, v in b64.items()}
    x64, info = refinement_solve(
        step, lambda x: bv.sub(b64, A64(x)), b64, chain_k=2, tol=1e-8,
        max_steps=8, host_residual=lambda x: bv.sub(b_host, A_host(x)))
    assert info["verified"] and info["rel_residual"] <= 1e-8
    assert x64[2].device == dev


def test_solve_linear_mf_in_f64_on_card(dev):
    """``api.solve_linear(method="mf")`` with the f64 matrix and load
    vector of ``api.laplace``/``api.l2_functional``: the sum-factorized
    levels in f64 on the card, as the reference's default route."""
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm

    meshes = tmesh.hierarchy(tmesh.structured((2, 2, 2)), 1)
    tb = DGBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    A = api.laplace(tb, penalty=2.0, dirichlet=True, device=dev)
    b = api.l2_functional(tb, lambda x: 1.0 + 0.0 * x[..., 0], device=dev)
    x, info = api.solve_linear(tb, A, b, tol=1e-10, maxiter=60, meshes=meshes,
                               method="mf")
    assert x[2].dtype == torch.float64 and x[2].device == dev
    r = bv.sub(b, bm.matvec(A, x))
    assert float(bv.norm(r) / bv.norm(b)) < 1e-8
    assert info["iterations"] < 60


def test_use_kernel_raises_where_k1_cannot_take_a_level(dev):
    """With ``use_kernel=True`` a level K1 cannot take raises on the
    card: an f64 cycle, a mesh with hanging faces, a mesh with
    first-class geometry; no fallback."""
    from hpdg_tpu_torch.mesh import geometry as geo
    from hpdg_tpu_torch.mesh.adaptive import refine_local

    meshes = tmesh.hierarchy(tmesh.structured((2, 2, 2)), 1)
    tb = DGBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    with pytest.raises(TypeError):
        matrixfree_multigrid_solver(tb, meshes=meshes, use_kernel=True,
                                    dtype=torch.float64, device=dev, **KW)
    m0 = tmesh.structured((3, 3, 3))
    marks = np.zeros(27, bool)
    marks[0] = True
    tl = DGBasis(refine_local(m0, marks), np.full(34, 2))
    with pytest.raises(ValueError):
        matrixfree_multigrid_solver(tl, use_kernel=True, dtype=torch.float32,
                                    device=dev, **KW)
    sheared = [geo.affine_image(meshes[0], np.eye(3) + 0.2 * np.eye(3, k=1))]
    sheared.append(tmesh.refine(sheared[0]))
    tg = DGBasis(sheared[-1], np.full(sheared[-1].n_elements, 2))
    with pytest.raises(ValueError, match="geometry"):
        matrixfree_multigrid_solver(tg, meshes=sheared, use_kernel=True,
                                    dtype=torch.float32, device=dev, **KW)


def _patch_problem(dev):
    meshes = tmesh.hierarchy(tmesh.structured((3, 3, 3)), 1)
    tb = DGBasis(meshes[-1], np.full(meshes[-1].n_elements, 2))
    step, info = matrixfree_multigrid_solver(tb, meshes=meshes,
                                             smoother="patch",
                                             use_kernel=True,
                                             dtype=torch.float32,
                                             device=dev, **KW)
    f = lambda x: torch.sin(np.pi * x[..., 0]) * (1.0 + x[..., 1])  # noqa: E731
    b64 = l2_functional(tb, f, device=dev)
    A64 = uniform_sipg_factorized(tb, device=dev, **KW)
    return step, info["operators"], b64, lambda x: bv.sub(b64, A64(x))


def test_fused_refinement_on_card_equals_stepwise(dev):
    step, ops, b64, residual = _patch_problem(dev)
    kw = dict(chain_k=2, tol=1e-8, max_steps=8)
    xs, info_s = refinement_solve(step, residual, b64, **kw)
    for op in ops:
        op.launches = op.captured = 0
    xf, info_f = refinement_solve(step, residual, b64, fused=True, n_runs=2,
                                  **kw)
    assert info_f["steps"] == info_s["steps"] >= 3
    assert info_f["history"] == info_s["history"]
    assert torch.equal(xf[2], xs[2])
    # one V-cycle launches K1 34 times here; the chain graph holds 2
    chain = 2 * 34
    assert sum(op.captured for op in ops) == chain
    assert sum(op.launches for op in ops) == chain  # the warm-up
    assert info_f["replays"] == {"anchor": 2 * info_s["steps"],
                                 "chain": 2 * (info_s["steps"] - 1)}
    assert info_f["seconds_capture"] > 0.0


def test_fused_refinement_raises_where_the_step_cannot_be_captured(dev):
    step, _, b64, residual = _patch_problem(dev)

    def syncing_step(x, b):
        if float(bv.norm(b)) == 0.0:  # a host read: illegal under capture
            return x
        return step(x, b)

    with pytest.raises(RuntimeError):
        refinement_solve(syncing_step, residual, b64, chain_k=2, tol=1e-8,
                         max_steps=8, fused=True)
    # the card is still usable, and the stepwise route takes that step
    _, info = refinement_solve(syncing_step, residual, b64, chain_k=2,
                               tol=1e-8, max_steps=8)
    assert info["history"][-1] <= 1e-8


@pytest.mark.parametrize("cells,p", [((6, 5, 4), 4), ((4, 2, 3), 2),
                                     ((3, 3, 3), 1), ((5, 6, 7), 3)])
def test_k1_replayed_from_a_graph_equals_eager(dev, cells, p):
    tb = _basis(cells, p)
    op = us.uniform_stencil_operator(tb, 2.0, True, "normal", device=dev)
    rng = np.random.default_rng(9)
    shape = (tb.mesh.n_elements, tb.n_local(p))
    u = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=dev)
    graph, y_graph = capture_graph(lambda: op({p: u})[p], dev)
    assert op.captured == 1 and op.launches == 1  # the capture, the warm-up
    for _ in range(2):  # a new input in the static buffer each time
        y_eager = op({p: u})[p]
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y_graph, y_eager)
        u.copy_(torch.as_tensor(rng.standard_normal(shape), device=dev))


# ---- config 5's two programs: the fused TNNMG and the PDAS inner solve --

def _obstacle(dev, n, p):
    """Config 5's membrane pushed into a lower obstacle at -0.2 on n^2
    at degree p: (basis, A64, b64, lo, up, f32 copies of A, b, lo, up)."""
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    m = tmesh.structured((n, n), lower=(-1, -1), upper=(1, 1))
    basis = DGBasis(m, np.full(m.n_elements, p))
    A64 = api.laplace(basis, penalty=2.0, dirichlet=True, device=dev)
    b64 = api.l2_functional(basis, lambda x: -8.0 + 0.0 * x[..., 0],
                            device=dev)
    lo, up = api.constant_bounds(basis, lower=-0.2, device=dev)
    f32 = torch.float32
    A32 = bm.BlockSparseMatrix(A64.pattern, A64.dim,
                               {k: v.to(f32) for k, v in A64.values.items()},
                               A64.block_shape)
    as32 = lambda d: {k: v.to(f32) for k, v in d.items()}  # noqa: E731
    return basis, A64, b64, lo, up, (A32, as32(b64), basis, as32(lo),
                                     as32(up))


def _gap(want, got):
    err = max(float((got[k].double() - want[k].double()).abs().max())
              for k in want)
    return err, max(float(v.abs().max()) for v in want.values())


def test_fused_tnnmg_on_card_matches_eager(dev):
    """One captured TNNMG iteration replayed per iteration against the
    eager loop, f32 at 16^2 p=2, to bounds for two f32 routes that sum
    in another order (``index_add_`` atomics): iterations within 2,
    energies within 1e-6 (1 + |e|), x within 1e-3 of max|x|; one replay
    from a fixed x against one eager iteration within 1e-5."""
    from hpdg_tpu_torch.solvers.multigrid import multigrid_solver
    from hpdg_tpu_torch.solvers.tnnmg import (_tnnmg_one_iter, solve_tnnmg,
                                              tnnmg_fused_solver)
    *_, args = _obstacle(dev, 16, 2)
    mg_step, _ = multigrid_solver(args[2], args[0], dtype=torch.float32)
    nb = float(bv.norm(args[1]))
    kw = dict(mg_step=mg_step, tol=1e-6 * nb, maxiter=40, stall_window=3)
    xs, hs = solve_tnnmg(*args, **kw)
    solver = tnnmg_fused_solver(*args, **kw)
    assert solver.graph is not None
    xf, hf = solver()
    assert abs(hf["iterations"] - hs["iterations"]) <= 2
    assert max(hf["truncated"]) > 0
    es, ef = hs["energy"][-1], hf["energy"][-1]
    assert abs(es - ef) <= 1e-6 * (1.0 + abs(es))
    err, scale = _gap(xs, xf)
    assert err <= 1e-3 * scale
    x_fix, _ = solve_tnnmg(*args, mg_step=mg_step, tol=0.0, maxiter=2)
    x_e, diag_e = _tnnmg_one_iter(*args, mg_step, 1, 1e-13)(x_fix)
    for k in solver.x:
        solver.x[k].copy_(x_fix[k])
    solver.graph.replay()
    err, scale = _gap(x_e, solver.x)
    assert err <= 1e-5 * scale
    for g, e in zip(solver.diag[:3], diag_e[:3]):
        assert abs(float(g) - float(e)) <= 1e-5 * abs(float(e))


def test_pdas_inner_solve_graphs_on_card_match_eager(dev):
    """The PDAS inner solve (``TruncatedRefinement``) by its anchor and
    chain graphs against its eager route on one truncated system: both
    reach 1e-8 ||b||, steps within 1, y within 1e-6 of max|y|; one chain
    replay against the eager chain from the same anchor within 1e-5;
    a second system renews the static buffers for the same graphs."""
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.solvers.multigrid import (parametric_cycle,
                                                  setup_hierarchy)
    from hpdg_tpu_torch.solvers.tnnmg import (TruncatedRefinement,
                                              solve_tnnmg, truncated_matrix)
    basis, A64, b64, lo, up, args = _obstacle(dev, 16, 2)
    A32 = args[0]
    x, _ = solve_tnnmg(*args, tol=0.0, maxiter=20)
    nb = float(bv.norm(b64))
    routes = []
    for fused in (False, True):
        free = {k: torch.ones_like(v, dtype=torch.bool) for k, v in x.items()}
        data = setup_hierarchy(basis, truncated_matrix(A32, free),
                               dtype=torch.float32)
        routes.append(TruncatedRefinement(
            A64, A32, data, parametric_cycle(data, dtype=torch.float32), b64,
            chain_k=4, fused=fused))
    eager, graph = routes
    assert eager.graphs is None and graph.graphs is not None
    steps = []
    for eps in (1e-3, 1e-6):  # two active sets, the second warm-started
        free = {k: v.double() > lo[k] + eps for k, v in x.items()}
        Axa = bm.matvec(A64, {k: torch.where(free[k], 0.0, lo[k])
                              for k in free})
        b_tr = {k: torch.where(free[k], b64[k] - Axa[k], 0.0) for k in free}
        he, hg = (r(free, b_tr, 1e-8 * nb) for r in routes)
        assert he[-1] <= 1e-8 * nb and hg[-1] <= 1e-8 * nb
        assert abs(len(he) - len(hg)) <= 1
        steps.append(len(hg))
        err, scale = _gap(eager.y, graph.y)
        assert err <= 1e-6 * scale
    assert steps[0] >= 2  # the chain graph ran
    g_anchor, g_chain = graph.graphs
    graph.reset()
    g_anchor.replay()
    g_chain.replay()
    y_graph = {k: v.clone() for k, v in graph.y.items()}
    graph.reset()
    graph._chain()
    err, scale = _gap(graph.y, y_graph)
    assert err <= 1e-5 * scale


def test_fused_tnnmg_raises_where_the_iteration_cannot_be_captured(dev):
    from hpdg_tpu_torch.solvers.multigrid import multigrid_solver
    from hpdg_tpu_torch.solvers.tnnmg import solve_tnnmg, tnnmg_fused_solver
    *_, args = _obstacle(dev, 4, 2)
    mg_step, _ = multigrid_solver(args[2], args[0], dtype=torch.float32)

    def syncing_step(x, b):
        if float(bv.norm(b)) == 0.0:  # a host read: illegal under capture
            return x
        return mg_step(x, b)

    with pytest.raises(RuntimeError):
        tnnmg_fused_solver(*args, mg_step=syncing_step, tol=1e-6,
                           maxiter=40)
    # the card is still usable, and the eager loop takes that step
    _, hist = solve_tnnmg(*args, mg_step=syncing_step, tol=1e-6, maxiter=40)
    assert hist["iterations"] > 1


def test_solve_obstacle_verified_on_card_verifies(dev):
    from hpdg_tpu_torch.solvers.tnnmg import solve_obstacle_verified
    basis, A64, b64, lo, up, _ = _obstacle(dev, 32, 3)
    x, info = solve_obstacle_verified(A64, b64, basis, lo, up, tol=1e-8,
                                      max_outer=30, n_runs=2)
    assert info["verified"] and info["free_residual"] <= 1e-8
    assert info["feasible"] and info["complementarity"] <= 1e-8
    assert info["truncated"] > 0 and info["seconds_capture"] > 0.0
    for run in info["runs"]:
        assert run["verified"] and run["truncated"] > 0
    assert x[3].shape == (1024, 16)


# ---------------------------------------------------------------------------
# the reference's device loops as replayed CUDA graphs (solvers.graphs)
# ---------------------------------------------------------------------------

LOOP_DRIVERS = ["pcg", "loop_solve", "tnnmg_sharded", "sharded_pcg",
                "sharded_pmg", "hp_pcg", "hp_pmg_pcg", "elasticity_pcg",
                "elasticity_pmg", "elasticity_pmg_pcg"]


def _run_loop_driver(name, dev):
    """Driver ``name`` at a small size on ``dev`` in f64: ``(x, info,
    iterations replayed after the warm-up block)``."""
    from hpdg_tpu_torch.assemble import assemble_laplace
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.parallel import elasticity as el
    from hpdg_tpu_torch.parallel import hp, multigrid, obstacle, sharded
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.solvers import pcg
    from hpdg_tpu_torch.solvers.smoothers import block_jacobi_preconditioner
    if name in ("pcg", "loop_solve"):
        deg = np.random.default_rng(1).integers(2, 4, size=27)
        tb = DGBasis(tmesh.structured((3, 3, 3)), deg)
        A = assemble_laplace(tb, device=dev, **KW)
        b = bv.random(tb, 2, device=dev)
        if name == "pcg":
            x, info = pcg(lambda v: bm.matvec(A, v), b,
                          precond=block_jacobi_preconditioner(A), tol=1e-10,
                          maxiter=500)
            return x, info["iterations"], None
        x, info = api.solve_linear(tb, A, b, method="multigrid", tol=1e-9,
                                   maxiter=40)
        return x, info["iterations"], info["iterations"] - 1
    cells, p = (8, 4), 2
    group = ShardGroup(4, dev)
    if name in ("tnnmg_sharded", "hp_pcg", "hp_pmg_pcg"):
        deg = np.full(32, p)
        pmg = hp.build_hp_sharded_pmg(cells, deg, group=group,
                                      coarse_cg_iters=3, **KW)
        fine = pmg.levels[-1]
        tb = DGBasis(tmesh.structured(cells), deg)
        b = l2_functional(tb, lambda x: torch.ones_like(x[..., 0]),
                          device=dev)
        bs = fine.scatter_global(b, tb)
        if name == "hp_pcg":
            return hp.hp_pcg_solve(fine, bs, iters=12)[0], 12, 11
        if name == "hp_pmg_pcg":
            return hp.hp_pmg_pcg_solve(pmg, bs, iters=4)[0], 4, 3
        lo = {q: torch.full_like(v, -torch.inf) for q, v in b.items()}
        up = {q: torch.full_like(v, 0.01) for q, v in b.items()}
        x, h = obstacle.solve_tnnmg_sharded(
            pmg, bs, fine.scatter_global(lo, tb), fine.scatter_global(up, tb),
            tol=0.0, maxiter=4, pre_sweeps=2, inner_cg_iters=2)
        return x, h["iterations"], 3
    rng = np.random.default_rng(7)
    if name in ("sharded_pcg", "sharded_pmg"):
        b = torch.as_tensor(rng.standard_normal((32, (p + 1) ** 2)),
                            device=dev)
        if name == "sharded_pcg":
            prob = sharded.build_sharded_poisson(cells, p, group=group,
                                                 penalty=4.0)
            return sharded.pcg_solve(prob, b, 6)[0], 6, 5
        pmg = multigrid.build_sharded_pmg(cells, p, group=group, penalty=4.0,
                                          dtype=torch.float64, pre_steps=2,
                                          post_steps=2, coarse_cg_iters=3)
        return multigrid.solve_sharded_pmg(pmg, b, cycles=2)[0], 2, 1
    ekw = dict(mu=1.0, lam=1.5, penalty=8.0, dirichlet=True)
    if name == "elasticity_pcg":
        prob = el.build_sharded_elasticity(cells, p, group=group, **ekw)
        b = torch.as_tensor(rng.standard_normal((prob.n_global, prob.bs)),
                            device=dev)
        return el.elasticity_pcg_solve(prob, b, iters=8, **ekw)[0], 8, 7
    pmg = el.build_sharded_elasticity_pmg(cells, p, group=group,
                                          coarse_cg_iters=3, smoother="cheb",
                                          **ekw)
    b = torch.as_tensor(rng.standard_normal((pmg.levels[-1].n_global,
                                             pmg.levels[-1].bs)), device=dev)
    if name == "elasticity_pmg":
        return el.solve_sharded_elasticity_pmg(pmg, b, cycles=2)[0], 2, 1
    return el.elasticity_pmg_pcg_solve(pmg, b, iters=3)[0], 3, 2


@pytest.mark.parametrize("name", LOOP_DRIVERS)
def test_device_loop_graph_matches_eager_on_card(dev, name):
    """The replayed graph against the same body run eagerly on the card:
    the same iterations, x within 1e-10 of max|x| (f64 sums whose
    ``index_add_`` atomics collide come in another order)."""
    from hpdg_tpu_torch.solvers import graphs
    with graphs.eager_loops():
        graphs.reset_counts()
        xe, ke, _ = _run_loop_driver(name, dev)
        assert graphs.counts["captures"] == graphs.counts["replays"] == 0
    graphs.reset_counts()
    xg, kg, replayed = _run_loop_driver(name, dev)
    torch.cuda.synchronize()
    assert kg == ke
    want, got = (v if isinstance(v, dict) else {0: v} for v in (xe, xg))
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((want[q] - got[q]).abs().max()) for q in want)
    assert err <= 1e-10 * scale
    assert graphs.counts["captures"] >= 1
    if replayed is not None:  # the driver's own loop; the last capture
        assert graphs.counts["iterations"] >= replayed
    else:  # pcg: blocks of PCG_BLOCK, the first one the warm-up
        from hpdg_tpu_torch.solvers.cg import PCG_BLOCK
        assert graphs.counts["replays"] == -(-kg // PCG_BLOCK) - 1


def test_pcg_raises_where_the_iteration_cannot_be_captured(dev):
    from hpdg_tpu_torch.assemble import assemble_laplace
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.solvers import pcg
    tb = DGBasis(tmesh.structured((2, 2, 2)), np.full(8, 2))
    A = assemble_laplace(tb, device=dev, **KW)
    b = bv.random(tb, 3, device=dev)

    def syncing(v):
        if float(bv.norm(v)) == 0.0:  # a host read: illegal under capture
            return v
        return bm.matvec(A, v)

    with pytest.raises(RuntimeError):
        pcg(syncing, b, tol=1e-10, maxiter=100)
    # the card is still usable, and the eager route takes that matvec
    from hpdg_tpu_torch.solvers.graphs import eager_loops
    with eager_loops():
        _, info = pcg(syncing, b, tol=1e-10, maxiter=100)
    assert 0 < info["iterations"] < 100


def test_pcg_inside_a_callers_capture_runs_every_iteration(dev):
    """Under a caller's capture pcg records all ``maxiter`` iterations
    with no host read; replaying the caller's graph equals pcg called
    eagerly (the frozen iterations change nothing)."""
    from hpdg_tpu_torch.assemble import assemble_laplace
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.solvers import pcg
    from hpdg_tpu_torch.solvers.smoothers import block_jacobi_preconditioner
    tb = DGBasis(tmesh.structured((2, 2, 2)), np.full(8, 2))
    A = assemble_laplace(tb, device=dev, **KW)
    M = block_jacobi_preconditioner(A)
    b = bv.random(tb, 3, device=dev)
    want, info = pcg(lambda v: bm.matvec(A, v), b, precond=M, tol=1e-9,
                     maxiter=60)
    graph, (x, k, hist) = capture_graph(lambda: (lambda x, i: (
        x, i["iterations"], i["residuals"]))(*pcg(
            lambda v: bm.matvec(A, v), b, precond=M, tol=1e-9, maxiter=60)),
        dev)
    graph.replay()
    torch.cuda.synchronize()
    assert int(k) == info["iterations"] < 60
    assert hist.shape == (61,)
    assert float((hist.cpu() - info["residuals"]).abs().max()) \
        <= 1e-10 * float(info["residuals"][0])
    assert float((x[2] - want[2]).abs().max()) \
        <= 1e-10 * float(want[2].abs().max())


def test_nccl_rank_route_replays_its_loops(dev, tmp_path):
    """A ``torch.distributed`` NCCL group of world size 1: the sharded
    PCG's all_reduce psums captured into its graph and replayed, equal
    to the one-process group within 1e-13."""
    import torch.distributed as dist
    from hpdg_tpu_torch.parallel import hp
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.solvers import graphs
    cells, deg = (8, 4), np.full(32, 2)
    one = hp.build_hp_sharded(cells, deg, group=ShardGroup(4, dev), **KW)
    tb = DGBasis(tmesh.structured(cells), deg)
    bs = one.scatter_global(l2_functional(
        tb, lambda x: torch.ones_like(x[..., 0]), device=dev), tb)
    want, _ = hp.hp_pcg_solve(one, bs, 10)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        g = ShardGroup.from_process_group(4, device=dev)
        prob = hp.build_hp_sharded(cells, deg, group=g, **KW)
        graphs.reset_counts()
        got, _ = hp.hp_pcg_solve(prob, bs, 10)
        torch.cuda.synchronize()
        assert graphs.counts["replays"] == 9
    finally:
        dist.destroy_process_group()
    scale = max(float(v.abs().max()) for v in want.values())
    assert max(float((want[q] - got[q]).abs().max()) for q in want) \
        <= 1e-13 * scale
