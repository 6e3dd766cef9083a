#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hpdg_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):

1. the card's name and power limit (nvidia-smi), torch/CUDA versions,
   TF32 off;
2. build the uniform-stencil kernel K1 (nvcc, sm_90a) from the sources,
   print ptxas' report (registers, spills) and each instantiation's
   resident blocks per SM;
3. K1 against its plain PyTorch twin at every level shape of the 12^3 and
   32^3 solves, a 2D lattice and one 3D lattice per instantiation that is
   no multiple of its tile, both penalty scalings, Dirichlet on and off
   (bound 1e-5 of max|y|); at the 32^3 levels (p = 4, 2, 1) and the 16^3
   and 8^3 p=1 levels: K1's median apply time (CUDA events), its time
   per apply over 200 back-to-back launches (CUDA events) and, after all
   timings, its device time per launch (profiler, each level in windows
   of its own, up to 3 until one sees the kernel), its bound from the
   shapes and the share of it, the plain twin's time, and
   ``library_ms``, one ``torch.sparse_bsr_tensor`` product with the same
   matrix;
4. the verified 3D SIPG p=4 hp-multigrid solve at 12^3 (216,000 dofs)
   and 32^3 (4,096,000 dofs): f32 V-cycle chains, f64 anchors on the
   card, one f64 verification on the host; asserts verified <= 1e-8,
   that K1 (asked for by ``use_kernel=True``) ran as every level's
   operator, as often as the hierarchy implies, and that the patch
   smoother was built on every level whose patch block fits
   ``PATCH_MAX_BLOCK``; at 32^3 a profiler window of 3 V-cycles: K1's
   device ms per cycle, all device ms per cycle, wall ms per cycle and
   the busy share;
5. the entry step of ``__graft_entry__.entry()``: ``sipg_operator`` at 8^3
   p=4 (f32, Dirichlet, penalty 2, "measure") against K1 on the same
   lattice (bound 1e-5 of max|y|);
6. the adaptive apply at the size of the reference's bench cell (14^3,
   30% refined with 2:1 closure, p=4, 1,099,000 dofs, "normal"): the
   sum-factorized and the dedup SpMV apply in f32 on the card, against
   each other and against the f64 sum-factorized apply (bound 1e-5 of
   max|y|); host build seconds, median apply times (CUDA events),
   launches per apply and the top ops by device time (profiler), peak
   memory;
7. an hp-adaptive solve: 8^3 with 30% refined, degrees {2, 3, 4},
   block-Jacobi PCG in f64 on the card (sum-factorized matvec, diagonal
   blocks from ``sipg_diagonal_blocks``, tol 1e-8), its relative
   residual recomputed by the f64 dedup SpMV and asserted <= 1e-8;
8. BASELINE config 4 as ``bench.py:698-772`` runs it: 3D elasticity on
   24^3 at p=2 (1,119,744 dofs, mu = lam = 1, penalty 4, Dirichlet),
   assembled on the card in f64; the assembled hp-multigrid on the f32
   copy (Galerkin levels p2 24^3 -> p1 24^3 -> p1 12^3, class-patch
   smoothing on both smoothed levels, colored block GS on the 41,472-dof
   coarse level) inside the f64 refinement (chain_k 10, at most 10
   steps); verified <= 1e-8 by a host numpy f64 residual; set-up and
   solve seconds, ms per V-cycle (CUDA events), launches per V-cycle
   and the top ops by device time (profiler over 2 cycles), peak memory;
   and the matrix-free elasticity apply on a seeded vector, f64 against
   the assembled A64 (1e-11 of max|y|) and f32 against f64 (1e-5), its
   ms per apply (CUDA events, median of 10) and launches per apply
   (profiler) beside the assembled SpMV's;
9. the scalar assembled hp-MG of ``tests/test_parity_cpp.py:84-125`` in
   f64 on the card (12^3 p=4, re-assembled levels, lexicographic block
   GS 3+3, dense coarse solve): each of its 9 cycles within
   1e-10 |c| + 5e-14 of the C++ history ``cpp/golden_mg3d_n12_p4.json``,
   and the seconds per cycle;
10. the 12^3 p=4 verified solve of phase 4 with the matrix-free
   solver's default smoother, block-Jacobi Chebyshev of degree 3, K1
   (asked for by name) as every level's operator; the contraction per
   cycle beside phase 4's;
11. BASELINE config 5 as ``bench.py:775-817`` builds it: a membrane
   pushed into a lower obstacle on 128^2 at p=3 (262,144 dofs), f64
   SIPG matrix assembled on the card, ``solve_obstacle_verified`` twice
   (f32 TNNMG, then the primal-dual active-set loop of f64 refinements
   around f32 parametric V-cycles); every run verified by
   host numpy f64: free-dof residual <= 1e-8, feasible, complementarity
   <= 1e-8, a contact zone; per run the seconds of both phases, the
   iterations and truncated dofs; launches, device ms and busy share of
   one TNNMG iteration and one parametric cycle (profiler), peak memory.

12. BASELINE config 3 as ``examples/adaptive_lshape.py`` runs it, at
   ``lshape(16)`` refined 3 times (196,608 dofs at p=1): six rounds of
   solve (f32 V-cycle chains of the assembled hp-multigrid in the f64
   refinement, verified <= 1e-8 by host numpy f64), jump indicator,
   Dörfler marking, smoothness indicator, ``refine_local`` or a degree
   raise, and ``interpolate_to``; per step the set-up, solve, estimator
   and persistence seconds, V-cycles, residual, eta and marks; degrees
   in 1..6 and raised, 2:1 balance, eta decreasing; on the
   last basis the indicators and error norms on the card against the
   CPU (1e-10), a carried and an unrefined linear function (1e-12), and
   a profiler window of one V-cycle and the peak memory.

13. first-class element geometry, three sub-phases:
   (a) Poisson on the quarter hollow cylinder ((1+x0) cos(pi x1/2),
   (1+x0) sin(pi x1/2), x2): an 8^3 lattice of hexes in VTK order through
   ``from_hex_lattice`` (trilinear corners), refined twice to 32^3
   elements, p=3 (2,097,152 dofs), penalty 4, "normal", Dirichlet data of
   u = sin(pi x) sin(pi y) cos(pi z) by ``api.dirichlet_data``: the
   volume from the mesh, from ``api.mass`` and from ``l2_functional(1)``
   (1e-12 of each other, 1e-2 of 3 pi / 4); ``sipg_operator`` f64
   against the assembled A64 (1e-11) and f32 against f64 (1e-5),
   ``sipg_diagonal_blocks`` against ``extract_diagonal(A64)`` (1e-11);
   ``api.solve_linear(method="onchip")`` host-verified <= 1e-8 at 16^3
   and 32^3; the L2 error at 32^3 at most 1/8 of that at 16^3; seconds
   of set-up, assembly and solve, ms per V-cycle and per apply (CUDA
   events), launches, device ms and busy share of one V-cycle and one
   sum-factorized apply (profiler), peak memory;
   (b) config 4's elasticity problem (24^3, p=2, mu = lam = 1, penalty
   4, Dirichlet; 1,119,744 dofs) on the same domain by ``isoparametric``
   on 6^3 refined twice: assembled on the card through the per-point
   pullback, the matrix-free apply against A64 (1e-11, f32 1e-5), f32 CG
   preconditioned by the assembled V-cycle inside the f64 refinement,
   host-verified <= 1e-8; assembly seconds and memory beside phase 8's;
   (c) an O-grid disk (a 16x16 centre block and four 16x16 outer
   blocks, four valence-3 singular edges) extruded to 16 layers, 20,480
   hexes, cells shuffled and each cell's VTK numbering turned (seed 0),
   through ``from_cell_vertices``, p=2 (552,960 dofs): non-classic face
   charts, face counts as counted from the blocks, A symmetric (1e-11 of
   max|A|), ``sipg_operator`` against A (1e-11), block-Jacobi PCG
   host-verified <= 1e-8, the SIPG energy of a smooth interpolant equal
   (1e-10) to that of the unshuffled import, and the refusals of
   ``refine_local``, ``assemble_elasticity`` and
   ``sipg_diagonal_blocks``; the import's seconds.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TOL_KERNEL = 1e-5  # of max|y|: f32 sums taken in another order
PENALTY = 2.0
SCALING = "normal"
# H100 SXM peaks (data sheet, 700 W): FP32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_times(fn, reps: int) -> list:
    """Per-call device times (ms) of ``fn()`` by CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def k1_bound(op) -> tuple:
    """(ms, "operations" | "bytes"): the least time the card could take
    for one apply, from the shapes: 2 bs^2 FLOP per block product (the
    diagonal block and every present neighbour), each of u and y moved
    once with the stored matrices."""
    st = op.tables
    n, bs = st.vid.shape[0], st.bs
    products = n + int(st.has_p.sum() + st.has_m.sum())
    flops = 2.0 * bs * bs * products
    nbytes = 4.0 * (2 * n * bs + (len(st.variants) + 2 * st.dim) * bs * bs)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bsr_matrix(op, dev):
    """The operator as one ``torch.sparse_bsr_tensor`` on the card (the
    stencil's blocks, not transposed, column-sorted per block row)."""
    st = op.tables
    n, bs, dim = st.vid.shape[0], st.bs, st.dim
    nvar = len(st.variants)
    mats = torch.as_tensor(np.concatenate(
        [st.Tdiag] + [np.stack([st.M12[ax], st.M21[ax]]) for ax in range(dim)]),
        dtype=torch.float32, device=dev)
    ar = np.arange(n)
    cols = [ar]
    ids = [st.vid.astype(np.int64)]
    for ax in range(dim):
        cols += [np.where(st.has_p[ax], st.nbr_p[ax], -1),
                 np.where(st.has_m[ax], st.nbr_m[ax], -1)]
        ids += [np.full(n, nvar + 2 * ax), np.full(n, nvar + 2 * ax + 1)]
    cols, ids = np.stack(cols, 1), np.stack(ids, 1)
    order = np.argsort(np.where(cols < 0, n, cols), axis=1, kind="stable")
    cols = np.take_along_axis(cols, order, 1)
    ids = np.take_along_axis(ids, order, 1)
    keep = cols >= 0
    crow = np.concatenate([[0], np.cumsum(keep.sum(1))])
    values = mats[torch.as_tensor(ids[keep], device=dev)]
    return torch.sparse_bsr_tensor(
        torch.as_tensor(crow, device=dev), torch.as_tensor(cols[keep], device=dev),
        values, size=(n * bs, n * bs), check_invariants=False)


def library_ms(op, u, yk, dev):
    """Median ms of ``A @ u`` with A a BSR tensor on the card, or the
    error PyTorch raised; the matrix is freed before returning."""
    try:
        A = bsr_matrix(op, dev)
        x = u.reshape(-1, 1)
        yl = (A @ x).reshape(yk.shape)
        torch.cuda.synchronize()
        rel = float((yl - yk).abs().max()) / float(yk.abs().max())
        if not rel <= TOL_KERNEL:
            raise AssertionError(f"BSR product disagrees with K1: rel {rel:.3e}")
        ms = float(np.median(event_times(lambda: A @ x, 10)))
        return ms, None
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    finally:
        A = yl = None  # noqa: F841
        torch.cuda.empty_cache()


def check_kernel(dev):
    """Phase 3: K1 against the plain twin on the card, and the times of
    the main path's levels."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.matrixfree.uniform import uniform_sipg_operator
    from hpdg_tpu_torch.ops.uniform_stencil import (UniformStencilOperator,
                                                    kernel_layout)

    cases = [((32, 32, 32), 4), ((32, 32, 32), 2), ((32, 32, 32), 1),
             ((16, 16, 16), 1), ((8, 8, 8), 1), ((4, 4, 4), 1),
             ((12, 12, 12), 4), ((12, 12, 12), 2), ((12, 12, 12), 1),
             ((6, 6, 6), 1), ((3, 3, 3), 1), ((1, 3, 2), 2), ((24, 20), 4),
             # one per instantiation, no multiple of the tile
             ((7, 9, 11), 4), ((13, 5, 7), 2), ((9, 11, 13), 1),
             ((5, 6, 7), 3)]
    timed = {((32, 32, 32), 4), ((32, 32, 32), 2), ((32, 32, 32), 1),
             ((16, 16, 16), 1), ((8, 8, 8), 1)}
    rng = np.random.default_rng(1887)
    worst = 0.0
    timing = {}
    for cells, p in cases:
        mesh = hm.structured(cells)
        basis = DGBasis(mesh, np.full(mesh.n_elements, p, dtype=np.int32))
        bs = (p + 1) ** len(cells)
        u = torch.as_tensor(rng.standard_normal((mesh.n_elements, bs)),
                            dtype=torch.float32, device=dev)
        for scaling in ("measure", "normal"):
            for dirichlet in (True, False):
                op = UniformStencilOperator(basis, PENALTY, dirichlet,
                                            scaling, device=dev)
                twin = uniform_sipg_operator(basis, PENALTY, dirichlet,
                                             torch.float32, scaling,
                                             device=dev, tables=op.tables)
                yk = op({p: u})[p]
                yt = twin({p: u})[p]
                torch.cuda.synchronize()
                abs_err = float((yk - yt).abs().max())
                rel = abs_err / float(yt.abs().max())
                ok = bool(torch.isfinite(yk).all()) and rel <= TOL_KERNEL
                print(f"kernel-vs-twin cells={cells} p={p} "
                      f"{kernel_layout(bs)[0]:8s} {scaling:7s} "
                      f"dirichlet={dirichlet!s:5s} max_abs_err={abs_err:.3e} "
                      f"rel={rel:.3e} {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"K1 disagrees with its twin at "
                                         f"{cells} p={p}: rel {rel:.3e}")
                worst = max(worst, rel)
                if (cells, p) in timed and dirichlet and scaling == SCALING:
                    timing[(cells, p)] = time_level(
                        f"cells={cells} p={p}", op, twin, u, yk, abs_err, dev)
    print(f"kernel-vs-twin: {len(cases) * 4} cases, worst rel err "
          f"{worst:.3e} (bound {TOL_KERNEL:g})", flush=True)
    return timing


def time_level(label, op, twin, u, yk, abs_err, dev) -> dict:
    """K1's times at one level against its bound, the plain twin and the
    library call."""
    p = op.p
    tk = float(np.median(event_times(lambda: op({p: u}), 30)))
    tt = float(np.median(event_times(lambda: twin({p: u}), 30)))
    batched = batched_ms(lambda: op({p: u}), 200)
    bound, bound_by = k1_bound(op)
    lib, err = library_ms(op, u, yk, dev)
    t = dict(ms=tk, plain_ms=tt, batched_ms=batched, bound_ms=bound,
             bound_by=bound_by, library_ms=lib, max_abs_err=abs_err,
             label=label, op=op, u=u)
    print(f"apply-time {label} bs={op.tables.bs} "
          f"K1_median_ms={tk:.4f} K1_batched_ms={batched:.4f} "
          f"bound_ms={bound:.4f} ({bound_by}) share_of_bound="
          f"{bound / tk:.3f} (batched {bound / batched:.3f}) "
          f"plain_median_ms={tt:.4f} library_ms="
          + (f"{lib:.4f}" if lib is not None else f"refused ({err})"),
          flush=True)
    return t


def batched_ms(fn, reps: int) -> float:
    """ms per call of ``reps`` back-to-back calls of ``fn()`` between two
    CUDA events: near the device time where a call's kernel outlasts its
    host launch."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def profile_levels(timing: dict, tries: int = 3):
    """Phase 3, continued: K1's profiler device time per launch at each
    timed level, each level in profiler windows of its own (up to
    ``tries`` windows until one sees a device event), after all the
    event timings."""
    for t in timing.values():
        op, u = t["op"], t["u"]
        p = op.p
        t["device_ms"], used = None, 0
        while t["device_ms"] is None and used < tries:
            used += 1
            prof = profile_apply(lambda: op({p: u}), reps=30)
            if prof is not None:
                t["device_ms"] = prof["device_ms"]
        dev_ms = t["device_ms"]
        print(f"apply-device {t['label']} bs={op.tables.bs} K1_device_ms="
              + ("not measured" if dev_ms is None else
                 f"{dev_ms:.4f} share_of_bound {t['bound_ms'] / dev_ms:.3f}")
              + f" (profiler windows: {used})", flush=True)
        t.pop("op"), t.pop("u")


def solve(n: int, dev, p: int = 4, chain_k: int = 2, smoother: str = "patch",
          max_steps: int = 8):
    """Phases 4 and 10: the verified solve at n^3 elements, degree p,
    with vertex-patch (phase 4) or block-Jacobi Chebyshev (phase 10)
    smoothing."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import l2_functional
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.matrixfree.uniform import uniform_sipg_factorized
    from hpdg_tpu_torch.ops.uniform_stencil import UniformStencilOperator
    from hpdg_tpu_torch.solvers.multigrid import (PATCH_MAX_BLOCK,
                                                  matrixfree_multigrid_solver)
    from hpdg_tpu_torch.solvers.refine import refinement_solve

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # hierarchy and base as bench.py chooses them: halve while the base
    # stays >= 3 cells per axis
    base, nlev = n, 0
    while base % 2 == 0 and base // 2 >= 3:
        base //= 2
        nlev += 1
    meshes = hm.hierarchy(hm.structured((base,) * 3), nlev)
    mesh = meshes[-1]
    basis = DGBasis(mesh, np.full(mesh.n_elements, p, dtype=np.int32))
    kw = dict(penalty=PENALTY, dirichlet=True, penalty_scaling=SCALING)
    step, info = matrixfree_multigrid_solver(
        basis, meshes=meshes, smoother=smoother, use_kernel=True,
        dtype=torch.float32, device=dev, **kw)
    f = lambda x: (2 * np.pi**2 * torch.sin(np.pi * x[..., 0])  # noqa: E731
                   * torch.sin(np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]))
    b64 = l2_functional(basis, f, dtype=torch.float64, device=dev)
    A64 = uniform_sipg_factorized(basis, dtype=torch.float64, device=dev, **kw)
    A_host = uniform_sipg_factorized(basis, dtype=torch.float64, device="cpu",
                                     **kw)
    b_host = {k: v.cpu() for k, v in b64.items()}
    residual = lambda x: bv.sub(b64, A64(x))  # noqa: E731
    host_residual = lambda x: bv.sub(b_host, A_host(x))  # noqa: E731
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    ops = info["operators"]
    if not all(isinstance(op, UniformStencilOperator) and op.device == dev
               for op in ops):
        raise AssertionError("a level operator is not K1 on the card")
    if smoother == "patch":
        # every level whose patch block fits smooths by patches: the
        # solver's Chebyshev fallback must not have replaced one
        fits = [2 ** 3 * (b.bucket_degrees[0] + 1) ** 3 <= PATCH_MAX_BLOCK
                for b in info["bases"][1:]]
        built = [sm is not None for sm in info["smoothers"]]
        if built != fits:
            raise AssertionError(f"patch smoothers built {built}, expected "
                                 f"{fits} from PATCH_MAX_BLOCK")
    for op in ops:
        op.launches = 0
    x64, res = refinement_solve(step, residual, b64, chain_k=chain_k,
                                tol=1e-8, max_steps=max_steps,
                                host_residual=host_residual)
    torch.cuda.synchronize()
    launches = sum(op.launches for op in ops)
    # per V-cycle and non-coarse level: one pre and one post sweep with
    # one apply per patch color (Chebyshev: one per degree), plus the
    # residual before restriction
    cheby_degree = 3  # the solver's default
    per_cycle = sum(2 * (cheby_degree if sm is None else len(sm.color_groups))
                    + 1 for sm in info["smoothers"])
    expected = res["cycles"] * per_cycle
    peak = torch.cuda.max_memory_allocated(dev)
    if any(op.launches == 0 for op in ops):
        raise AssertionError("a level's operator never launched K1")
    if launches != expected:
        raise AssertionError(f"K1 launches {launches} != {expected} "
                             "implied by the hierarchy")
    (xp,) = x64.values()
    if tuple(xp.shape) != (mesh.n_elements, (p + 1) ** 3) \
            or not bool(torch.isfinite(xp).all()):
        raise AssertionError("solution has the wrong shape or non-finite "
                             "values")
    if not (res["verified"] and res["rel_residual"] <= 1e-8):
        raise AssertionError(f"solve at {n}^3 not verified: rel "
                             f"{res['rel_residual']:.3e}")

    # single-cycle contraction (f64 residual of the f32 iterates), and
    # the time of one V-cycle by CUDA events
    b32 = {k: v.float() for k, v in b64.items()}
    nb = float(bv.norm(b64))
    x = bv.zeros_like(b32)
    rdiag = [1.0]
    for _ in range(4):
        x = step(x, b32)
        rdiag.append(float(bv.norm(residual(
            {k: v.double() for k, v in x.items()}))) / nb)
    seq = [r for r in rdiag if r > 2e-6] or rdiag[:2]
    rate = (seq[-1] / seq[0]) ** (1.0 / max(1, len(seq) - 1))
    x0 = bv.zeros_like(b32)
    t_cycle = float(np.median(event_times(lambda: step(x0, b32), 5)))

    tag = f"solve n={n}^3 {smoother}"
    levels = " ".join(f"{b.mesh.n_elements}e/p{b.bucket_degrees[0]}"
                      for b in info["bases"])
    print(f"{tag} p={p} dofs={basis.ndof} levels=[{levels}] "
          f"setup_s={t_setup:.2f}", flush=True)
    print(f"{tag} steps={res['steps']} cycles={res['cycles']} "
          f"history={['%.3e' % h for h in res['history']]} "
          f"verified_rel_residual={res['rel_residual']:.3e} "
          f"verified={res['verified']}", flush=True)
    print(f"{tag} cycle_residuals="
          f"{['%.3e' % r for r in rdiag]} (f32 chain from zero)", flush=True)
    print(f"{tag} rate_per_cycle={rate:.4f} ms_per_vcycle="
          f"{t_cycle:.3f} solve_s={res['seconds']:.3f} "
          f"loop_s={res['seconds_loop']:.3f} peak_mem_bytes={peak} "
          f"K1_launches={launches} expected={expected} "
          f"({per_cycle} per V-cycle)", flush=True)
    prof = profile_cycles(step, x0, b32) if n == 32 else None
    if prof is not None:
        print(f"{tag} profile (3 V-cycles): K1 {prof['k1_ms']:.3f} "
              f"device ms/cycle ({prof['k1_launches']:.0f} launches), all "
              f"kernels {prof['device_ms']:.3f} device ms/cycle "
              f"({prof['launches']:.0f} launches), wall "
              f"{prof['wall_ms']:.3f} ms/cycle, busy share "
              f"{prof['device_ms'] / prof['wall_ms']:.3f}", flush=True)
    elif n == 32:
        print(f"{tag} profile: not measured (no device events)",
              flush=True)
    # contraction per V-cycle of the refinement: the anchored f64
    # residual over all cycles (each chain starts from the normalized
    # residual, so the f32 floor of the chain from zero does not enter)
    anchored = (res["history"][-1] / res["history"][0]) ** (
        1.0 / max(1, res["cycles"]))
    return dict(ndof=basis.ndof, launches=launches, anchored=anchored,
                first=rdiag[1], steps=res["steps"], cycles=res["cycles"])


def profile_cycles(step, x0, b32, cycles: int = 3):
    """Device ms of K1 and of all kernels, and wall ms, per V-cycle over
    a profiler window of ``cycles`` V-cycles; ``None`` where the profiler
    saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(x0, b32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(cycles):
            step(x0, b32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    k1 = [a for a in kernels if "stencil_" in a.key]
    return dict(
        k1_ms=sum(a.device_time_total for a in k1) / 1e3 / cycles,
        k1_launches=sum(a.count for a in k1) / cycles,
        device_ms=sum(a.device_time_total for a in kernels) / 1e3 / cycles,
        launches=sum(a.count for a in kernels) / cycles,
        wall_ms=1e3 * wall / cycles)


def profile_apply(fn, reps: int = 5):
    """Kernel launches, device ms and wall ms per call of ``fn()``, and
    the ops that take the most device time (torch.profiler); ``None``
    where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    kernels = [a for a in avgs if a.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    ops = sorted((a for a in avgs if a.device_type == DeviceType.CPU
                  and a.self_device_time_total > 0),
                 key=lambda a: -a.self_device_time_total)
    return dict(
        launches=sum(a.count for a in kernels) / reps,
        device_ms=sum(a.device_time_total for a in kernels) / 1e3 / reps,
        wall_ms=1e3 * wall / reps,
        top=[(a.key, a.self_device_time_total / 1e3 / reps, a.count / reps)
             for a in ops[:6]])


def print_profile(tag: str, prof, unit: str = "apply"):
    if prof is None:
        print(f"{tag} profile: not measured (no device events)", flush=True)
        return
    print(f"{tag} profile: {prof['launches']:.0f} kernel launches/{unit}, "
          f"device {prof['device_ms']:.4f} ms/{unit}", flush=True)
    for name, ms, count in prof["top"]:
        print(f"{tag}   {name:40s} {ms:.4f} ms/{unit} ({count:.0f} calls)",
              flush=True)


def check_rel(tag: str, want: dict, got: dict, bound: float):
    """max|got - want| / max|want| over all buckets; raises above
    ``bound`` or on non-finite values."""
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((got[p].double() - want[p].double()).abs().max())
              for p in want)
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    ok = finite and err <= bound * scale
    print(f"{tag}: max_abs_err={err:.3e} rel={err / scale:.3e} "
          f"(bound {bound:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{tag}: rel err {err / scale:.3e}")


def entry_step(dev, n: int = 8):
    """Phase 5: the sum-factorized entry step against K1."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.matrixfree import sipg_operator
    from hpdg_tpu_torch.ops.uniform_stencil import UniformStencilOperator

    p = 4
    mesh = hm.structured((n, n, n))
    basis = DGBasis(mesh, np.full(mesh.n_elements, p))
    op = sipg_operator(basis, penalty=2.0, dirichlet=True,
                       dtype=torch.float32, device=dev)
    k1 = UniformStencilOperator(basis, 2.0, True, "measure", device=dev)
    x = {p: torch.as_tensor(np.random.default_rng(1887).standard_normal(
        (mesh.n_elements, (p + 1) ** 3)), dtype=torch.float32, device=dev)}
    y = op(x)
    if tuple(y[p].shape) != tuple(x[p].shape):
        raise AssertionError("entry step: wrong output shape")
    check_rel(f"entry step sumfact-vs-K1 {n}^3 p=4", k1(x), y, TOL_KERNEL)
    ts = float(np.median(event_times(lambda: op(x), 30)))
    tk = float(np.median(event_times(lambda: k1(x), 30)))
    print(f"entry step {n}^3 p=4 dofs={basis.ndof} sumfact_median_ms={ts:.4f} "
          f"K1_median_ms={tk:.4f}", flush=True)


def adaptive_apply(dev, n: int = 14):
    """Phase 6: the adaptive apply at the bench cell's size (n = 14),
    both routes."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import build_plan
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.matrixfree import dedup_spmv_from_plan, sipg_operator
    from hpdg_tpu_torch.mesh.adaptive import close_marks, refine_local

    p = 4
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    m0 = hm.structured((n, n, n))
    mesh = refine_local(m0, close_marks(m0, rng.random(m0.n_elements) < 0.3))
    basis = DGBasis(mesh, np.full(mesh.n_elements, p))
    plan = build_plan(basis)
    t_mesh = time.perf_counter() - t0
    ndof = basis.ndof
    x = {p: torch.as_tensor(rng.standard_normal(
        (basis.bucket_size(p), (p + 1) ** 3)), dtype=torch.float32,
        device=dev)}
    print(f"adaptive {n}^3 30% p=4: elements={mesh.n_elements} dofs={ndof} "
          f"nc_faces={int((mesh.faces.nc_code > 0).sum())} "
          f"face_groups={len(plan.face_groups)} "
          f"mesh+plan_host_s={t_mesh:.2f}", flush=True)

    t0 = time.perf_counter()
    op_dd, st = dedup_spmv_from_plan(basis, dtype=torch.float32, plan=plan,
                                     device=dev, **kw)
    torch.cuda.synchronize()
    t_dd = time.perf_counter() - t0
    t0 = time.perf_counter()
    op_sf = sipg_operator(basis, dtype=torch.float32, plan=plan, device=dev,
                          **kw)
    torch.cuda.synchronize()
    t_sf = time.perf_counter() - t0
    op64 = sipg_operator(basis, dtype=torch.float64, plan=plan, device=dev,
                         **kw)
    nu = sum(st["n_unique"].values())
    print(f"adaptive dedup: unique_blocks={nu} nnz={sum(st['nnz'].values())} "
          f"compression={st['compression']:.4f} build_host_s={t_dd:.2f} "
          f"launches_per_apply(layout)={st['launches']}", flush=True)
    print(f"adaptive sumfact: build_host_s={t_sf:.2f}", flush=True)

    y64 = op64({p: x[p].double()})
    y_sf, y_dd = op_sf(x), op_dd(x)
    check_rel("adaptive sumfact-f32 vs sumfact-f64", y64, y_sf, TOL_KERNEL)
    check_rel("adaptive dedup-f32 vs sumfact-f64", y64, y_dd, TOL_KERNEL)
    check_rel("adaptive dedup-f32 vs sumfact-f32", y_sf, y_dd, TOL_KERNEL)
    for tag, op in (("sumfact", op_sf), ("dedup", op_dd)):
        ms = float(np.median(event_times(lambda: op(x), 30)))
        print(f"adaptive {tag}: median_ms_per_apply={ms:.4f} "
              f"dof_per_s={ndof / (ms / 1e3):.4e}", flush=True)
        print_profile(f"adaptive {tag}", profile_apply(lambda: op(x)))
    print(f"adaptive peak_mem_bytes={torch.cuda.max_memory_allocated(dev)}",
          flush=True)


def hp_solve(dev, cells=(8, 8, 8)):
    """Phase 7: block-Jacobi PCG in f64 on an hp-adaptive mesh, verified
    by the dedup SpMV."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import build_plan, l2_functional
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.matrixfree import (dedup_spmv_from_plan,
                                           sipg_diagonal_blocks,
                                           sipg_operator)
    from hpdg_tpu_torch.mesh.adaptive import close_marks, refine_local
    from hpdg_tpu_torch.solvers import pcg
    from hpdg_tpu_torch.solvers.smoothers import block_jacobi_preconditioner

    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
    t0 = time.perf_counter()
    m0 = hm.structured(cells)
    marks = np.random.default_rng(3).random(m0.n_elements) < 0.3
    mesh = refine_local(m0, close_marks(m0, marks))
    degrees = np.random.default_rng(1887).integers(2, 5, size=mesh.n_elements)
    basis = DGBasis(mesh, degrees)
    plan = build_plan(basis)
    op = sipg_operator(basis, dtype=torch.float64, plan=plan, device=dev,
                       **kw)
    M = block_jacobi_preconditioner(sipg_diagonal_blocks(
        basis, dtype=torch.float64, plan=plan, device=dev, **kw))
    f = lambda x: (2 * np.pi**2 * torch.sin(np.pi * x[..., 0])  # noqa: E731
                   * torch.sin(np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]))
    b = l2_functional(basis, f, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = pcg(op, b, precond=M, tol=1e-8, maxiter=5000)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    k = info["iterations"]
    hist = info["residuals"]
    dd, _ = dedup_spmv_from_plan(basis, dtype=torch.float64, plan=plan,
                                 device=dev, **kw)
    rel = float(bv.norm(bv.sub(b, dd(x))) / bv.norm(b))
    finite = all(bool(torch.isfinite(v).all()) for v in x.values())
    shapes = all(tuple(x[q].shape) == (basis.bucket_size(q), basis.n_local(q))
                 for q in basis.bucket_degrees)
    print(f"hp solve {cells[0]}^3 30% p=2..4: elements={mesh.n_elements} "
          f"dofs={basis.ndof} nc_faces={int((mesh.faces.nc_code > 0).sum())} "
          f"degrees={list(basis.bucket_degrees)} "
          f"face_groups={len(plan.face_groups)} setup_s={t_setup:.2f}",
          flush=True)
    print(f"hp solve: iterations={k} solve_s={t_solve:.3f} "
          f"ms_per_iteration={1e3 * t_solve / max(k, 1):.3f} "
          f"residual_first={float(hist[0]):.4e} "
          f"residual_last={float(hist[k]):.4e} "
          f"dedup_verified_rel_residual={rel:.4e}", flush=True)
    if not (finite and shapes):
        raise AssertionError("hp solve: wrong shape or non-finite values")
    if not (k < 5000 and rel <= 1e-8):
        raise AssertionError(f"hp solve not verified: {k} iterations, "
                             f"rel {rel:.3e}")


def host_matvec(pattern, vals: dict, x: dict) -> dict:
    """``A x`` in host numpy f64, a route independent of the port's
    ``bmm`` + ``index_add_`` SpMV."""
    out = {}
    for (pr, pc), (rows, cols) in pattern.entries.items():
        contrib = np.matmul(vals[(pr, pc)], x[pc][cols][:, :, None])[:, :, 0]
        y = np.zeros((pattern.row_sizes[pr], contrib.shape[1]))
        np.add.at(y, rows, contrib)
        out[pr] = out[pr] + y if pr in out else y
    return out


def elasticity_solve(dev, n_el: int = 24):
    """Phase 8: BASELINE config 4 as ``bench.py:698-772`` runs it: 3D
    elasticity on n_el^3 at p=2, assembled on the card in f64, the
    assembled hp-multigrid (Galerkin coarse levels, class-patch
    smoothing, GS coarse solve) in f32 inside the f64 refinement,
    verified by a host numpy f64 residual."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import (assemble_elasticity, build_plan,
                                         l2_functional_vec)
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.solvers import patches as pat
    from hpdg_tpu_torch.solvers import smoothers as sm
    from hpdg_tpu_torch.solvers.multigrid import (multigrid_solver,
                                                  setup_hierarchy)
    from hpdg_tpu_torch.solvers.refine import refinement_solve

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mc = hm.structured((n_el // 2,) * 3)
    mf = hm.refine(mc)
    basis = DGBasis(mf, np.full(mf.n_elements, 2, dtype=np.int32))
    plan = build_plan(basis)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    sm.greedy_coloring(mc)
    t_color = time.perf_counter() - t0
    t0 = time.perf_counter()
    pat.build_vertex_patches(mf)
    t_patches = time.perf_counter() - t0

    t0 = time.perf_counter()
    A64 = assemble_elasticity(basis, mu=1.0, lam=1.0, penalty=4.0,
                              dirichlet=True, plan=plan, device=dev)
    force = lambda x: torch.stack(  # noqa: E731
        [3 * np.pi ** 2 * torch.sin(np.pi * x[..., 0])
         * torch.sin(np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]),
         torch.zeros_like(x[..., 0]), torch.zeros_like(x[..., 0])], dim=-1)
    b64 = l2_functional_vec(basis, force, device=dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    asm_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    ndof = 3 * basis.ndof
    nblocks = sum(v.shape[0] for v in A64.values.values())
    gb64 = sum(v.numel() * v.element_size() for v in A64.values.values()) / 1e9
    A32 = bm.BlockSparseMatrix(A64.pattern, A64.dim,
                               {k: v.float() for k, v in A64.values.items()},
                               A64.block_shape)
    print(f"elasticity {n_el}^3 p=2: dofs={ndof} blocks={nblocks} "
          f"A64_GB={gb64:.3f} host_setup_s={t_host:.2f} "
          f"(coloring {n_el // 2}^3 {t_color:.3f} s, vertex patches "
          f"{n_el}^3 {t_patches:.3f} s) card_assembly_s={t_asm:.2f}",
          flush=True)
    if ndof != 81 * n_el ** 3:  # 1,119,744 at 24^3
        raise AssertionError(f"elasticity: {ndof} dofs")
    mf_elasticity_apply(basis, plan, A64, A32, dev)

    # the Galerkin hierarchy alone, then the whole solver set-up (the
    # hierarchy again, the class patch inverses and the coarse solve)
    t0 = time.perf_counter()
    setup_hierarchy(basis, A32, meshes=[mc, mf], dtype=torch.float32)
    torch.cuda.synchronize()
    t_hier = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, data = multigrid_solver(basis, A32, meshes=[mc, mf],
                                  smoother="patch", dtype=torch.float32)
    torch.cuda.synchronize()
    t_mg = time.perf_counter() - t0
    levels = " ".join(f"{b.mesh.n_elements}e/p{b.bucket_degrees[0]}"
                      for b in data.bases)
    coarse_dofs = 3 * data.bases[0].ndof
    print(f"elasticity hierarchy=[{levels}] smoothers={data.smoothers} "
          f"coarse={data.coarse} coarse_dofs={coarse_dofs} "
          f"galerkin_hierarchy_s={t_hier:.2f} solver_setup_s={t_mg:.2f} "
          f"(patch classes and coarse: {t_mg - t_hier:.2f} s)", flush=True)
    if not (data.coarse == "gs" and coarse_dofs == 3 * (n_el // 2) ** 3 * 8
            and len(data.smoothers) == 2
            and all(s.startswith("class-patch") for s in data.smoothers)):
        raise AssertionError("elasticity: not the class-patch hierarchy "
                             "with a GS coarse level (41,472 dofs at 24^3)")

    keys = sorted(b64)
    vals_host = {k: v.cpu().numpy() for k, v in A64.values.items()}
    b_host = {k: b64[k].cpu().numpy() for k in keys}

    def host_residual(x):
        Ax = host_matvec(A64.pattern, vals_host,
                         {k: v.numpy() for k, v in x.items()})
        return {k: torch.from_numpy(b_host[k] - Ax[k]) for k in keys}

    x64, res = refinement_solve(
        step, lambda x: bv.sub(b64, bm.matvec(A64, x)), b64, chain_k=10,
        tol=1e-8, max_steps=10, host_residual=host_residual)
    finite = all(bool(torch.isfinite(v).all()) for v in x64.values())
    shapes = all(tuple(x64[k].shape) == (basis.bucket_size(k),
                                         3 * basis.n_local(k)) for k in keys)
    b32 = {k: v.float() for k, v in b64.items()}
    x0 = bv.zeros_like(b32)
    t_cycle = float(np.median(event_times(lambda: step(x0, b32), 3)))
    prof = profile_apply(lambda: step(x0, b32), reps=2)
    peak = torch.cuda.max_memory_allocated(dev)
    anchored = (res["history"][-1] / res["history"][0]) ** (
        1.0 / max(1, res["cycles"]))
    print(f"elasticity solve: steps={res['steps']} cycles={res['cycles']} "
          f"(chain_k=10) history={['%.3e' % h for h in res['history']]} "
          f"anchored_rate_per_cycle={anchored:.4f} "
          f"host_verified_rel_residual={res['rel_residual']:.3e} "
          f"solve_s={res['seconds']:.3f} loop_s={res['seconds_loop']:.3f} "
          f"ms_per_vcycle={t_cycle:.3f} peak_mem_bytes={peak}", flush=True)
    print_profile("elasticity V-cycle", prof, unit="cycle")
    if not (finite and shapes):
        raise AssertionError("elasticity: wrong shape or non-finite values")
    if not (res["verified"] and res["rel_residual"] <= 1e-8):
        raise AssertionError(f"elasticity not verified: rel "
                             f"{res['rel_residual']:.3e}")
    return dict(assembly_s=t_asm, assembly_peak_gb=asm_peak_gb,
                peak_gb=peak / 1e9)


def mf_elasticity_apply(basis, plan, A64, A32, dev):
    """Phase 8, continued: the matrix-free elasticity apply of config 4
    against the assembled matrix on the card (f64 within 1e-11 of
    max|y|, f32 within 1e-5 of the f64 apply), its ms and launches per
    apply beside the assembled SpMV's."""
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.matrixfree.elasticity import elasticity_operator

    kw = dict(mu=1.0, lam=1.0, penalty=4.0, dirichlet=True, plan=plan,
              device=dev)
    t0 = time.perf_counter()
    op64 = elasticity_operator(basis, dtype=torch.float64, **kw)
    op32 = elasticity_operator(basis, dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(1887)
    x64 = {p: torch.randn((A64.pattern.row_sizes[p], A64.br(p)),
                          generator=gen, dtype=torch.float64, device=dev)
           for p in basis.bucket_degrees}
    x32 = {p: v.float() for p, v in x64.items()}
    y64 = op64(x64)
    check_rel("elasticity mf-f64 vs assembled A64", bm.matvec(A64, x64),
              y64, 1e-11)
    check_rel("elasticity mf-f32 vs mf-f64", y64, op32(x32), TOL_KERNEL)
    times = {}
    for tag, fn in (("mf-f64", lambda: op64(x64)),
                    ("mf-f32", lambda: op32(x32)),
                    ("spmv-f64", lambda: bm.matvec(A64, x64)),
                    ("spmv-f32", lambda: bm.matvec(A32, x32))):
        times[tag] = float(np.median(event_times(fn, 10)))
    print(f"elasticity apply {basis.mesh.n_elements} elements p=2: build_s="
          f"{t_build:.3f} median_ms_per_apply "
          + " ".join(f"{k}={v:.4f}" for k, v in times.items()), flush=True)
    print_profile("elasticity mf-f32 apply", profile_apply(lambda: op32(x32)))
    print_profile("elasticity spmv-f32 apply",
                  profile_apply(lambda: bm.matvec(A32, x32)))


def lex_parity(dev):
    """Phase 9: the scalar assembled hp-MG (re-assembled levels,
    lexicographic block GS 3+3, dense coarse solve) in f64 on the card at
    12^3 p=4, cycle by cycle against the committed history of the C++
    baseline (``cpp/baseline_mg3d.cc``), as
    ``tests/test_parity_cpp.py:84-125`` builds it."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import assemble_laplace, l2_functional
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.solvers.multigrid import multigrid_solver

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "cpp", "golden_mg3d_n12_p4.json")) as fh:
        golden = json.load(fh)
    n, p = golden["n"], golden["p"]
    # the baseline's h-levels: halve while even and above 3 cells
    base, nlev = n, 0
    while base % 2 == 0 and base > 3:
        base //= 2
        nlev += 1
    t0 = time.perf_counter()
    meshes = hm.hierarchy(hm.structured((base,) * 3), nlev)
    basis = DGBasis(meshes[-1], np.full(meshes[-1].n_elements, p,
                                        dtype=np.int32))
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal")
    A = assemble_laplace(basis, **kw, device=dev)
    fac = lambda bas: assemble_laplace(bas, **kw, device=dev)  # noqa: E731
    f = lambda x: (2 * np.pi**2 * torch.sin(np.pi * x[..., 0])  # noqa: E731
                   * torch.sin(np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]))
    b = l2_functional(basis, f, device=dev)
    step, data = multigrid_solver(basis, A, operator_factory=fac,
                                  meshes=meshes, smoother="lex",
                                  coarse="dense")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    nb = float(bv.norm(b))
    x = bv.zeros_like(b)
    hist, secs = [1.0], []
    for _ in range(len(golden["history"]) - 1):
        t0 = time.perf_counter()
        x = step(x, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        hist.append(float(bv.norm(bv.sub(b, bm.matvec(A, x)))) / nb)
    dev_max = max(abs(a - c) / (1e-10 * abs(c) + 5e-14)
                  for a, c in zip(hist, golden["history"]))
    rows = sum(bas.mesh.n_elements for bas in data.bases[1:])
    print(f"lex parity {n}^3 p={p} dofs={basis.ndof} levels="
          f"{[bas.mesh.n_elements for bas in data.bases]} "
          f"coarse={data.coarse} setup_s={t_setup:.2f} "
          f"row_solves_per_cycle={6 * rows}", flush=True)
    print(f"lex parity history={['%.6e' % h for h in hist]}", flush=True)
    print(f"lex parity golden ={['%.6e' % h for h in golden['history']]}",
          flush=True)
    print(f"lex parity s_per_cycle={['%.3f' % s for s in secs]} "
          f"worst |a-c|/(1e-10|c|+5e-14)={dev_max:.3e}", flush=True)
    if not dev_max <= 1.0:
        raise AssertionError("lex parity: a cycle deviates from the C++ "
                             "golden history")


def obstacle_solve(dev, n2: int = 128, n_runs: int = 3,
                   max_outer: int = 30):
    """Phase 11: BASELINE config 5 as ``bench.py:775-817`` builds it, a
    membrane pushed into a lower obstacle on n2^2 at p=3 (262,144 dofs
    at 128), solved by ``solve_obstacle_verified`` ``n_runs`` times;
    every run must be verified by the host numpy f64 residual, feasible
    and complementary, with a contact zone.  No retry at a smaller
    size.  ``max_outer`` is 2.5 times the solver's default of 12: at
    128^2 the active set of two runs in three was still moving after 12
    PDAS iterations, and one of them left wrong-signed multipliers; six
    runs on the card settled in 7-15."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.solvers import smoothers as sm
    from hpdg_tpu_torch.solvers.multigrid import (multigrid_solver,
                                                  parametric_cycle,
                                                  setup_hierarchy)
    from hpdg_tpu_torch.solvers.tnnmg import (_tnnmg_one_iter,
                                              solve_obstacle_verified,
                                              truncated_matrix)

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    chain = [hm.structured((16, 16), lower=(-1, -1), upper=(1, 1))]
    while chain[-1].n_elements < n2 * n2:
        chain.append(hm.refine(chain[-1]))
    mesh = chain[-1]
    basis = DGBasis(mesh, np.full(mesh.n_elements, 3, dtype=np.int32))
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    A64 = api.laplace(basis, penalty=2.0, dirichlet=True, device=dev)
    b64 = api.l2_functional(basis, lambda x: -8.0 + 0.0 * x[..., 0],
                            device=dev)
    lo, up = api.constant_bounds(basis, lower=-0.2, device=dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    ndof = basis.ndof
    nblocks = sum(v.shape[0] for v in A64.values.values())
    mb64 = sum(v.numel() * v.element_size() for v in A64.values.values()) / 1e6
    print(f"obstacle {n2}^2 p=3: dofs={ndof} elements={mesh.n_elements} "
          f"blocks={nblocks} A64_MB={mb64:.1f} "
          f"mesh_chain={[m.n_elements for m in chain]} host_setup_s="
          f"{t_mesh:.2f} card_assembly_s={t_asm:.2f}", flush=True)
    if ndof != 16 * n2 * n2:  # 262,144 at 128^2
        raise AssertionError(f"obstacle: {ndof} dofs")

    t0 = time.perf_counter()
    x64, info = solve_obstacle_verified(
        A64, b64, basis, lo, up, tol=1e-8, maxiter=40, stall_window=3,
        meshes=chain, n_runs=n_runs, max_outer=max_outer)
    t_all = time.perf_counter() - t0
    for i, run in enumerate(info["runs"]):
        print(f"obstacle run {i}: seconds={run['seconds']:.3f} (tnnmg "
              f"{run['seconds_tnnmg']:.3f}, pdas {run['seconds_pdas']:.3f}) "
              f"tnnmg_iterations={run['tnnmg_iterations']} "
              f"stalled={run['stalled']} pdas_outer={len(run['steps'])} "
              f"stationary={run['stationary']} "
              f"steps_per_outer={run['steps']} truncated={run['truncated']} "
              f"free_residual={run['free_residual']:.3e} "
              f"feasible={run['feasible']} complementarity="
              f"{run['complementarity']:.3e} verified={run['verified']}",
              flush=True)
    hist = info["tnnmg"]
    print(f"obstacle best run: tnnmg corrections="
          f"{['%.3e' % c for c in hist['correction']]} anchored per outer="
          f"{[['%.2e' % a for a in o['anchored']] for o in info['outer']]} "
          f"(set-up and {n_runs} runs {t_all:.2f} s)", flush=True)
    bad = [i for i, run in enumerate(info["runs"])
           if not (run["verified"] and run["free_residual"] <= 1e-8
                   and run["feasible"] and run["complementarity"] <= 1e-8
                   and run["truncated"] > 0)]
    if bad:
        raise AssertionError(f"obstacle runs {bad} not verified: "
                             f"{info['runs']}")
    if not all(v.shape == (mesh.n_elements, 16) and np.isfinite(v).all()
               for v in x64.values()):
        raise AssertionError("obstacle: wrong shape or non-finite values")

    # profiler windows over one f32 TNNMG iteration and one parametric
    # cycle of the PDAS phase, as the verified solve builds them
    f32 = torch.float32
    A32 = bm.BlockSparseMatrix(A64.pattern, A64.dim,
                               {k: v.to(f32) for k, v in A64.values.items()},
                               A64.block_shape)
    b32 = {k: v.to(f32) for k, v in b64.items()}
    lo32 = {k: v.to(f32) for k, v in lo.items()}
    up32 = {k: v.to(f32) for k, v in up.items()}
    mg_step, _ = multigrid_solver(basis, A32, meshes=chain, dtype=f32)
    one_iter = _tnnmg_one_iter(A32, b32, basis, lo32, up32, mg_step, 1,
                               1e-13)
    x0 = {k: torch.clamp(torch.zeros_like(v), lo32[k], up32[k])
          for k, v in b32.items()}
    free = {k: torch.as_tensor(v > -0.2 + 1e-6, device=dev)
            for k, v in x64.items()}
    data = setup_hierarchy(basis, truncated_matrix(A32, free), meshes=chain,
                           dtype=f32)
    cycle = parametric_cycle(data, dtype=f32)
    dinvs = [sm.inverse_diagonal_blocks(M) for M in data.matrices]
    nb = float(bv.norm(b32))
    rhs = {k: torch.where(free[k], v / nb, 0.0) for k, v in b32.items()}
    zero = bv.zeros_like(rhs)
    levels = [f"{b.mesh.n_elements}e/p{b.bucket_degrees[0]}"
              for b in data.bases]
    for tag, fn in (("TNNMG iteration", lambda: one_iter(x0)),
                    ("parametric cycle", lambda: cycle(data.matrices, dinvs,
                                                       zero, rhs))):
        prof = profile_apply(fn, reps=1)
        print_profile(f"obstacle {tag}", prof, unit="call")
        if prof is not None:
            print(f"obstacle {tag}: wall {prof['wall_ms']:.3f} ms/call "
                  f"under the profiler, busy share "
                  f"{prof['device_ms'] / prof['wall_ms']:.3f}", flush=True)
    print(f"obstacle hierarchy=[{' '.join(levels)}] peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated(dev)}", flush=True)


def _rel_max(tag: str, card, cpu, bound: float):
    """max|card - cpu| / max|cpu| for arrays or 0-d tensors; raises above
    ``bound``, on non-finite values or on a differing zero/NaN pattern."""
    a = np.asarray(card.cpu() if torch.is_tensor(card) else card,
                   dtype=np.float64)
    b = np.asarray(cpu.cpu() if torch.is_tensor(cpu) else cpu,
                   dtype=np.float64)
    if a.shape != b.shape or not np.array_equal(a == 0, b == 0) \
            or not np.isfinite(a).all() or not np.isfinite(b).all():
        raise AssertionError(f"{tag}: shapes, zeros or finiteness differ")
    scale = float(np.abs(b).max())
    rel = float(np.abs(a - b).max()) / scale
    print(f"config 3 card-vs-cpu {tag}: rel {rel:.3e} (bound {bound:g}) "
          f"{'ok' if rel <= bound else 'FAIL'}", flush=True)
    if not rel <= bound:
        raise AssertionError(f"{tag}: card and CPU differ, rel {rel:.3e}")


def adaptive_lshape_loop(dev, n: int = 16, levels: int = 3, steps: int = 6):
    """Phase 12: BASELINE config 3, the hp-adaptive L-shape loop of
    ``examples/adaptive_lshape.py`` through the port's entry point
    (``hpdg_tpu_torch.examples.adaptive_lshape.run``): -Δu = 1 on
    ``lshape(n)`` refined ``levels`` times (49,152 elements, 196,608
    dofs at p=1 for n=16, levels=3), ``steps`` rounds of solve (f32
    V-cycle chains in the f64 refinement, ``method="onchip"``, the
    assembled hp-multigrid with colored block GS 3+3 over the p-levels
    and the refinement history as h-levels, verified by host numpy f64),
    jump indicator, Dörfler marking at 0.4, smoothness indicator at 0.5,
    ``refine_local`` or a degree raise, and ``interpolate_to``.  Then, on
    the last solved basis: the indicators and error norms on the card
    against the port's CPU run, the carried linear function, ``unrefine``
    with ``restrict_to_coarse``, a profiler window of one V-cycle."""
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.blocks.persist import (interpolate_to,
                                               restrict_to_coarse, save_state)
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.estimators import error as err
    from hpdg_tpu_torch.estimators.smoothness import smoothness_indicator
    from hpdg_tpu_torch.examples import adaptive_lshape
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.matrixfree.norms import (ipdg_local_norm,
                                                 jump_indicator)
    from hpdg_tpu_torch.mesh.adaptive import close_marks, unrefine
    from hpdg_tpu_torch.solvers import smoothers as sm
    from hpdg_tpu_torch.solvers.multigrid import (multigrid_solver,
                                                  setup_hierarchy)

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    recs = adaptive_lshape.run(n=n, steps=steps, frac=0.4, smooth_cut=0.5,
                               levels=levels, method="onchip", device=dev)
    t_loop = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"config 3 lshape({n}) levels={levels} steps={steps}: loop "
          f"{t_loop:.2f} s, {smi()}", flush=True)
    bad = []
    for r in recs:
        b, info = r["basis"], r["info"]
        mesh = b.mesh
        hist = {int(k): int(v) for k, v in r["degrees"].items()}
        setup = r["mesh_s"] + r["assembly_s"] + r["hierarchy_s"]
        print(f"config 3 step {r['step']}: elements={mesh.n_elements} "
              f"dofs={r['ndof']} degrees={hist} "
              f"hanging_faces={int((mesh.faces.nc_code > 0).sum())} "
              f"h_levels={len(r['meshes'] or [])} setup_s={setup:.3f} (mesh "
              f"{r['mesh_s']:.3f}, plan+assembly {r['assembly_s']:.3f}, "
              f"hierarchy {r['hierarchy_s']:.3f}) solve_s={r['solve_s']:.3f} "
              f"vcycles={info['cycles']} steps={info['steps']} "
              f"verified_rel_residual={info['rel_residual']:.3e} "
              f"eta={r['eta_total']:.6e} estimate_s={r['estimate_s']:.3f} "
              f"h_marks={int(r['refine_h'].sum())} "
              f"p_marks={int(r['raise_p'].sum())} "
              f"interpolate_s={r['interpolate_s']:.3f}", flush=True)
        if not (info["verified"] and info["rel_residual"] <= 1e-8):
            bad.append(f"step {r['step']} not verified")
        if not (1 <= b.degrees.min() and b.degrees.max() <= 6):
            bad.append(f"step {r['step']} degrees {hist}")
        if close_marks(mesh, np.zeros(mesh.n_elements, bool)).any():
            bad.append(f"step {r['step']} mesh not 2:1 balanced")
        if not all(bool(torch.isfinite(v).all()) for v in r["x"].values()):
            bad.append(f"step {r['step']} non-finite solution")
    maxp = [r["basis"].max_degree() for r in recs]
    print(f"config 3 max p per step {maxp}, eta first "
          f"{recs[0]['eta_total']:.6e} last {recs[-1]['eta_total']:.6e}, "
          f"peak_mem_bytes={peak}", flush=True)
    if recs[0]["ndof"] != 4 * 3 * n * n * 4 ** levels:  # p=1 quads
        bad.append(f"{recs[0]['ndof']} dofs at step 0")
    if not recs[-1]["eta_total"] < recs[0]["eta_total"]:
        bad.append("eta did not decrease")
    if maxp[-1] < 2:
        bad.append(f"max p per step {maxp}: no degree was raised")
    if bad:
        raise AssertionError(f"config 3: {bad}")

    # the last solved basis: card against the port's CPU run
    last, prev = recs[-1], recs[-2]
    basis, x = last["basis"], last["x"]
    x_cpu = {p: v.cpu() for p, v in x.items()}
    kw = dict(penalty=2.0)
    _rel_max("jump_indicator",
             jump_indicator(basis, device=dev, **kw)(x),
             jump_indicator(basis, device="cpu", **kw)(x_cpu), 1e-10)
    _rel_max("ipdg_local_norm (dirichlet)",
             ipdg_local_norm(basis, dirichlet=True, device=dev, **kw)(x),
             ipdg_local_norm(basis, dirichlet=True, device="cpu", **kw)(x_cpu),
             1e-10)
    _rel_max("smoothness_indicator", smoothness_indicator(basis, x),
             smoothness_indicator(basis, x_cpu), 1e-10)
    u = lambda q: (torch.sin(np.pi * q[..., 0])  # noqa: E731
                   * torch.sin(np.pi * q[..., 1]))
    gu = lambda q: np.pi * torch.stack(  # noqa: E731
        [torch.cos(np.pi * q[..., 0]) * torch.sin(np.pi * q[..., 1]),
         torch.sin(np.pi * q[..., 0]) * torch.cos(np.pi * q[..., 1])], -1)
    ui = api.interpolate(basis, u, device=dev)
    ui_cpu = api.interpolate(basis, u, device="cpu")
    _rel_max("l2_error(interpolate(u))", err.l2_error(basis, ui, u),
             err.l2_error(basis, ui_cpu, u), 1e-10)
    _rel_max("h1_seminorm_error(interpolate(u))",
             err.h1_seminorm_error(basis, ui, gu),
             err.h1_seminorm_error(basis, ui_cpu, gu), 1e-10)

    # persistence: a linear function carried from the step before, and
    # merged back by unrefine + restrict_to_coarse, is reproduced
    lin = lambda q: 1.0 + q[..., 0] - 2.0 * q[..., 1]  # noqa: E731
    t0 = time.perf_counter()
    carried = interpolate_to(
        save_state(prev["basis"], api.interpolate(prev["basis"], lin,
                                                  device=dev)), basis,
        device=dev)
    torch.cuda.synchronize()
    t_carry = time.perf_counter() - t0
    check_rel("config 3 interpolate_to(linear) vs interpolate",
              api.interpolate(basis, lin, device=dev), carried, 1e-12)
    fine = basis.mesh
    t0 = time.perf_counter()
    coarse = unrefine(fine, fine.child_pos >= 0)
    t_unref = time.perf_counter() - t0
    cbasis = DGBasis(coarse, basis.degrees[coarse.parent])
    t0 = time.perf_counter()
    restricted = restrict_to_coarse(
        save_state(basis, api.interpolate(basis, lin, device=dev)), cbasis,
        device=dev)
    torch.cuda.synchronize()
    t_restrict = time.perf_counter() - t0
    merged = int((coarse.child_pos == -2).sum())
    print(f"config 3 persistence: interpolate_to {t_carry:.3f} s; unrefine "
          f"{fine.n_elements} -> {coarse.n_elements} elements ({merged} "
          f"merged groups) {t_unref:.3f} s, restrict_to_coarse "
          f"{t_restrict:.3f} s", flush=True)
    if merged == 0:
        raise AssertionError("config 3: unrefine merged no sibling group")
    check_rel("config 3 unrefine + restrict_to_coarse(linear) vs interpolate",
              api.interpolate(cbasis, lin, device=dev), restricted, 1e-12)

    # one V-cycle of the last step's solver under the profiler
    A = api.laplace(basis, penalty=2.0, dirichlet=True, device=dev)
    A32 = bm.BlockSparseMatrix(A.pattern, A.dim,
                               {k: v.float() for k, v in A.values.items()},
                               A.block_shape)
    # the last step's set-up, part by part: the Galerkin hierarchy, one
    # greedy coloring of the finest mesh, the whole solver set-up
    t0 = time.perf_counter()
    setup_hierarchy(basis, A32, meshes=last["meshes"], dtype=torch.float32)
    torch.cuda.synchronize()
    t_gal = time.perf_counter() - t0
    t0 = time.perf_counter()
    sm.greedy_coloring(basis.mesh)
    t_col = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, data = multigrid_solver(basis, A32, meshes=last["meshes"],
                                  dtype=torch.float32)
    torch.cuda.synchronize()
    t_mg = time.perf_counter() - t0
    print(f"config 3 last step set-up: galerkin_hierarchy_s={t_gal:.3f} "
          f"greedy_coloring_finest_s={t_col:.3f} (the solver colors each "
          f"smoothed level twice) solver_setup_s={t_mg:.3f}", flush=True)
    b32 = {k: v.float() for k, v in api.l2_functional(
        basis, lambda q: 1.0 + 0.0 * q[..., 0], device=dev).items()}
    x0 = bv.zeros_like(b32)
    prof = profile_apply(lambda: step(x0, b32), reps=1)
    levels_s = " ".join(f"{b.mesh.n_elements}e/p{b.max_degree()}"
                        for b in data.bases)
    print(f"config 3 hierarchy=[{levels_s}] smoothers={data.smoothers} "
          f"coarse={data.coarse}", flush=True)
    print_profile("config 3 V-cycle", prof, unit="cycle")
    if prof is not None:
        print(f"config 3 V-cycle: wall {prof['wall_ms']:.3f} ms/cycle under "
              f"the profiler, busy share "
              f"{prof['device_ms'] / prof['wall_ms']:.3f}", flush=True)
    print(f"config 3 peak_mem_bytes={torch.cuda.max_memory_allocated(dev)} "
          f"(loop {peak})", flush=True)


def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9


def _sum(x: dict) -> float:
    return sum(float(v.double().sum()) for v in x.values())


def _manufactured(x):
    """u = sin(pi x) sin(pi y) cos(pi z), -Laplace u = 3 pi^2 u."""
    return (torch.sin(torch.pi * x[..., 0]) * torch.sin(torch.pi * x[..., 1])
            * torch.cos(torch.pi * x[..., 2]))


def geometry_poisson(dev, n0: int = 8, p: int = 3, vol_tol: float = 1e-2):
    """Phase 13a: Poisson on the quarter hollow cylinder, imported as a
    lattice of hexes in VTK order, refined twice (n0^3 -> (4 n0)^3
    trilinear elements), degree ``p``, penalty 4, "normal" scaling,
    Dirichlet data of a manufactured solution.  ``vol_tol``: how close
    the polygonal domain's volume must come to 3 pi / 4 (a small-size
    rehearsal needs more room than the 32 chords per arc of the run)."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import build_plan
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.estimators.error import l2_error
    from hpdg_tpu_torch.examples import meshes as gen
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks
    from hpdg_tpu_torch.matrixfree.sumfact import sipg_operator
    from hpdg_tpu_torch.mesh import geometry as geo
    from hpdg_tpu_torch.solvers.multigrid import multigrid_solver

    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pts, cells = gen.mapped_lattice((n0,) * 3, gen.cylinder_quarter)
    base = geo.from_hex_lattice(pts, cells, (n0,) * 3)
    if base.corners is None:
        raise AssertionError("geometry: the cylinder imported as affine")
    chain = [base, hm.refine(base)]
    chain.append(hm.refine(chain[-1]))
    t_mesh = time.perf_counter() - t0

    def problem(meshes):
        """Assemble and solve on ``meshes[-1]`` with the h-levels below
        it; host-clock seconds after a device sync."""
        m = meshes[-1]
        basis = DGBasis(m, np.full(m.n_elements, p, dtype=np.int32))
        t0 = time.perf_counter()
        plan = build_plan(basis)
        t_plan = time.perf_counter() - t0
        t0 = time.perf_counter()
        A = api.laplace(basis, plan=plan, device=dev, **kw)
        torch.cuda.synchronize()
        t_asm = time.perf_counter() - t0
        asm_gb = _peak_gb(dev)
        t0 = time.perf_counter()
        b = api.l2_functional(
            basis, lambda x: 3.0 * torch.pi ** 2 * _manufactured(x),
            quad_order=2 * p + 4, device=dev)
        bd = api.dirichlet_data(basis, _manufactured, penalty=4.0, plan=plan,
                                penalty_scaling="normal", device=dev)
        b = {q: b[q] + bd[q] for q in b}
        torch.cuda.synchronize()
        t_rhs = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the GS-smoothed p3 -> p1 cycle contracts by about 0.8, on the
        # box as on the cylinder: room for 50 steps of 8 cycles
        x, info = api.solve_linear(basis, A, b, tol=1e-8, maxiter=400,
                                   meshes=meshes, method="onchip")
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        err = float(l2_error(basis, x, _manufactured))
        n1 = round(m.n_elements ** (1 / 3))
        print(f"geometry 13a {n1}^3 p={p}: dofs={basis.ndof} "
              f"plan_s={t_plan:.2f} card_assembly_s={t_asm:.2f} "
              f"(peak {asm_gb:.2f} GB) rhs_s={t_rhs:.2f} "
              f"solver_setup_s={t_all - info['seconds']:.2f} "
              f"solve_s={info['seconds']:.3f} steps={info['steps']} "
              f"vcycles={info['cycles']} "
              f"host_verified_rel_residual={info['rel_residual']:.3e} "
              f"l2_error={err:.6e}", flush=True)
        if not (info["verified"] and info["rel_residual"] <= 1e-8):
            raise AssertionError(f"geometry 13a {n1}^3 not verified: rel "
                                 f"{info['rel_residual']:.3e}")
        if not all(bool(torch.isfinite(v).all()) for v in x.values()):
            raise AssertionError("geometry 13a: non-finite solution")
        return basis, plan, A, b, x, err

    _, _, _, _, _, err_coarse = problem(chain[:2])
    basis, plan, A64, b64, x64, err_fine = problem(chain)
    m = basis.mesh
    ndof = basis.ndof
    nblocks = sum(v.shape[0] for v in A64.values.values())
    gb64 = sum(v.numel() * v.element_size() for v in A64.values.values()) / 1e9
    print(f"geometry 13a mesh: import+2 refinements {t_mesh:.2f} s, "
          f"{m.n_elements} trilinear elements, dofs={ndof} blocks={nblocks} "
          f"A64_GB={gb64:.3f}", flush=True)
    if ndof != (4 * n0) ** 3 * (p + 1) ** 3:  # 2,097,152 at 32^3 p=3
        raise AssertionError(f"geometry 13a: {ndof} dofs")

    # (i) three routes to the volume
    vol = float(m.volumes.sum())
    one = {q: torch.ones_like(v) for q, v in b64.items()}
    M1 = bm.matvec(api.mass(basis, device=dev), one)
    vol_m = sum(float((one[q] * M1[q]).sum()) for q in one)
    vol_l = _sum(api.l2_functional(
        basis, lambda x: torch.ones_like(x[..., 0]), device=dev))
    exact = 0.75 * np.pi
    print(f"geometry 13a volume: mesh={vol:.12f} 1^T M 1={vol_m:.12f} "
          f"sum l2_functional(1)={vol_l:.12f} exact={exact:.12f} "
          f"(rel {abs(vol - exact) / exact:.3e})", flush=True)
    if not (abs(vol_m - vol) <= 1e-12 * vol and abs(vol_l - vol) <= 1e-12 * vol
            and abs(vol - exact) <= vol_tol * exact):
        raise AssertionError("geometry 13a: the volumes disagree")

    # (ii) matrix-free routes against the assembled matrix
    t0 = time.perf_counter()
    op64 = sipg_operator(basis, plan=plan, dtype=torch.float64, device=dev,
                         **kw)
    op32 = sipg_operator(basis, plan=plan, dtype=torch.float32, device=dev,
                         **kw)
    torch.cuda.synchronize()
    t_ops = time.perf_counter() - t0
    gen_ = torch.Generator(device=dev).manual_seed(1887)
    v64 = {q: torch.randn(tuple(b64[q].shape), generator=gen_,
                          dtype=torch.float64, device=dev) for q in b64}
    v32 = {q: v.float() for q, v in v64.items()}
    y64 = op64(v64)
    check_rel("geometry 13a sumfact-f64 vs assembled A64",
              bm.matvec(A64, v64), y64, 1e-11)
    check_rel("geometry 13a sumfact-f32 vs sumfact-f64", y64, op32(v32),
              TOL_KERNEL)
    t0 = time.perf_counter()
    D = sipg_diagonal_blocks(basis, plan=plan, device=dev, **kw)
    torch.cuda.synchronize()
    t_diag = time.perf_counter() - t0
    check_rel("geometry 13a diagonal blocks vs extract_diagonal(A64)",
              bm.extract_diagonal(A64), D, 1e-11)
    del D

    # (iv) convergence under refinement
    ratio = err_coarse / err_fine
    print(f"geometry 13a l2_error {2 * n0}^3 -> {4 * n0}^3: "
          f"{err_coarse:.6e} -> {err_fine:.6e}, ratio {ratio:.2f} "
          f"(theory {2 ** (p + 1)})", flush=True)
    if not ratio >= 2.0 ** p:  # half the theoretical rate: 8 at p=3
        raise AssertionError(f"geometry 13a: error ratio {ratio:.2f} < "
                             f"{2 ** p}")

    # (v) one V-cycle and one sum-factorized apply under the profiler
    A32 = bm.BlockSparseMatrix(A64.pattern, A64.dim,
                               {k: v.float() for k, v in A64.values.items()},
                               A64.block_shape)
    step, data = multigrid_solver(basis, A32, meshes=chain,
                                  dtype=torch.float32)
    b32 = {q: v.float() for q, v in b64.items()}
    x0 = bv.zeros_like(b32)
    t_cycle = float(np.median(event_times(lambda: step(x0, b32), 3)))
    t_apply = {tag: float(np.median(event_times(fn, 10))) for tag, fn in (
        ("sumfact-f64", lambda: op64(v64)), ("sumfact-f32", lambda: op32(v32)),
        ("spmv-f64", lambda: bm.matvec(A64, v64)),
        ("spmv-f32", lambda: bm.matvec(A32, v32)))}
    levels = " ".join(f"{bas.mesh.n_elements}e/p{bas.bucket_degrees[0]}"
                      for bas in data.bases)
    print(f"geometry 13a hierarchy=[{levels}] smoothers={data.smoothers} "
          f"coarse={data.coarse} ms_per_vcycle={t_cycle:.3f} "
          f"operator_build_s={t_ops:.2f} diagonal_blocks_s={t_diag:.2f} "
          f"median_ms_per_apply "
          + " ".join(f"{k}={v:.4f}" for k, v in t_apply.items())
          + f" peak_mem_GB={_peak_gb(dev):.2f}", flush=True)
    for tag, fn, unit in (("geometry 13a V-cycle", lambda: step(x0, b32),
                           "cycle"),
                          ("geometry 13a sumfact-f32 apply",
                           lambda: op32(v32), "apply")):
        prof = profile_apply(fn, reps=2 if unit == "cycle" else 5)
        print_profile(tag, prof, unit=unit)
        if prof is not None:
            print(f"{tag}: wall {prof['wall_ms']:.3f} ms/{unit}, busy share "
                  f"{prof['device_ms'] / prof['wall_ms']:.3f}", flush=True)


def geometry_elasticity(dev, n_el: int = 24, box: dict | None = None):
    """Phase 13b: config 4's elasticity problem on the quarter hollow
    cylinder (``isoparametric`` on (n_el/4)^3, refined twice), assembled
    on the card through the per-point pullback and solved inside the
    f64 refinement by f32 CG preconditioned with one V-cycle of the
    assembled hierarchy.  (Curved cells have no translation classes, the
    per-patch inverses of the two finest levels pass the patch memory
    budget, and colored block GS alone contracts by only ~0.9 per cycle
    under this penalty: so the cycle preconditions CG here.)  ``box``
    holds phase 8's numbers of the same run."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import (assemble_elasticity, build_plan,
                                         l2_functional_vec)
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.examples.meshes import cylinder_quarter
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.mesh import geometry as geo
    from hpdg_tpu_torch.solvers.cg import pcg
    from hpdg_tpu_torch.solvers.multigrid import multigrid_solver
    from hpdg_tpu_torch.solvers.refine import refinement_solve

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    chain = [geo.isoparametric(hm.structured((n_el // 4,) * 3),
                               cylinder_quarter)]
    for _ in range(2):
        chain.append(hm.refine(chain[-1]))
    mf = chain[-1]
    basis = DGBasis(mf, np.full(mf.n_elements, 2, dtype=np.int32))
    plan = build_plan(basis)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    A64 = assemble_elasticity(basis, mu=1.0, lam=1.0, penalty=4.0,
                              dirichlet=True, plan=plan, device=dev)
    force = lambda x: torch.stack(  # noqa: E731
        [3 * np.pi ** 2 * torch.sin(np.pi * x[..., 0])
         * torch.sin(np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]),
         torch.zeros_like(x[..., 0]), torch.zeros_like(x[..., 0])], dim=-1)
    b64 = l2_functional_vec(basis, force, device=dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    asm_gb = _peak_gb(dev)
    ndof = 3 * basis.ndof
    gb64 = sum(v.numel() * v.element_size() for v in A64.values.values()) / 1e9
    print(f"geometry 13b elasticity {n_el}^3 p=2 on the quarter cylinder: "
          f"dofs={ndof} A64_GB={gb64:.3f} host_setup_s={t_host:.2f} "
          f"card_assembly_s={t_asm:.2f} assembly_peak_GB={asm_gb:.2f}"
          + (f" | box (phase 8): card_assembly_s={box['assembly_s']:.2f} "
             f"assembly_peak_GB={box['assembly_peak_gb']:.2f}" if box else ""),
          flush=True)
    if ndof != 81 * n_el ** 3:  # 1,119,744 at 24^3
        raise AssertionError(f"geometry 13b: {ndof} dofs")
    A32 = bm.BlockSparseMatrix(A64.pattern, A64.dim,
                               {k: v.float() for k, v in A64.values.items()},
                               A64.block_shape)
    mf_elasticity_apply(basis, plan, A64, A32, dev)

    t0 = time.perf_counter()
    cycle, data = multigrid_solver(basis, A32, meshes=chain,
                                   dtype=torch.float32)
    torch.cuda.synchronize()
    t_mg = time.perf_counter() - t0
    cg_its = 24

    def step(c, r):
        """``cg_its`` iterations of f32 CG on A32, one V-cycle (from
        zero) as its preconditioner."""
        return pcg(lambda v: bm.matvec(A32, v), r, x0=c,
                   precond=lambda z: cycle(bv.zeros_like(z), z), tol=0.0,
                   maxiter=cg_its)[0]

    levels = " ".join(f"{b.mesh.n_elements}e/p{b.bucket_degrees[0]}"
                      for b in data.bases)
    keys = sorted(b64)
    vals_host = {k: v.cpu().numpy() for k, v in A64.values.items()}
    b_host = {k: b64[k].cpu().numpy() for k in keys}

    def host_residual(x):
        Ax = host_matvec(A64.pattern, vals_host,
                         {k: v.numpy() for k, v in x.items()})
        return {k: torch.from_numpy(b_host[k] - Ax[k]) for k in keys}

    x64, res = refinement_solve(
        step, lambda x: bv.sub(b64, bm.matvec(A64, x)), b64, chain_k=1,
        tol=1e-8, max_steps=12, host_residual=host_residual)
    b32 = {k: v.float() for k, v in b64.items()}
    x0 = bv.zeros_like(b32)
    t_cycle = float(np.median(event_times(lambda: cycle(x0, b32), 3)))
    print(f"geometry 13b hierarchy=[{levels}] smoothers={data.smoothers} "
          f"coarse={data.coarse} solver_setup_s={t_mg:.2f} "
          f"steps={res['steps']} cg_iterations={cg_its * res['cycles']} "
          f"(one V-cycle each, {cg_its} per step) "
          f"history={['%.3e' % h for h in res['history']]} "
          f"host_verified_rel_residual={res['rel_residual']:.3e} "
          f"solve_s={res['seconds']:.3f} ms_per_vcycle={t_cycle:.3f} "
          f"peak_mem_GB={_peak_gb(dev):.2f}"
          + (f" | box (phase 8): peak_mem_GB={box['peak_gb']:.2f}"
             if box else ""), flush=True)
    if not all(bool(torch.isfinite(v).all()) for v in x64.values()):
        raise AssertionError("geometry 13b: non-finite solution")
    if not (res["verified"] and res["rel_residual"] <= 1e-8):
        raise AssertionError(f"geometry 13b not verified: rel "
                             f"{res['rel_residual']:.3e}")


def geometry_import(dev, nb: int = 16, layers: int = 16, p: int = 2):
    """Phase 13c: an O-grid disk extruded to hexes, cells shuffled and
    each cell's VTK numbering turned, imported by ``from_cell_vertices``
    (twisted face charts), assembled and solved on the card."""
    from hpdg_tpu_torch.assemble import (assemble_elasticity,
                                         assemble_laplace, build_plan,
                                         l2_functional)
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.examples import meshes as gen
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks
    from hpdg_tpu_torch.matrixfree.sumfact import sipg_operator
    from hpdg_tpu_torch.mesh import geometry as geo
    from hpdg_tpu_torch.mesh.adaptive import refine_local
    from hpdg_tpu_torch.solvers import smoothers as sm
    from hpdg_tpu_torch.solvers.cg import pcg

    kw = dict(penalty=4.0, dirichlet=True, penalty_scaling="normal")
    torch.cuda.reset_peak_memory_stats(dev)
    pts, cells, (n_int, n_bnd) = gen.ogrid_cylinder(nb, layers)
    scrambled = gen.shuffle_and_rotate(cells, np.random.default_rng(0))
    t0 = time.perf_counter()
    m = geo.from_cell_vertices(pts, scrambled)
    t_import = time.perf_counter() - t0
    basis = DGBasis(m, np.full(m.n_elements, p, dtype=np.int32))
    f = m.faces
    odd = ((f.in_side != 1) | (f.out_side != 0) | (f.out_axis != f.axis)
           | (f.twist != 0))
    print(f"geometry 13c O-grid {nb}x{nb} blocks x {layers} layers: "
          f"{m.n_elements} hexes, dofs={basis.ndof}, import_s={t_import:.2f}, "
          f"faces={len(m.faces)} (blocks: {n_int}) bfaces={len(m.bfaces)} "
          f"(blocks: {n_bnd}), non-classic faces={int(odd.sum())}, "
          f"trilinear={m.corners is not None}", flush=True)
    if m.faces.is_classic:
        raise AssertionError("geometry 13c: the O-grid imported classic")
    if (len(m.faces), len(m.bfaces)) != (n_int, n_bnd) \
            or m.n_elements != 5 * nb * nb * layers:
        raise AssertionError("geometry 13c: face counts differ from the "
                             "blocks'")

    def energy(bas, A):
        xp = torch.as_tensor(bas.node_positions(p), device=dev)
        u = {p: torch.sin(xp[..., 0] + 0.3) * torch.cos(0.7 * xp[..., 1])
             * (1.0 + 0.2 * xp[..., 2])}
        return sum(float((u[q] * v).sum()) for q, v in bm.matvec(A, u).items())

    t0 = time.perf_counter()
    plan = build_plan(basis)
    A = assemble_laplace(basis, plan=plan, device=dev, **kw)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    amax = max(float(v.abs().max()) for v in A.values.values())
    gen_ = torch.Generator(device=dev).manual_seed(1887)
    v = {p: torch.randn((basis.bucket_size(p), basis.n_local(p)),
                        generator=gen_, dtype=torch.float64, device=dev)}
    # symmetry block by block: the (c, r) block is the (r, c) block's
    # transpose
    rows, cols = A.pattern.entries[(p, p)]
    slot = {(int(r), int(c)): k for k, (r, c) in enumerate(zip(rows, cols))}
    mirror = torch.as_tensor([slot[(int(c), int(r))]
                              for r, c in zip(rows, cols)], device=dev)
    vals = A.values[(p, p)]
    asym = float((vals - vals[mirror].transpose(1, 2)).abs().max())
    print(f"geometry 13c assembly: plan+assemble_s={t_asm:.2f} "
          f"blocks={vals.shape[0]} max|A|={amax:.4e} "
          f"max|A - A^T|={asym:.3e} peak_mem_GB={_peak_gb(dev):.2f}",
          flush=True)
    if not asym <= 1e-11 * amax:
        raise AssertionError(f"geometry 13c: A not symmetric ({asym:.3e})")
    op = sipg_operator(basis, plan=plan, device=dev, **kw)
    check_rel("geometry 13c sumfact-f64 vs assembled A", bm.matvec(A, v),
              op(v), 1e-11)

    b = l2_functional(basis, lambda x: torch.ones_like(x[..., 0]),
                      device=dev)
    t0 = time.perf_counter()
    x, info = pcg(lambda z: bm.matvec(A, z), b,
                  precond=sm.block_jacobi_preconditioner(A), tol=1e-9,
                  maxiter=4000)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    vals_host = {k: t.cpu().numpy() for k, t in A.values.items()}
    Ax = host_matvec(A.pattern, vals_host,
                     {k: t.cpu().numpy() for k, t in x.items()})
    b_host = {k: t.cpu().numpy() for k, t in b.items()}
    rel = float(np.sqrt(sum(((b_host[k] - Ax[k]) ** 2).sum() for k in Ax))
                / np.sqrt(sum((t ** 2).sum() for t in b_host.values())))
    print(f"geometry 13c block-Jacobi PCG: iterations={info['iterations']} "
          f"solve_s={t_solve:.2f} host_verified_rel_residual={rel:.3e}",
          flush=True)
    if not (rel <= 1e-8 and all(bool(torch.isfinite(t).all())
                                for t in x.values())):
        raise AssertionError(f"geometry 13c not verified: rel {rel:.3e}")

    e_scr = energy(basis, A)
    del A, vals, vals_host
    m0 = geo.from_cell_vertices(pts, cells)
    b0 = DGBasis(m0, np.full(m0.n_elements, p, dtype=np.int32))
    e_ref = energy(b0, assemble_laplace(b0, device=dev, **kw))
    print(f"geometry 13c energy of a smooth interpolant: scrambled "
          f"{e_scr:.12e}, lattice-ordered {e_ref:.12e}, rel "
          f"{abs(e_scr - e_ref) / abs(e_ref):.3e}", flush=True)
    if not abs(e_scr - e_ref) <= 1e-10 * abs(e_ref):
        raise AssertionError("geometry 13c: the energy depends on the "
                             "cell order")

    marks = np.zeros(m.n_elements, bool)
    marks[0] = True
    for tag, call, exc in (
            ("refine_local", lambda: refine_local(m, marks), ValueError),
            ("assemble_elasticity",
             lambda: assemble_elasticity(basis, device=dev),
             NotImplementedError),
            ("sipg_diagonal_blocks",
             lambda: sipg_diagonal_blocks(basis, device=dev),
             NotImplementedError)):
        try:
            call()
        except exc as e:
            print(f"geometry 13c {tag} refuses: {type(e).__name__}: "
                  f"{str(e)[:70]}...", flush=True)
        else:
            raise AssertionError(f"geometry 13c: {tag} did not refuse")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hpdg_tpu_torch.ops import uniform_stencil
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2

    # ---- phase 1: device ----
    card = smi()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    dev = torch.device("cuda", 0)

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    uniform_stencil.build()
    print(f"build K1 ({uniform_stencil.SOURCE.name} -> "
          f"{uniform_stencil.library_path().name}): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    log = f"{uniform_stencil.library_path()}.log"
    if os.path.exists(log):
        print(open(log).read().strip(), flush=True)
    for bs in (125, 27, 8, 64):
        print(f"K1 {uniform_stencil.kernel_layout(bs)[0]} (bs={bs}): "
              f"{uniform_stencil.occupancy(bs)} resident blocks per SM",
              flush=True)

    # ---- phase 3: kernel vs plain twin ----
    timing = check_kernel(dev)
    profile_levels(timing)

    # ---- phase 4: the solves ----
    patch12 = solve(12, dev)
    main_run = solve(32, dev)

    # ---- phases 5-7: the hp-adaptive general-mesh path ----
    entry_step(dev)
    adaptive_apply(dev)
    hp_solve(dev)

    # ---- phases 8-9: the assembled hp-multigrid ----
    box = elasticity_solve(dev)
    lex_parity(dev)

    # ---- phase 10: the matrix-free solve smoothed by Chebyshev ----
    cheb = solve(12, dev, smoother="cheb", chain_k=4, max_steps=10)
    print(f"contraction per V-cycle at 12^3 p=4 (anchored history): patch "
          f"{patch12['anchored']:.4f} ({patch12['steps']} steps, "
          f"{patch12['cycles']} cycles), cheb {cheb['anchored']:.4f} "
          f"({cheb['steps']} steps, {cheb['cycles']} cycles); first cycle "
          f"from zero: patch {patch12['first']:.3e}, cheb "
          f"{cheb['first']:.3e}", flush=True)

    # ---- phase 11: the obstacle problem (config 5) ----
    obstacle_solve(dev, n_runs=2)  # two runs, not the bench's three: time

    # ---- phase 12: the hp-adaptive L-shape (config 3) ----
    adaptive_lshape_loop(dev)

    # ---- phase 13: first-class element geometry ----
    geometry_poisson(dev)
    geometry_elasticity(dev, box=box)
    geometry_import(dev)

    if "jax" in sys.modules or "hpdg_tpu" in sys.modules:
        raise AssertionError("the port imported jax or hpdg_tpu")
    t4 = timing[((32, 32, 32), 4)]
    summary = {"kernels": [{
        "name": "uniform_stencil",
        "route": "cuda",
        "source": "hpdg_tpu_torch/csrc/uniform_stencil.cu",
        "replaces": "hpdg_tpu/ops/pallas_uniform.py:230",
        "launches": main_run["launches"],
        "max_abs_err": t4["max_abs_err"],
        "ms": t4["ms"],
        "plain_ms": t4["plain_ms"],
        "bound_ms": t4["bound_ms"],
        "bound_by": t4["bound_by"],
        "library_ms": t4["library_ms"],
    }]}
    print(smi(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
