#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hpdg_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):

1. the card's name and power limit (nvidia-smi), torch/CUDA versions,
   TF32 off;
2. build the uniform-stencil kernel K1 and the block SpMV kernel K2
   (nvcc, sm_90a, both sources at once) from the sources, print ptxas'
   report (registers, spills) and each K1 instantiation's resident
   blocks per SM;
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
3b. K2 on blocks wider than 375: 3D elasticity on a 2^3 mesh at p = 4
   and 5 (blocks of 375 and 648, and 375 x 648), assembled on the card;
   ``blockmatrix.matvec`` against ``plain_matvec`` in f64 (1e-12 of
   max|y|) and f32 (1e-5), with K2 launched once per bucket, and again
   on copies of the values that are not 16-byte aligned (rows of 648
   single loads: K2's column tiles); then each bucket alone in f32 and
   f64, and 4^3 p=4 elasticity (64 block rows of 375): K2's event ms
   (and profiler device ms in f32), bound and share, the plain
   version's and the BSR product's ms, and K2's launch geometry (wide
   block rows split over thread blocks where they are few);
4. the verified 3D SIPG p=4 hp-multigrid solve at 12^3 (216,000 dofs)
   and 32^3 (4,096,000 dofs): f32 V-cycle chains, f64 anchors on the
   card, one f64 verification on the host; asserts verified <= 1e-8,
   that K1 (asked for by ``use_kernel=True``) ran as every level's
   operator, as often as the hierarchy implies, and that the patch
   smoother was built on every level whose patch block fits
   ``PATCH_MAX_BLOCK``; then both solves again by the stepwise route
   (3 runs: the spread of two stepwise histories) and by
   ``refinement_solve(fused=True, n_runs=3)``, the step captured once as
   two CUDA graphs and replayed: verified <= 1e-8, the stepwise steps,
   the history within that spread, K1's launches captured in the chain
   graph (one chain) times the chain's replays; capture and per-run
   seconds and the peak new memory of both routes; one V-cycle by CUDA
   events eager and replayed from a graph; at each level shape K1
   replayed from a graph equal to its eager launch bit for bit; at
   32^3 profiler windows of 3 V-cycles, eager and replayed: K1's
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
   pcg runs as replayed CUDA graphs of 8-iteration blocks
   (``solvers.graphs``): its captures, replays and ms per replayed
   iteration (``graph_route``), then a prefix by both routes
   (``loop_routes``: x within 1e-9, equal iterations, ms per iteration
   eager and replayed, and one block eager and one replay of the same
   loop under the profiler: launches per iteration, equal on both
   routes, device ms and busy share).  Phases 13b-c, 14d, 15a-e and
   16a-d print the same for their drivers (the profiler also for 16b's
   pmg-PCG); 13b's refinement takes its fused route, whose chain graph
   records the step's pcg with all its iterations;
8. BASELINE config 4 as ``bench.py:698-772`` runs it: 3D elasticity on
   24^3 at p=2 (1,119,744 dofs, mu = lam = 1, penalty 4, Dirichlet),
   assembled on the card in f64; the assembled hp-multigrid on the f32
   copy (Galerkin levels p2 24^3 -> p1 24^3 -> p1 12^3, class-patch
   smoothing on both smoothed levels, colored block GS on the 41,472-dof
   coarse level) inside the f64 refinement (chain_k 10, at most 10
   steps); verified <= 1e-8 by a host numpy f64 residual; set-up and
   solve seconds, ms per V-cycle (CUDA events), launches per V-cycle
   and the top ops by device time (profiler over 2 cycles), peak memory;
   the same solve by ``refinement_solve(fused=True)`` as
   ``bench.py:753-755`` runs it (one run, not its three: the script's
   time), verified <= 1e-8, with a stepwise run beside it, and the
   V-cycle eager and replayed from a graph (CUDA events, profiler, busy
   share);
   and the matrix-free elasticity apply on a seeded vector, f64 against
   the assembled A64 (1e-11 of max|y|) and f32 against f64 (1e-5), its
   ms per apply (CUDA events, median of 10) and launches per apply
   (profiler) beside the assembled SpMV's; K2, the block SpMV kernel
   that ``blockmatrix.matvec`` launches on the card, against its plain
   version (gather, ``bmm``, zero fill, ``index_add_``: the port's route
   before K2) at the three level shapes in f32 (1e-5 of max|y|) and on
   A64 in f64 (1e-12): its median ms (CUDA events), device ms and
   launches per apply (profiler), its bound (each block, x, y and the
   row table moved once, at 3.35 TB/s) and the share of it, the plain
   route's ms and ``library_ms``, one ``torch.sparse_bsr_tensor``
   product; K2's launches in the stepwise solve (the wrapper's count,
   set to 0 just before it) and, by the profiler, in one replayed chain
   of 10 V-cycles, equal to the launches captured into that graph;
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
   SIPG matrix assembled on the card, ``solve_obstacle_verified`` with
   the bench's 3 runs (f32 TNNMG, then the primal-dual active-set loop
   of f64 refinements around f32 parametric V-cycles), both phases as
   replayed CUDA graphs captured once (one TNNMG iteration; the
   refinement's anchor and chain); every run verified by host numpy
   f64: free-dof residual <= 1e-8, feasible, complementarity <= 1e-8, a
   contact zone; the capture seconds, per run the seconds of both
   phases, the iterations, outers, steps and truncated dofs; then each
   program by its graph route against its eager route: the TNNMG solve
   from zero (twice eager, once replayed: printed, since atomics make
   no two runs of its 40 unconverged iterations equal) and from the
   verified x (iterations within 2, the final iterates' f64 energies
   within 1e-6 (1 + |e|), iterates within 1e-3 of max|x|), and one replay against one eager
   iteration at each eager iterate from zero (1e-5), the
   PDAS inner solve of the verified active set from zero, capped at 24
   steps (both reach 1e-8 ||b||, steps within 1, y within 1e-6 of
   max|y|) and
   one chain replay against the eager chain (1e-5); CUDA-event ms,
   launches, device ms and busy share (profiler) of one TNNMG iteration
   and of the PDAS chain per cycle, eager and replayed, with equal
   launches asserted, and of one parametric cycle; peak memory.
11b. K2 at config 5's shapes, as phase 8 does at config 4's: against
   ``plain_matvec`` on every level of phase 11's f32 hierarchy (16 x 16
   blocks at p=3, 4 x 4 at p=1) and on A64 (f64), within 1e-5 of
   max|y| (f32) and 1e-12 (f64), one launch per apply, two applies
   bitwise equal; on the f32 levels with rows of at most 64 bytes (K2's
   narrow kernel: 16 x 16 and 4 x 4), the output bitwise equal to
   ``block_spmv.emulate``, the summation order in numpy; events and
   device ms, bound, launches per apply, the plain version's and the BSR
   product's ms;

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

14. the CG spaces, the DG->CG coarse path and the line smoother, four
   sub-phases:
   (a) the anisotropic line multigrid of
   ``examples/anisotropic_line_mg.py`` at full size: unit cube, cells
   (64, 16, 16) (4:1 stretched), p=3 (1,048,576 dofs), penalty 6,
   "normal", Dirichlet, assembled on the card; 8 f64 cycles from zero of
   ``multigrid_solver(smoother="gs")`` and ``(smoother="line")`` with
   the per-cycle contraction (asserts line < gs), the line factors' host
   seconds and tables, profiler windows of one line-smoothed cycle and
   one line solve; then ``api.solve_linear(method="onchip",
   smoother="line")`` host-verified <= 1e-8;
   (b) 16^3 p=4 Poisson (512,000 dofs, p-levels only): the conforming
   and the hanging-node DG->CG transfer of the p=1 level (4,913
   vertices, the latter's vertex-by-box search timed), then
   ``api.solve_linear(method="onchip")`` with ``coarse="gs"`` (what
   "auto" picks) and ``coarse="dgcg"``, each host-verified <= 1e-8, with
   the coarse set-up seconds, cycles and seconds per cycle;
   (c) ``cg_basis(m, 2)`` on 13c's O-grid (not imported again):
   ``cg_laplace_operator(dirichlet=True)`` against the SpMV of
   ``assemble_cg_laplace`` (1e-12), their times and launches, plain CG
   to 1e-10 verified <= 1e-8 by the host f64 matrix, the nodal agreement
   with 13c's DG solution, and the refusal of ``dg_to_cg_transfer`` on
   per-element charts (ROADMAP R9);
   (d) ``models.HeatProblem`` on 32^3 p=2 (884,736 dofs) with the
   DG->CG coarse solve, dt 0.01, 4 implicit-Euler steps, each
   host-verified <= 1e-8 and dissipating;
   ``SolverCheckpointManager(max_to_keep=3)`` saving every step and a
   bitwise restore; ``write_vtu`` of the last state into a temporary
   directory (its size; then removed); ``gridfunction.evaluate`` at 1,000
   seeded points, card against host (1e-12); step times by
   ``utils.Timer``.

15. the sharded hp layer (``hpdg_tpu_torch.parallel``) through a
   one-process shard group of 8 shards on the card:
   (a) the parallel Poisson example at size: cells (32, 32, 32), degrees
   from {2, 3, 4} (seed 1887; 2,359,296 dofs), penalty 2, "normal",
   Dirichlet, by 8 slabs and by a (2, 2, 2) device grid: the sharded
   apply against the serial ``sumfact.sipg_operator`` (1e-11 of max|y|
   in f64, 1e-5 in f32), the host build seconds per level of
   ``build_hp_sharded_hmg`` (the deepest h-chain the partition allows),
   apply times by CUDA events beside the serial apply's, launches and
   device ms per apply (profiler), the halo exchanged per apply, and
   ``hp_pmg_pcg_solve`` verified by the serial f64 apply (<= 1e-8,
   at most 200 iterations), with its iterations, seconds and peak
   memory;
   (b) config 5's size (128^2 p=3, 262,144 dofs, f32):
   ``solve_tnnmg_sharded`` against the serial ``solve_tnnmg`` on the
   same A, both run to the dryrun's tolerance (1e-6; the dryrun's 40
   iterations leave the serial solver far off at this size), with the
   dryrun's bounds (energies 1e-6, iterates 1e-3 of max, truncated > 0);
   (c) ``sharded_adaptive_solve(solver="mg-pcg")`` from 128^2 p=2
   (147,456 dofs), 1 cycle, partitions "planes" and "inherit"
   (identical meshes: the mg-pcg solver replans each cycle); on the
   final mesh x within 1e-3 of a serial block-Jacobi PCG on the card,
   residual <= 1e-5, eta within 1e-3;
   (d) ``hp_heat_apply`` on (a)'s slab lattice against the serial mass +
   dt A (f64, 1e-11);
   (e) (a)'s slab operator built through a ``torch.distributed`` NCCL
   group of world size 1 (a ``FileStore`` in a temporary directory):
   its apply and 10 block-Jacobi PCG iterations equal the one-process
   group's within 1e-13.

16. the sharded elasticity (``hpdg_tpu_torch.parallel.elasticity``)
   through a one-process shard group of 8 shards on the card:
   (a) config 4 (24^3 p=2, mu 1, lam 1, penalty 4; 1,119,744 dofs) in 8
   slabs of 3 layers: the sharded apply against the serial
   ``elasticity_operator`` under Dirichlet and natural boundaries
   (1e-11 of max|y| in f64, 1e-5 in f32), its times, launches and device
   ms beside the serial apply's and phase 8's, and
   ``elasticity_pmg_pcg_solve`` (f64, patch smoothing, no h-level: 8
   slabs of 24 cells cannot halve) verified <= 1e-8 by the serial f64
   apply within 200 iterations; (b) 13b's quarter cylinder in C-lattice
   order through ``gmesh=``: the apply against the serial curved
   operator under both penalty scalings (1e-11), then the Chebyshev
   pmg-PCG under "measure" verified likewise; (c) the ``--sharded``
   branch of ``hpdg_tpu_torch.examples.elasticity`` at the reference's
   own size; (d) (a)'s slabs through an NCCL group of world size 1: the
   apply and 10 block-Jacobi PCG iterations within 1e-13 of one process.

17. the native host kernels (``hpdg_tpu_torch.native``, ``g++`` from
   ``cpp/meshkit.cc``) and ``assemble_laplace(geom_scale=)``: (a) the
   library builds and loads; (b) ``from_boxes(topology="native")``
   against ``"python"`` on the 32^3 lattice and phase 6's refined mesh,
   canonically equal, with both times; (c) ``from_cell_vertices`` of a
   shuffled 16^3 hex import by the native and the Python frame matcher,
   equal frames and faces, and the native matcher's None on 13c's
   twisted O-grid; (d) phase 4's 32^3 solution re-verified by
   ``uniform_sipg_factorized_host`` beside the torch f64 CPU apply
   (verified residuals within 1e-12 of each other, the applies within
   1e-11 of max|y|); (e) ``geom_scale`` 1 and 0.5 at 16^3 p=4 on the
   card, 0.5 against the mesh of halved extents (1e-12).

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  ``--window-probe`` runs instead only
the count of a profiler window's launches with and without idle time at
its edges (``window_probe``) and prints no result.  Without a CUDA device, or outside a
checkout, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
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
PEAK_F64_FLOPS = 34e12
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


def wide_blocks(dev):
    """Phase 3b: ``blockmatrix.matvec`` on the card takes every block the
    reference takes.  3D elasticity on a 2^3 mesh, degrees 4 and 5 in a
    checkerboard, assembled on the card in f64 (buckets of 375, 648 and
    375 x 648): ``matvec`` held against ``plain_matvec`` in f64 (1e-12
    of max|y|) and f32 (``TOL_KERNEL``), with K2 launched once per
    bucket, on the assembled values and on copies one element off
    16-byte alignment (single loads: a 648-wide row is two column tiles
    of K2's widest lane group); the buckets per width and their times."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import assemble_elasticity
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.ops import block_spmv

    t0 = time.perf_counter()
    basis = DGBasis(hm.structured((2, 2, 2)),
                    np.array([5, 4, 4, 5, 4, 5, 5, 4], dtype=np.int32))
    A64 = assemble_elasticity(basis, mu=1.0, lam=1.0, penalty=4.0,
                              dirichlet=True, device=dev)
    torch.cuda.synchronize()
    shapes = {k: tuple(v.shape[1:]) for k, v in A64.values.items()}
    print(f"3b wide blocks: 3D elasticity 2^3 p=4/5 assembled on the card "
          f"in {time.perf_counter() - t0:.2f} s; buckets "
          + ", ".join(f"{k} {shapes[k][0]}x{shapes[k][1]}"
                      for k in sorted(shapes)), flush=True)
    if sorted(shapes.values()) != [(375, 375), (375, 648), (648, 375),
                                   (648, 648)]:
        raise AssertionError(f"3b: buckets {shapes}")

    def shifted(v, offset):
        buf = torch.empty(v.numel() + offset, dtype=v.dtype, device=dev)
        out = buf[offset:].view(v.shape)
        out.copy_(v)
        return out

    gen = torch.Generator(device=dev).manual_seed(1890)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, TOL_KERNEL)):
        for offset in (0, 1):
            A = bm.BlockSparseMatrix(
                A64.pattern, A64.dim,
                {k: shifted(v.to(dtype), offset) for k, v in
                 A64.values.items()}, A64.block_shape)
            x = {p: torch.randn((n, A.bc(p)), generator=gen, dtype=dtype,
                                device=dev)
                 for p, n in A.pattern.col_sizes.items()}
            n0 = block_spmv.launches
            y = bm.matvec(A, x)
            launched = block_spmv.launches - n0
            yp = bm.plain_matvec(A, x)
            torch.cuda.synchronize()
            err, scale = _max_gap(yp, y)
            ok = (all(bool(torch.isfinite(v).all()) for v in y.values())
                  and err <= tol * scale and launched == len(shapes))
            ms = float(np.median(event_times(lambda: bm.matvec(A, x), 10)))
            plain_ms = float(np.median(event_times(
                lambda: bm.plain_matvec(A, x), 10)))
            print(f"3b matvec vs plain_matvec {str(dtype)[6:]} "
                  f"{'aligned' if offset == 0 else 'unaligned'}: K2 "
                  f"launches per apply {launched} of {len(shapes)} buckets, "
                  f"max_abs_err {err:.3e}, rel {err / scale:.3e} (limit "
                  f"{tol:g}), events {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"3b: {dtype} offset {offset} matvec "
                                     f"rel {err / scale:.3e}, {launched} K2 "
                                     f"launches")
    # each bucket alone (aligned), then 4^3 at p=4: 64 block rows of 375
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        A = bm.BlockSparseMatrix(
            A64.pattern, A64.dim,
            {k: v.to(dtype) for k, v in A64.values.items()}, A64.block_shape)
        for key in sorted(shapes):
            k2_row(f"3b 2^3 bucket {key} {shapes[key][0]}x{shapes[key][1]}",
                   one_bucket(A, key), gen, reps=10,
                   profile=dtype == torch.float32, plain_profile=False)
    A = B64 = None
    basis = DGBasis(hm.structured((4, 4, 4)), np.full(64, 4, np.int32))
    B64 = assemble_elasticity(basis, mu=1.0, lam=1.0, penalty=4.0,
                              dirichlet=True, device=dev)
    for dtype in (torch.float32, torch.float64):
        B = bm.BlockSparseMatrix(
            B64.pattern, B64.dim,
            {k: v.to(dtype) for k, v in B64.values.items()}, B64.block_shape)
        k2_row("3b 4^3 p=4 (4, 4) 375x375", B, gen, reps=10,
               profile=dtype == torch.float32, plain_profile=False)
    B = B64 = None
    torch.cuda.empty_cache()
    print(f"3b bucket rows: {time.perf_counter() - t0:.2f} s", flush=True)


def one_bucket(M, key):
    """The bucket ``key`` of M as a matrix of its own (the same tensors)."""
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    pr, pc = key
    pat = bm.BlockPattern({pr: M.pattern.row_sizes[pr]},
                          {pc: M.pattern.col_sizes[pc]},
                          {key: M.pattern.entries[key]}, diag_first=False)
    return bm.BlockSparseMatrix(pat, M.dim, {key: M.values[key]},
                                M.block_shape)


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
    from hpdg_tpu_torch.solvers.refine import capture_graph, refinement_solve

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
    kw_solve = dict(chain_k=chain_k, tol=1e-8, max_steps=max_steps,
                    host_residual=host_residual)
    for op in ops:
        op.launches = 0
    x64, res = refinement_solve(step, residual, b64, **kw_solve)
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

    fused = fused_solve(f"solve n={n}^3 {smoother}", step, residual, b64,
                        kw_solve, res, dev, ops=ops,
                        chain_launches=chain_k * per_cycle)

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
    graph, _ = capture_graph(lambda: step(x0, b32), dev)
    t_graph = float(np.median(event_times(graph.replay, 5)))
    print(f"{tag} V-cycle by events: eager {t_cycle:.3f} ms, replayed "
          f"graph {t_graph:.3f} ms", flush=True)
    if n == 32:
        for route, fn in (("eager", lambda: step(x0, b32)),
                          ("replayed", graph.replay)):
            prof = profile_cycles(fn)
            if prof is None:
                print(f"{tag} profile {route}: not measured (no device "
                      f"events)", flush=True)
                continue
            print(f"{tag} profile {route} (3 V-cycles): K1 "
                  f"{prof['k1_ms']:.3f} device ms/cycle "
                  f"({prof['k1_launches']:.0f} launches), all kernels "
                  f"{prof['device_ms']:.3f} device ms/cycle "
                  f"({prof['launches']:.0f} launches), wall "
                  f"{prof['wall_ms']:.3f} ms/cycle, busy share "
                  f"{prof['device_ms'] / prof['wall_ms']:.3f}", flush=True)
            if prof["k1_launches"] != per_cycle:
                raise AssertionError(f"{tag}: the profiler saw "
                                     f"{prof['k1_launches']} K1 launches per "
                                     f"{route} V-cycle, not {per_cycle}")
    del graph
    k1_graph_vs_eager(tag, ops, dev)
    # contraction per V-cycle of the refinement: the anchored f64
    # residual over all cycles (each chain starts from the normalized
    # residual, so the f32 floor of the chain from zero does not enter)
    anchored = (res["history"][-1] / res["history"][0]) ** (
        1.0 / max(1, res["cycles"]))
    out = dict(ndof=basis.ndof, launches=launches, anchored=anchored,
               first=rdiag[1], steps=res["steps"], cycles=res["cycles"],
               graph_launches=fused["graph_launches"])
    if n == 32:  # phase 17d re-verifies the solution on the host
        out.update(basis=basis, p=p, A_host=A_host, b_host=b_host,
                   x_host={k: v.cpu() for k, v in x64.items()})
    return out


def _history_gap(a: list, b: list) -> float:
    """Largest relative difference of two refinement histories over the
    steps both ran."""
    return max(abs(x - y) / x for x, y in zip(a, b))


# idle host seconds on each side of each edge of a profiler window
WINDOW_GAP_S = 0.1


def traced(body, warm):
    """Runs ``body()`` in the active step of a ``torch.profiler``
    schedule whose warm-up step runs ``warm()`` (CUPTI can miss the
    first kernels of a fresh trace, and the warm-up step takes that
    loss); returns the device events of the active step (kernels,
    copies, fills) as ``(name, device ms)`` pairs, and the wall seconds
    of ``body()`` to its synchronize.

    The active step keeps the events whose timestamps fall inside it,
    and its edges are uncertain by a few ms: with no wait at them,
    windows of one eager PDAS chain lost its first kernels or held some
    of the warm-up's last ones.  So host and card idle ``WINDOW_GAP_S``
    before and after the step opens, and again before it closes;
    ``python3 chip_smoke.py --window-probe`` counts windows both ways."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        time.sleep(WINDOW_GAP_S)
        prof.step()
        time.sleep(WINDOW_GAP_S)
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(WINDOW_GAP_S)
    # the step's annotation also has a device span (its wall time): it
    # is not a kernel
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")], wall


def graph_k1_launches(step, residual, b64: dict, kw: dict, ops,
                      chain_launches: int) -> int:
    """K1 launches that the chain graph's replays make on the card in one
    fused run, counted by the profiler (CUPTI records each kernel a
    replay runs).  The wrapper's ``launches`` counts the eager warm-up's,
    which the window holds too; the rest must be one chain's launches
    for every chain replay, ``steps - 1`` of them."""
    from hpdg_tpu_torch.solvers.refine import refinement_solve
    for op in ops:
        op.launches = op.captured = 0
    kw = {k: v for k, v in kw.items() if k != "host_residual"}
    out = {}

    def body():
        out["info"] = refinement_solve(step, residual, b64, fused=True,
                                       **kw)[1]

    kernels, _ = traced(body, lambda: residual(b64))
    info = out["info"]
    seen = sum("stencil_" in name for name, _ in kernels)
    warm = sum(op.launches for op in ops)
    replayed = seen - warm
    if (warm != chain_launches
            or replayed != chain_launches * (info["steps"] - 1)):
        raise AssertionError(
            f"K1 launches seen by the profiler in a fused run: {seen}, "
            f"{warm} of them eager, expected {chain_launches} eager and "
            f"{chain_launches} x {info['steps'] - 1} chain replays")
    return replayed


def fused_solve(tag: str, step, residual, b64: dict, kw: dict,
                stepwise: dict, dev, ops=(), chain_launches: int = 0,
                n_runs: int = 3) -> dict:
    """Phases 4 and 8: the solve that gave ``stepwise`` again, 3 runs by
    the stepwise route, then ``n_runs`` by ``refinement_solve(fused=
    True)``, whose two CUDA graphs are captured once.  index_add_
    atomics make no two card runs equal where indices collide, so the
    yardstick is the spread of the stepwise runs: the largest gap
    between any two of the four stepwise histories.  Asserts the fused
    solve verified <= 1e-8, every fused run in the stepwise solve's
    steps, and each fused history within that spread of the nearest
    stepwise one.  With K1's ``ops``: the launches captured in the chain
    graph are ``chain_launches`` (one chain), the warm-up's eager ones as
    many, and ``graph_k1_launches`` counts on the card what the graph's
    replays launch in a further, profiled fused run.  Prints both
    routes' run seconds and peak new memory, the capture seconds and the
    launch counts."""
    from hpdg_tpu_torch.solvers.refine import refinement_solve

    def route(n, **extra):
        mem0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _, info = refinement_solve(step, residual, b64, n_runs=n, **kw,
                                   **extra)
        torch.cuda.synchronize()
        return info, torch.cuda.max_memory_allocated(dev) - mem0

    again, peak_eager = route(3)
    hists = [stepwise["history"]] + [r["history"] for r in again["runs"]]
    spread = max(_history_gap(a, b)
                 for i, a in enumerate(hists) for b in hists[i + 1:])
    for op in ops:
        op.launches = op.captured = 0
    fused, peak_fused = route(n_runs, fused=True)
    captured = sum(op.captured for op in ops)
    warm = sum(op.launches for op in ops)
    gap = max(min(_history_gap(h, r["history"]) for h in hists)
              for r in fused["runs"])
    print(f"{tag} fused (n_runs={n_runs}): capture_s="
          f"{fused['seconds_capture']:.4f} run_s="
          f"{[round(r['seconds'], 4) for r in fused['runs']]} loop_s="
          f"{fused['seconds_loop']:.4f} steps="
          f"{[r['steps'] for r in fused['runs']]} replays={fused['replays']} "
          f"verified_rel_residual={fused['rel_residual']:.3e} "
          f"peak_new_bytes={peak_fused}; stepwise run_s="
          f"{[round(r['seconds'], 4) for r in again['runs']]} loop_s="
          f"{again['seconds_loop']:.4f} steps="
          f"{[r['steps'] for r in again['runs']]} peak_new_bytes="
          f"{peak_eager}", flush=True)
    print(f"{tag} fused history={['%.6e' % h for h in fused['history']]} "
          f"gap to the nearest stepwise history {gap:.3e} (largest gap "
          f"between two of {len(hists)} stepwise runs {spread:.3e})",
          flush=True)
    if not (fused["verified"] and fused["rel_residual"] <= 1e-8):
        raise AssertionError(f"{tag}: fused solve not verified: rel "
                             f"{fused['rel_residual']:.3e}")
    if any(r["steps"] != stepwise["steps"] for r in fused["runs"]):
        raise AssertionError(f"{tag}: fused steps differ from the "
                             f"stepwise {stepwise['steps']}")
    if gap > spread:
        raise AssertionError(f"{tag}: fused history {gap:.3e} from the "
                             f"stepwise ones, beyond {spread:.3e}")
    graph_launches = None
    if ops:
        chains = sum(r["steps"] - 1 for r in fused["runs"])
        if (captured != chain_launches or warm != chain_launches
                or fused["replays"]["chain"] != chains):
            raise AssertionError(f"{tag}: K1 launches in the graphs do not "
                                 f"match the hierarchy")
        graph_launches = graph_k1_launches(step, residual, b64, kw, ops,
                                           chain_launches)
        print(f"{tag} K1 in the chain graph: {captured} captured launches "
              f"(one chain: {chain_launches}), {warm} in the warm-up, "
              f"{chains} chain replays over {n_runs} runs; a profiled fused "
              f"run: {graph_launches} launches from the graph's "
              f"{graph_launches // chain_launches} replays on the card",
              flush=True)
    return dict(graph_launches=graph_launches, info=fused)


def k1_graph_vs_eager(tag: str, ops, dev):
    """Phase 4, continued: at each level shape K1 replayed from a graph
    of one apply against its eager launch on the same input, bit for bit
    (K1 sums in a fixed order, without atomics)."""
    from hpdg_tpu_torch.solvers.refine import capture_graph

    rng = np.random.default_rng(11)
    for op in ops:
        n, bs = op.basis.mesh.n_elements, op.tables.bs
        u = torch.as_tensor(rng.standard_normal((n, bs)),
                            dtype=torch.float32, device=dev)
        y_eager = op.launch(u)
        graph, y_graph = capture_graph(lambda: op.launch(u), dev)  # noqa: B023
        graph.replay()
        torch.cuda.synchronize()
        same = torch.equal(y_eager, y_graph)
        print(f"{tag} K1 graph replay vs eager at {n}e bs={bs}: "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        if not same:
            raise AssertionError(f"{tag}: K1 in a graph differs from K1 "
                                 f"eager at {n}e bs={bs}")


def profile_cycles(cycle, cycles: int = 3):
    """Device ms of K1 and of all kernels, and wall ms, per V-cycle over
    a profiler window of ``cycles`` calls of ``cycle()`` (one V-cycle,
    eager or a graph's replay); ``None`` where the profiler saw no
    device activity."""
    def body():
        for _ in range(cycles):
            cycle()

    kernels, wall = traced(body, cycle)
    if not kernels:
        return None
    k1 = [ms for name, ms in kernels if "stencil_" in name]
    return dict(
        k1_ms=sum(k1) / cycles,
        k1_launches=len(k1) / cycles,
        device_ms=sum(ms for _, ms in kernels) / cycles,
        launches=len(kernels) / cycles,
        wall_ms=1e3 * wall / cycles,
        by_name=collections.Counter(name for name, _ in kernels))


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


# ---------------------------------------------------------------------------
# the reference's device loops as replayed CUDA graphs (solvers.graphs)
# ---------------------------------------------------------------------------

def _flat_card(x) -> torch.Tensor:
    """A driver's iterate (a tensor or a bucket dict) as one f64 vector."""
    if isinstance(x, dict):
        return torch.cat([x[k].reshape(-1).double() for k in sorted(x)])
    return x.reshape(-1).double()


def graph_route(tag: str, fn, per_iteration: bool = True):
    """Runs ``fn()``, a phase's own call of a driver (its graph route),
    with the loop counts set to 0 just before it; prints the graphs
    captured, their warm-up and capture seconds, the replays, and (where
    ``fn`` is one loop: ``per_iteration``) the ms per replayed iteration
    (host clock: the call less its warm-ups and captures, over the
    iterations replayed); fails where no loop was replayed.  Returns
    ``fn()``'s result."""
    from hpdg_tpu_torch.solvers import graphs
    torch.cuda.synchronize()
    graphs.reset_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    c = dict(graphs.counts)
    ms = 1e3 * (secs - c["capture_seconds"]) / max(c["iterations"], 1)
    print(f"{tag} graph route: {c['captures']} capture(s), warm-up and "
          f"capture {c['capture_seconds']:.3f} s, {c['replays']} replays, "
          f"{c['iterations']} iterations replayed"
          + (f", {ms:.3f} ms per replayed iteration" if per_iteration
             else "") + f"; the call {secs:.3f} s", flush=True)
    if not c["replays"]:
        raise AssertionError(f"{tag}: no loop was replayed")
    return out


def _made_loops():
    """A context manager that lists every ``DeviceLoop`` created inside
    it (the driver's own loops, kept alive for a profiler window)."""
    import contextlib
    from hpdg_tpu_torch.solvers import graphs

    @contextlib.contextmanager
    def recording():
        made, init = [], graphs.DeviceLoop.__init__

        def record(self, *args, **kwargs):
            init(self, *args, **kwargs)
            made.append(self)

        graphs.DeviceLoop.__init__ = record
        try:
            yield made
        finally:
            graphs.DeviceLoop.__init__ = init

    return recording()


def loop_routes(tag: str, call, counts: tuple, bound: float,
                profile: bool = False):
    """A driver on a bounded prefix by both routes.  ``call(m)`` runs the
    driver for ``m`` iterations (its count or its ``maxiter``) and
    returns ``(x, iterations run)``.  The eager route runs the same
    bodies launch by launch (``graphs.eager_loops``), the graph route
    captures and replays them.  Each route runs at ``n1`` and at ``n2``
    (``counts``); the difference of the two calls, each less its
    warm-ups and captures, is ``n2 - n1`` iterations, eager or replayed,
    without the driver's set-up: it gives the ms per iteration (host
    clock).  Asserts equal iterations at ``n2``, the graph route's x
    within ``bound`` of max|x| of the eager route's, and replays on the
    graph route.  With ``profile``, the driver's own loop of the graph
    route's last call runs one more iteration eagerly and one replay of
    its block, each in a profiler window with idle edges (``traced``):
    launches and device ms per iteration and the busy share of both
    routes on the same static buffers, and the launches per iteration
    must be equal."""
    import contextlib
    from hpdg_tpu_torch.solvers import graphs
    n1, n2 = counts
    res, loop = {}, None
    for route in ("eager", "graph"):
        ctx = (graphs.eager_loops() if route == "eager"
               else contextlib.nullcontext())
        runs = {}
        with ctx:
            for m in (n1, n2):
                graphs.reset_counts()
                with _made_loops() as made:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    x, k = call(m)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                c = dict(graphs.counts)
                runs[m] = (wall - c["capture_seconds"], c["replays"],
                           _flat_card(x).clone(), k, made)
        (w1, _, _, _, _), (w2, replays, x, k, made) = runs[n1], runs[n2]
        res[route] = dict(x=x, k=k, ms=1e3 * (w2 - w1) / (n2 - n1),
                          replays=replays)
        if route == "graph":
            loop = next((lp for lp in reversed(made)
                         if lp.graph is not None), None)
    e, g = res["eager"], res["graph"]
    gap = float((e["x"] - g["x"]).abs().max()) / max(
        float(e["x"].abs().max()), 1e-300)
    line = (f"{tag} eager vs graph at {n2} iterations: iterations "
            f"{e['k']} / {g['k']}, x gap {gap:.3e} of max|x| (bound "
            f"{bound:.0e}); ms per iteration (calls at {n1} and {n2}, less "
            f"their captures) eager {e['ms']:.3f}, replayed {g['ms']:.3f} "
            f"({g['replays']} replays at {n2})")
    if e["k"] != g["k"] or not gap <= bound or not g["replays"]:
        print(line, flush=True)
        raise AssertionError(f"{tag}: the graph route differs from the "
                             f"eager one ({e['k']} / {g['k']} iterations, "
                             f"gap {gap:.3e}, {g['replays']} replays)")
    if profile:
        if loop is None:
            raise AssertionError(f"{tag}: no captured loop to profile")

        def one_iteration():
            block, loop.block = loop.block, 1
            try:
                loop._run_block()
            finally:
                loop.block = block

        for route, fn, its in (("eager", one_iteration, 1),
                               ("graph", loop.graph.replay, loop.block)):
            # the warm-up step runs the same work (a window after a
            # warm-up of one small op lost kernels at its edge)
            kernels, wall = traced(fn, fn)
            if not kernels:
                raise AssertionError(f"{tag}: the profiler saw no kernels")
            dev_ms = sum(ms for _, ms in kernels)
            res[route].update(
                launches=len(kernels) / its, device_ms=dev_ms / its,
                wall_ms=1e3 * wall / its, busy=dev_ms / (1e3 * wall),
                names=collections.Counter(name for name, _ in kernels))
            if route == "eager":  # per iteration, like the replay's
                res[route]["names"] = collections.Counter(
                    {k: v * loop.block
                     for k, v in res[route]["names"].items()})
        line += (f"; one eager iteration and one replay of {loop.block} "
                 f"under the profiler: "
                 f"launches per iteration eager {e['launches']:.2f}, "
                 f"replayed {g['launches']:.2f}; device ms per iteration "
                 f"eager {e['device_ms']:.4f}, replayed {g['device_ms']:.4f};"
                 f" wall ms per iteration eager {e['wall_ms']:.3f}, replayed "
                 f"{g['wall_ms']:.3f}; busy share eager {e['busy']:.3f}, "
                 f"replayed {g['busy']:.3f}")
    print(line, flush=True)
    if profile and e["launches"] != g["launches"]:
        diff = e["names"].copy()
        diff.subtract(g["names"])
        print(f"{tag} launches that differ (eager minus replayed, one "
              f"block's worth): {[(k, v) for k, v in diff.items() if v][:12]}",
              flush=True)
        raise AssertionError(f"{tag}: launches per iteration differ, eager "
                             f"{e['launches']} replayed {g['launches']}")
    return res


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
    x, info = graph_route("7 pcg", lambda: pcg(op, b, precond=M, tol=1e-8,
                                               maxiter=5000))
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
    # the same pcg on a prefix of 16 iterations by both routes; f64 sums
    # whose index_add_ atomics collide come in another order per run
    loop_routes("7 pcg", lambda m: (lambda x, i: (x, i["iterations"]))(
        *pcg(op, b, precond=M, tol=1e-8, maxiter=m)), (8, 16), 1e-9,
        profile=True)


def host_matvec(pattern, vals: dict, x: dict) -> dict:
    """``A x`` in host numpy f64, a route independent of the port's SpMV
    (K2 on the card)."""
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
    from hpdg_tpu_torch.ops import block_spmv
    from hpdg_tpu_torch.solvers import patches as pat
    from hpdg_tpu_torch.solvers import smoothers as sm
    from hpdg_tpu_torch.solvers.multigrid import (multigrid_solver,
                                                  setup_hierarchy)
    from hpdg_tpu_torch.solvers.refine import capture_graph, refinement_solve

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
    apply_ms = mf_elasticity_apply(basis, plan, A64, A32, dev)

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
    k2 = k2_levels(data, A64, dev)

    keys = sorted(b64)
    vals_host = {k: v.cpu().numpy() for k, v in A64.values.items()}
    b_host = {k: b64[k].cpu().numpy() for k in keys}

    def host_residual(x):
        Ax = host_matvec(A64.pattern, vals_host,
                         {k: v.numpy() for k, v in x.items()})
        return {k: torch.from_numpy(b_host[k] - Ax[k]) for k in keys}

    residual = lambda x: bv.sub(b64, bm.matvec(A64, x))  # noqa: E731
    kw_solve = dict(chain_k=10, tol=1e-8, max_steps=10,
                    host_residual=host_residual)
    block_spmv.launches = block_spmv.captured = 0
    x64, res = refinement_solve(step, residual, b64, **kw_solve)
    torch.cuda.synchronize()
    k2_launches = block_spmv.launches
    print(f"elasticity K2 launches in the stepwise solve: {k2_launches} "
          f"({res['steps']} anchors, {res['cycles']} V-cycles)", flush=True)
    if k2_launches == 0:
        raise AssertionError("elasticity: the solve never launched K2")
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
    # bench.py:753-755's route, fused, but one fused run, not three (15 s
    # less of the script's time limit); three stepwise runs give the
    # spread that the fused history is held to
    fused_solve("elasticity", step, residual, b64, kw_solve, res, dev,
                n_runs=1)
    graph, _ = capture_graph(lambda: step(x0, b32), dev)
    t_graph = float(np.median(event_times(graph.replay, 3)))
    prof_graph = profile_apply(graph.replay, reps=2)
    print_profile("elasticity V-cycle replayed", prof_graph, unit="cycle")
    busy = lambda pr: ("not measured" if pr is None  # noqa: E731
                       else f"{pr['device_ms'] / pr['wall_ms']:.3f}")
    print(f"elasticity V-cycle by events: eager {t_cycle:.3f} ms, replayed "
          f"graph {t_graph:.3f} ms; busy share eager {busy(prof)}, "
          f"replayed {busy(prof_graph)}", flush=True)
    del graph
    k2_chain = k2_chain_launches(step, b32, kw_solve["chain_k"], dev)
    return dict(assembly_s=t_asm, assembly_peak_gb=asm_peak_gb,
                peak_gb=peak / 1e9, apply_ms=apply_ms, k2=k2,
                k2_launches=k2_launches, k2_chain=k2_chain)


def k2_chain_launches(step, b32: dict, chain_k: int, dev) -> int:
    """K2's launches in one replayed chain of ``chain_k`` V-cycles (the
    fused refinement's chain without its scaling and update, which
    launch no SpMV), counted by the profiler on the card; asserts they
    equal the launches the wrapper counted into the graph's capture."""
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.ops import block_spmv
    from hpdg_tpu_torch.solvers.refine import capture_graph

    def chain():
        c = bv.zeros_like(b32)
        for _ in range(chain_k):
            c = step(c, b32)
        return c

    block_spmv.captured = 0
    graph, _ = capture_graph(chain, dev)
    captured = block_spmv.captured
    kernels, wall = traced(graph.replay, graph.replay)
    seen = [ms for name, ms in kernels if "block_spmv" in name]
    print(f"elasticity K2 in one replayed chain of {chain_k} V-cycles: "
          f"{len(seen)} launches ({captured} captured), "
          f"{sum(seen):.3f} of {sum(ms for _, ms in kernels):.3f} device "
          f"ms in {len(kernels)} kernels, wall {1e3 * wall:.3f} ms",
          flush=True)
    del graph
    if not seen or len(seen) != captured:
        raise AssertionError(f"K2 launches in a replayed chain: the profiler "
                             f"saw {len(seen)}, the capture recorded "
                             f"{captured}")
    return len(seen)


def k2_bound(M) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take
    for ``matvec(M, x)``: each block, x, y and K2's row table moved once
    at the HBM rate, against 2 br bc FLOP per block at the FP32 or FP64
    rate of the values' type."""
    nbytes = flops = 0.0
    for (pr, pc), v in M.values.items():
        nnz, br, bc = v.shape
        size = v.element_size()
        nr, nc = M.pattern.row_sizes[pr], M.pattern.col_sizes[pc]
        nbytes += size * (nnz * br * bc + nc * bc + nr * br)
        nbytes += 4 * (nr + 1 + 2 * nnz)
        flops += 2.0 * nnz * br * bc
    peak = PEAK_F32_FLOPS if next(iter(M.values.values())).dtype \
        == torch.float32 else PEAK_F64_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bsr_spmv_ms(M, x: dict, yk: dict, tol: float):
    """Median ms of ``A @ x`` with the one bucket of M as a
    ``torch.sparse_bsr_tensor`` (a row-sorted copy of its values), held
    to K2's ``yk``; ``(None, reason)`` where M has several buckets or
    PyTorch refuses; the copy is freed before returning."""
    if len(M.values) != 1:
        return None, "several buckets"
    ((pr, pc), vals), = M.values.items()
    A = xs = yl = None
    try:
        t = M.spmv_table((pr, pc), vals.device)
        A = torch.sparse_bsr_tensor(
            t["row_ptr"].long(), t["col"].long(), vals[t["slot"].long()],
            size=(M.pattern.row_sizes[pr] * vals.shape[1],
                  M.pattern.col_sizes[pc] * vals.shape[2]),
            check_invariants=False)
        xs = x[pc].reshape(-1, 1)
        yl = (A @ xs).reshape(yk[pr].shape)
        torch.cuda.synchronize()
        rel = float((yl - yk[pr]).abs().max()) / float(yk[pr].abs().max())
        if not rel <= tol:
            raise AssertionError(f"BSR product disagrees with K2: rel "
                                 f"{rel:.3e}")
        return float(np.median(event_times(lambda: A @ xs, 10))), None
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    finally:
        A = xs = yl = None  # noqa: F841
        torch.cuda.empty_cache()


def k2_profile(apply, k2_launches: int = 0, reps: int = 10,
               tries: int = 3) -> dict:
    """Device ms and launches per call of ``apply()`` over a profiler
    window of ``reps`` calls with idle edges (``traced``).  With
    ``k2_launches`` (K2's launches per call), the device ms are K2's
    mean kernel time times that count, which a kernel lost at a
    window's edge does not bias, and a window that saw no K2 kernel is
    taken again, up to ``tries`` windows (after phase 11 a window of 10
    config-5 applies once saw no kernel at all)."""
    def body():
        for _ in range(reps):
            apply()

    for _ in range(tries if k2_launches else 1):
        kernels, _ = traced(body, apply)
        k2 = [ms for name, ms in kernels if "block_spmv" in name]
        if k2:
            break
    if k2_launches:
        dev_ms = sum(k2) / len(k2) * k2_launches if k2 else None
    else:
        dev_ms = sum(ms for _, ms in kernels) / reps if kernels else None
    return dict(device_ms=dev_ms, launches=len(kernels) / reps)


def k2_levels(data, A64, dev, prefix: str = "") -> list:
    """Phase 8, continued (and 11b with ``prefix`` "config 5 "): K2
    against its plain version at each level of config 4's (config 5's)
    hierarchy (f32) and on A64 (f64), with its times, bound and launches
    per apply beside the plain route's and the BSR product's
    (:func:`k2_row`)."""
    gen = torch.Generator(device=dev).manual_seed(1888)
    cases = [(f"{prefix}level {l} {b.mesh.n_elements}e/"
              f"p{b.bucket_degrees[0]}", M)
             for l, (b, M) in enumerate(zip(data.bases, data.matrices))]
    out = [k2_row(tag, M, gen)
           for tag, M in cases[::-1] + [(f"{prefix}A64", A64)]]
    torch.cuda.empty_cache()
    return out


def k2_row(tag, M, gen, reps: int = 30, profile: bool = True,
           plain_profile: bool = True, x: dict | None = None) -> dict:
    """K2 on M against its plain version (f32 within ``TOL_KERNEL`` of
    max|y|, f64 within 1e-12, one launch per bucket), two applies
    bitwise equal and, where every bucket takes K2's narrow kernel (f32
    rows of at most 64 bytes), bitwise equal to ``block_spmv.emulate``;
    then its event ms (median of ``reps``), profiler device ms and
    launches per apply (with ``profile``), bound and share, the plain
    version's event ms (and device ms with ``plain_profile``), the BSR
    product's ms and K2's launch geometry.  ``x``: the vector (else drawn
    from ``gen``)."""
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.ops import block_spmv

    v0 = next(iter(M.values.values()))
    dtype, dev = v0.dtype, v0.device
    if x is None:
        x = {p: torch.randn((n, M.bc(p)), generator=gen, dtype=dtype,
                            device=dev)
             for p, n in M.pattern.col_sizes.items()}
    n0 = block_spmv.launches
    yk = bm.matvec(M, x)
    launched = block_spmv.launches - n0
    yp = bm.plain_matvec(M, x)
    torch.cuda.synchronize()
    err, scale = _max_gap(yp, yk)
    tol = TOL_KERNEL if dtype == torch.float32 else 1e-12
    shapes = sorted({tuple(v.shape[1:]) for v in M.values.values()})
    blocks = sum(v.shape[0] for v in M.values.values())
    ok = all(bool(torch.isfinite(v).all()) for v in yk.values()) \
        and err <= tol * scale and launched == len(M.values)
    print(f"K2-vs-plain {tag} {str(dtype)[6:]} blocks={blocks} "
          f"block_shapes={shapes} max_abs_err={err:.3e} "
          f"rel={err / scale:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version at "
                             f"{tag}: rel {err / scale:.3e}, "
                             f"{launched} launches")
    again = bm.matvec(M, x)
    torch.cuda.synchronize()
    if not all(torch.equal(again[p], yk[p]) for p in yk):
        raise AssertionError(f"K2 at {tag}: two applies differ")
    layouts = [block_spmv.layout(
        dtype, v.shape[1], v.shape[2], v.data_ptr() % 16 == 0,
        M.pattern.row_sizes[k[0]], M.spmv_table(k, dev)["max_row_nnz"],
        block_spmv.sm_count(dev)) for k, v in M.values.items()]
    bitwise = None
    if dtype == torch.float32 and all(L["narrow"] for L in layouts):
        want = block_spmv.emulate_matvec(M, x)
        bitwise = all(np.array_equal(
            yk[p].cpu().numpy().view(np.int32), want[p].view(np.int32))
            for p in yk)
        print(f"K2-vs-emulation {tag}: f32 output bitwise "
              f"{'equal' if bitwise else 'DIFFERENT'}", flush=True)
        if not bitwise:
            raise AssertionError(f"K2 at {tag}: not the emulated order")
    ms = float(np.median(event_times(lambda: bm.matvec(M, x), reps)))
    plain_ms = float(np.median(event_times(
        lambda: bm.plain_matvec(M, x), reps)))
    prof = (k2_profile(lambda: bm.matvec(M, x), len(M.values)) if profile
            else dict(device_ms=None, launches=launched))
    prof_plain = (k2_profile(lambda: bm.plain_matvec(M, x)) if plain_profile
                  else dict(device_ms=None, launches="not measured"))
    bound, bound_by = k2_bound(M)
    lib, why = bsr_spmv_ms(M, x, yk, tol)
    dev_ms = prof["device_ms"]
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
    geometry = ", ".join(
        f"narrow gw={L['gw']} grid={L['grid']}" if L["narrow"]
        else f"wide shape={L['shape']} slices={L['slices']} grid={L['grid']}"
        for L in layouts)
    print(f"K2-time {tag} {str(dtype)[6:]}: events_ms={ms:.4f} "
          f"device_ms={fmt(dev_ms)} launches_per_apply="
          f"{prof['launches']} bound_ms={bound:.4f} ({bound_by}) "
          f"share_of_bound events={bound / ms:.3f} device="
          + ("not measured" if dev_ms is None else f"{bound / dev_ms:.3f}")
          + f"; plain (gather+bmm+zero+index_add_) events_ms="
          f"{plain_ms:.4f} ({plain_ms / ms:.2f} x K2) device_ms="
          f"{fmt(prof_plain['device_ms'])} launches_per_apply="
          f"{prof_plain['launches']}; library_ms (BSR) "
          + (fmt(lib) if lib is not None else f"refused ({why})")
          + f"; K2 geometry {geometry}", flush=True)
    return dict(tag=tag, dtype=str(dtype), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib, max_abs_err=err, bitwise_emulation=bitwise,
                layouts=layouts)


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
    return times


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
    at 128), solved by ``solve_obstacle_verified`` ``n_runs`` times (the
    bench's 3) through its replayed CUDA graphs, captured once; every
    run must be verified by the host numpy f64 residual, feasible and
    complementary, with a contact zone.  No retry at a smaller size.
    ``max_outer`` is 2.5 times the solver's default of 12: at 128^2 the
    active set of two runs in three was still moving after 12 PDAS
    iterations, and one of them left wrong-signed multipliers; six runs
    on the card settled in 7-15.  Then each of the two programs by its
    graph route against its eager route (``obstacle_tnnmg_routes``,
    ``obstacle_pdas_routes``) and the profiler windows, eager and
    replayed, with equal launches asserted."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.solvers.multigrid import multigrid_solver
    from hpdg_tpu_torch.solvers.tnnmg import solve_obstacle_verified

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
    print(f"obstacle graphs (one TNNMG iteration; the PDAS anchor and "
          f"chain) captured once: capture_s={info['seconds_capture']:.4f}",
          flush=True)
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

    f32 = torch.float32
    A32 = bm.BlockSparseMatrix(A64.pattern, A64.dim,
                               {k: v.to(f32) for k, v in A64.values.items()},
                               A64.block_shape)
    b32 = {k: v.to(f32) for k, v in b64.items()}
    lo32 = {k: v.to(f32) for k, v in lo.items()}
    up32 = {k: v.to(f32) for k, v in up.items()}
    nb = float(bv.norm(b64))
    mg_step, data = multigrid_solver(basis, A32, meshes=chain, dtype=f32)
    solver = obstacle_tnnmg_routes(A64, b64, A32, b32, basis, lo32, up32,
                                   mg_step, x64)
    # the truncated system of the verified x's active set
    free = {k: torch.as_tensor(v > -0.2 + 1e-6, device=dev)
            for k, v in x64.items()}
    eager, refine = obstacle_pdas_routes(A64, A32, basis, chain, b64, lo,
                                         free, nb)

    # profiler windows, as the verified solve builds its programs: one
    # TNNMG iteration and the PDAS chain (per cycle) eager and replayed,
    # and one parametric cycle alone on the eager route's hierarchy (the
    # truncated one of ``free``)
    rhs = {k: torch.where(free[k], v / nb, 0.0) for k, v in b32.items()}
    zero = bv.zeros_like(rhs)
    levels = [f"{b.mesh.n_elements}e/p{b.bucket_degrees[0]}"
              for b in eager.data.bases]
    k = refine.chain_k
    windows = (("TNNMG iteration", solver.body, solver.graph.replay, 1),
               ("PDAS chain per cycle", refine._chain,
                refine.graphs[1].replay, k))
    for tag, run_eager, run_replay, per in windows:
        fns = (run_eager, run_replay)
        ms = [float(np.median(event_times(fn, 5))) / per for fn in fns]
        got = [profile_cycles(fn, cycles=1) for fn in fns]
        if None in got:
            raise AssertionError(f"obstacle {tag}: no device events")
        for route, prof, t in zip(("eager", "replayed"), got, ms):
            print(f"obstacle {tag} {route}: {t:.3f} ms by events; profiler "
                  f"{prof['device_ms'] / per:.4f} device ms in "
                  f"{prof['launches'] / per:.1f} launches, wall "
                  f"{prof['wall_ms'] / per:.3f} ms, busy share "
                  f"{prof['device_ms'] / prof['wall_ms']:.3f}", flush=True)
        if got[0]["launches"] != got[1]["launches"]:
            eager_n, replay_n = got[0]["by_name"], got[1]["by_name"]
            diff = {name: (eager_n.get(name, 0), replay_n.get(name, 0))
                    for name in set(eager_n) | set(replay_n)
                    if eager_n.get(name, 0) != replay_n.get(name, 0)}
            raise AssertionError(f"obstacle {tag}: {got[1]['launches']} "
                                 f"launches replayed, {got[0]['launches']} "
                                 f"eager; (eager, replayed) by kernel where "
                                 f"they differ: {diff}")
    prof = profile_apply(lambda: eager.cycle(eager.mats, eager.dinvs, zero,
                                             rhs), reps=1)
    print_profile("obstacle parametric cycle", prof, unit="call")
    if prof is not None:
        print(f"obstacle parametric cycle: wall {prof['wall_ms']:.3f} "
              f"ms/call under the profiler, busy share "
              f"{prof['device_ms'] / prof['wall_ms']:.3f}", flush=True)
    print(f"obstacle hierarchy=[{' '.join(levels)}] peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated(dev)}", flush=True)
    return dict(data=data, A64=A64)


def _max_gap(want: dict, got: dict) -> tuple:
    """(max|got - want|, max|want|) over the buckets, in f64."""
    return (max(float((got[k].double() - want[k].double()).abs().max())
                for k in want),
            max(float(v.abs().max()) for v in want.values()))


def obstacle_tnnmg_routes(A64, b64, A32, b32, basis, lo32, up32, mg_step,
                          x64):
    """Phase 11, program 1: the f32 TNNMG with the verified solve's
    settings (tol 1e-6 ||b||, 40 iterations, stall window 3) by the
    eager loop (``solve_tnnmg``) and by the replayed graph
    (``tnnmg_fused_solver``, what ``solve_tnnmg(fused=True)`` returns).

    From zero, as the solve runs it, 40 iterations end far from the
    solution at 128^2 and the stall rule fires at random: ``index_add_``
    atomics make no two runs equal, and the gaps grow with the
    iterations (two eager runs, one graph run: iterations, energies and
    truncated counts printed, not compared).  The end states are held to
    15b's bounds for two f32 routes that round in another order from the
    verified solution ``x64``, where the iteration contracts: iterations
    within 2, final energies within 1e-6 (1 + |e|), iterates within 1e-3
    of max|x|.  The energies are those of the final iterates evaluated in
    f64 with ``A64``: the loop's own f32 energy is a sum of 262,144 f32
    terms whose rounding (about 1e-5 at |e| = 4.6) differs between any
    two runs.  Along the eager trajectory from zero, every iteration
    once more as one replay from the same x: x_new within 1e-5 of
    max|x_new|, the correction, damping and energy within 1e-5 relative.
    Returns the fused solver."""
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.solvers.tnnmg import (_tnnmg_one_iter,
                                              solve_tnnmg,
                                              tnnmg_fused_solver)

    def energy64(x):
        x = {k: v.double() for k, v in x.items()}
        return float(0.5 * bv.dot(x, bm.matvec(A64, x)) - bv.dot(b64, x))

    nb = float(bv.norm(b64))
    kw = dict(mg_step=mg_step, tol=1e-6 * nb, maxiter=40, stall_window=3)
    args = (A32, b32, basis, lo32, up32)
    t0 = time.perf_counter()
    solver = tnnmg_fused_solver(*args, **kw)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    warm = {k: torch.as_tensor(v, dtype=torch.float32, device=b32[k].device)
            for k, v in x64.items()}
    for start, x0 in (("zero", None), ("the verified x", warm)):
        runs = []
        for route in ("eager", "eager", "graph")[start != "zero":]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (solve_tnnmg(*args, x0=x0, **kw) if route == "eager"
                   else solver(x0))
            torch.cuda.synchronize()
            runs.append((route, time.perf_counter() - t0) + out)
        print(f"obstacle TNNMG from {start}: " + "; ".join(
            f"{route} {h['iterations']} its in {t:.3f} s "
            f"({1e3 * t / max(h['iterations'], 1):.2f} ms/it), stalled "
            f"{h.get('stalled', False)}, energy {h['energy'][-1]:.9e}, "
            f"truncated {h['truncated'][-1]}" for route, t, _, h in runs)
            + (f"; capture {t_capture:.3f} s" if x0 is None else ""),
            flush=True)
    (_, _, xs, hs), (_, _, xf, hf) = runs
    err, scale = _max_gap(xs, xf)
    es, ef = energy64(xs), energy64(xf)
    print(f"obstacle TNNMG graph against eager from the verified x: "
          f"iterations {hs['iterations']} / {hf['iterations']} (bound 2 "
          f"apart), f64 energies {es:.12e} / {ef:.12e}, gap "
          f"{abs(es - ef):.3e} (bound {1e-6 * (1 + abs(es)):.3e}; the "
          f"loop's f32 energies {abs(hs['energy'][-1] - hf['energy'][-1]):.3e}"
          f" apart), iterate err {err:.3e} of max {scale:.3e} (bound 1e-3)",
          flush=True)
    if not (abs(hs["iterations"] - hf["iterations"]) <= 2
            and abs(es - ef) <= 1e-6 * (1.0 + abs(es))
            and err <= 1e-3 * scale):
        raise AssertionError("obstacle TNNMG: graph and eager routes differ")
    one_iter = _tnnmg_one_iter(*args, mg_step, 1, 1e-13)
    x = {k: torch.clamp(torch.zeros_like(v), lo32[k], up32[k])
         for k, v in b32.items()}
    worst = [0.0, 0.0]
    for _ in range(kw["maxiter"]):
        for k in solver.x:
            solver.x[k].copy_(x[k])
        solver.graph.replay()
        x, diag = one_iter(x)
        err, scale = _max_gap(x, solver.x)
        rel = max(abs(float(g) - float(e)) / max(abs(float(e)), 1e-30)
                  for g, e in zip(solver.diag[:3], diag[:3]))
        worst = [max(worst[0], err / scale), max(worst[1], rel)]
    print(f"obstacle TNNMG one replay against one eager iteration from the "
          f"same x, at each of {kw['maxiter']} eager iterates: worst x_new "
          f"{worst[0]:.3e} of max|x_new|, correction, damping, energy "
          f"{worst[1]:.3e} relative (bounds 1e-5)", flush=True)
    if not max(worst) <= 1e-5:
        raise AssertionError("obstacle TNNMG: a replay differs from an "
                             "eager iteration")
    return solver


def window_probe(dev, reps: int = 10):
    """``python3 chip_smoke.py --window-probe``: the launches that
    ``profile_cycles`` counts in ``reps`` windows of one eager PDAS chain
    and 4 of its replay, on config 5's truncated system for a random
    free mask (seed 0), with no idle time at the window's edges and with
    ``WINDOW_GAP_S``; by kernel name, how each count that is not the
    most common one differs from it."""
    global WINDOW_GAP_S
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.solvers.multigrid import (parametric_cycle,
                                                  setup_hierarchy)
    from hpdg_tpu_torch.solvers.tnnmg import (TruncatedRefinement,
                                              truncated_matrix)
    f32 = torch.float32
    chain = [hm.structured((16, 16), lower=(-1, -1), upper=(1, 1))]
    while chain[-1].n_elements < 128 * 128:
        chain.append(hm.refine(chain[-1]))
    basis = DGBasis(chain[-1], np.full(chain[-1].n_elements, 3, np.int32))
    A64 = api.laplace(basis, penalty=2.0, dirichlet=True, device=dev)
    b64 = api.l2_functional(basis, lambda x: -8.0 + 0.0 * x[..., 0],
                            device=dev)
    A32 = bm.BlockSparseMatrix(A64.pattern, A64.dim,
                               {k: v.to(f32) for k, v in A64.values.items()},
                               A64.block_shape)
    gen = torch.Generator(device=dev).manual_seed(0)
    free = {k: torch.rand(v.shape, generator=gen, device=dev) > 0.4
            for k, v in b64.items()}
    data = setup_hierarchy(
        basis, truncated_matrix(A32, {k: torch.ones_like(v)
                                      for k, v in free.items()}),
        meshes=chain, dtype=f32)
    ref = TruncatedRefinement(A64, A32, data,
                              parametric_cycle(data, dtype=f32), b64,
                              max_steps=2)
    ref(free, {k: torch.where(free[k], b64[k], 0.0) for k in free}, 0.0)
    gap = WINDOW_GAP_S
    for WINDOW_GAP_S in (0.0, gap):
        for route, fn, n in (("eager", ref._chain, reps),
                             ("replayed", ref.graphs[1].replay, 4)):
            got = [profile_cycles(fn, cycles=1)["by_name"]
                   for _ in range(n)]
            counts = [sum(c.values()) for c in got]
            mode = collections.Counter(counts).most_common(1)[0][0]
            base = got[counts.index(mode)]
            print(f"window probe, gap {WINDOW_GAP_S} s, {route} chain: "
                  f"launches {counts}", flush=True)
            for c in got:
                if sum(c.values()) != mode:
                    print(f"  {sum(c.values())}: " + str(
                        {k[:60]: c[k] - base[k] for k in set(c) | set(base)
                         if c[k] != base[k]}), flush=True)
    WINDOW_GAP_S = gap


def obstacle_pdas_routes(A64, A32, basis, chain, b64, lo, free, nb):
    """Phase 11, program 2: the PDAS inner solve of one truncated system
    (the free mask ``free``; ``b_tr = F (b - A x_act)``, x_act the
    obstacle on the active dofs) by ``TruncatedRefinement`` eager and
    replayed, each on a hierarchy of its own, from the same start y = 0:
    both reach 1e-8 ||b||, their steps differ by at most 1, their y
    agree within 1e-6 of max|y|; then one chain replay against the eager
    chain from the same anchor (r, ||r||) within 1e-5 of max|c|.  From
    zero the solve's cap of 12 steps floors at about 1.3e-7 ||b|| (the
    reference measured the same at this size, which is why it
    warm-starts every outer), so here the cap is 24.  Returns both
    (eager, fused)."""
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.solvers.multigrid import (parametric_cycle,
                                                  setup_hierarchy)
    from hpdg_tpu_torch.solvers.tnnmg import (TruncatedRefinement,
                                              truncated_matrix)
    lo64 = {k: v.double() for k, v in lo.items()}
    Axa = bm.matvec(A64, {k: torch.where(free[k], 0.0, lo64[k])
                          for k in free})
    b_tr = {k: torch.where(free[k], b64[k] - Axa[k], 0.0) for k in free}
    all_free = {k: torch.ones_like(v) for k, v in free.items()}
    tol_cut = 1e-8 * nb
    got = {}
    for fused in (False, True):
        data = setup_hierarchy(basis, truncated_matrix(A32, all_free),
                               meshes=chain, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = TruncatedRefinement(
            A64, A32, data, parametric_cycle(data, dtype=torch.float32), b64,
            max_steps=24, fused=fused)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hist = ref(free, b_tr, tol_cut)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got[fused] = (ref, hist)
        print(f"obstacle PDAS inner solve {'graph' if fused else 'eager'}: "
              f"{len(hist)} steps in {t2 - t1:.3f} s, build {t1 - t0:.3f} s,"
              f" anchored {['%.3e' % (h / nb) for h in hist]}", flush=True)
    (eager, he), (fused, hf) = got[False], got[True]
    err, scale = _max_gap(eager.y, fused.y)
    print(f"obstacle PDAS graph against eager: y err {err:.3e} of max "
          f"{scale:.3e} (bound 1e-6)", flush=True)
    if not (he[-1] <= tol_cut and hf[-1] <= tol_cut
            and abs(len(he) - len(hf)) <= 1 and err <= 1e-6 * scale):
        raise AssertionError("obstacle PDAS: graph and eager routes differ")
    g_anchor, g_chain = fused.graphs
    fused.reset()
    g_anchor.replay()  # r = b_tr, nr = ||b_tr||
    g_chain.replay()
    y_graph = {k: v.clone() for k, v in fused.y.items()}
    fused.reset()
    fused._chain()
    err, scale = _max_gap(fused.y, y_graph)  # y = nr c from y = 0
    print(f"obstacle PDAS one chain replay against the eager chain: c err "
          f"{err:.3e} of max {scale:.3e} (bound 1e-5)", flush=True)
    if not err <= 1e-5 * scale:
        raise AssertionError("obstacle PDAS: a chain replay differs from "
                             "the eager chain")
    return eager, fused


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

    # the fused route: the chain graph records the step's pcg with all
    # its cg_its iterations (no host read under a caller's capture); the
    # chain's warm-up calls pcg eagerly, which captures a graph of its own
    from hpdg_tpu_torch.solvers import graphs
    graphs.reset_counts()
    x64, res = refinement_solve(
        step, lambda x: bv.sub(b64, bm.matvec(A64, x)), b64, chain_k=1,
        tol=1e-8, max_steps=12, host_residual=host_residual, fused=True)
    print(f"geometry 13b fused refinement: capture_s="
          f"{res['seconds_capture']:.3f} replays={res['replays']} "
          f"({cg_its} pcg iterations in each chain replay); pcg's own "
          f"graphs (the chain's warm-up): {graphs.counts['captures']} "
          f"capture(s), {graphs.counts['replays']} replays", flush=True)
    if dev.type == "cuda" and res["replays"]["chain"] != res["steps"] - 1:
        raise AssertionError("geometry 13b: the chain graph was not "
                             "replayed per step")
    b32 = {k: v.float() for k, v in b64.items()}
    r1 = {k: v / float(bv.norm(b32)) for k, v in b32.items()}
    # one step's pcg (from zero, f32) on a prefix of 16 iterations (two
    # blocks) by both routes: f32 sums with colliding index_add_ atomics
    loop_routes("13b pcg step", lambda m: (lambda x, i: (
        x, i["iterations"]))(*pcg(lambda v: bm.matvec(A32, v), r1,
                                  precond=lambda z: cycle(bv.zeros_like(z),
                                                          z),
                                  tol=0.0, maxiter=m)), (8, 16), 1e-4)
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
    M = sm.block_jacobi_preconditioner(A)
    x, info = graph_route("geometry 13c pcg", lambda: pcg(
        lambda z: bm.matvec(A, z), b, precond=M, tol=1e-9, maxiter=4000))
    t_solve = time.perf_counter() - t0
    loop_routes("geometry 13c pcg", lambda m: (lambda x, i: (
        x, i["iterations"]))(*pcg(lambda z: bm.matvec(A, z), b, precond=M,
                                  tol=1e-9, maxiter=m)), (8, 16), 1e-9)
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
    return dict(mesh=m, x=x, p=p)


def _host_rel(pattern, vals: dict, x: dict, b: dict) -> float:
    """||b - A x|| / ||b|| in host numpy f64 (``host_matvec``)."""
    Ax = host_matvec(pattern, vals, x)
    return float(np.sqrt(sum(((b[k] - Ax[k]) ** 2).sum() for k in Ax))
                 / np.sqrt(sum((v ** 2).sum() for v in b.values())))


def _to_host(x: dict) -> dict:
    return {k: v.detach().cpu().double().numpy() for k, v in x.items()}


def _sines(x):
    """3 pi^2 sin(pi x) sin(pi y) sin(pi z): -Laplace of the product."""
    return 3 * torch.pi**2 * (torch.sin(torch.pi * x[..., 0])
                              * torch.sin(torch.pi * x[..., 1])
                              * torch.sin(torch.pi * x[..., 2]))


def line_mg(dev, cells=(64, 16, 16), p: int = 3, cycles: int = 8):
    """Phase 14a: the anisotropic line multigrid of
    ``examples/anisotropic_line_mg.py`` at full size: 4:1 cells, the
    assembled p-multigrid with colored block-GS and with line smoothing,
    f64 cycles from zero, then the line-smoothed verified solve (f32
    cycles in the f64 refinement).  The
    p=1 level (131,072 dofs at full size) takes the DG->CG coarse solve:
    the default 40-sweep GS coarse solve contracts by 0.98-0.99 per cycle
    there, and h-levels of Galerkin SIPG matrices by 0.95-0.98."""
    from hpdg_tpu_torch.assemble import assemble_laplace, l2_functional
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.mesh import structured
    from hpdg_tpu_torch.solvers import lines
    from hpdg_tpu_torch.solvers.multigrid import multigrid_solver

    kw = dict(penalty=6.0, dirichlet=True, penalty_scaling="normal")
    torch.cuda.reset_peak_memory_stats(dev)
    m = structured(cells)
    basis = DGBasis(m, np.full(m.n_elements, p, dtype=np.int32))
    t0 = time.perf_counter()
    A = assemble_laplace(basis, device=dev, **kw)
    b = l2_functional(basis, _sines, device=dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    A32 = bm.BlockSparseMatrix(A.pattern, A.dim, {k: v.float() for k, v
                                                   in A.values.items()})
    b32 = {k: v.float() for k, v in b.items()}
    nb = float(bv.norm(b))
    a_gb = sum(v.numel() * v.element_size() for v in A.values.values()) / 1e9
    print(f"14a line MG cells={cells} p={p}: dofs={basis.ndof} "
          f"assembly_s={t_asm:.2f} A64_GB={a_gb:.3f}", flush=True)

    # every factorization the hierarchy builds: host seconds, its level's
    # dofs and tables (the solver imports the module attribute per build)
    log = []
    factor = lines.line_tridiag_factor

    def logged(M, bas, axis=0, lines=None):
        t = time.perf_counter()
        fac = factor(M, bas, axis=axis, lines=lines)
        log.append(dict(s=time.perf_counter() - t, ndof=bas.ndof, axis=axis,
                        host_gb=sum(fac[k].nbytes for k in ("Sinv", "W", "U"))
                        / 1e9, fac=fac))
        return fac

    lines.line_tridiag_factor = logged
    try:
        rates, hists = {}, {}
        for smoother in ("gs", "line"):
            log.clear()
            t0 = time.perf_counter()
            # f64 cycles: f32 ones stall near the f32 floor (2.4e-4 of
            # ||b|| at (32, 8, 8) p=2 on the CPU) within 4 line cycles,
            # and the rate would measure the floor
            step, data = multigrid_solver(basis, A, smoother=smoother,
                                          coarse="dgcg", jacobi_damping=1.0)
            torch.cuda.synchronize()
            t_setup = time.perf_counter() - t0
            x, hist = bv.zeros_like(b), []
            t0 = time.perf_counter()
            for _ in range(cycles):
                x = step(x, b)
                hist.append(float(bv.norm(bv.sub(b, bm.matvec(A, x)))) / nb)
            t_cyc = (time.perf_counter() - t0) / cycles
            rates[smoother] = (hist[-1] / hist[0]) ** (1.0 / (cycles - 1))
            hists[smoother] = hist
            per = [hist[i] / hist[i - 1] for i in range(1, cycles)]
            print(f"14a {smoother:>4}: smoothers={data.smoothers} "
                  f"coarse={data.coarse} setup_s={t_setup:.2f} "
                  f"s_per_cycle={t_cyc:.4f} rate/cycle="
                  f"{rates[smoother]:.4f} per-cycle contraction "
                  f"{['%.3f' % c for c in per]} history "
                  f"{['%.2e' % h for h in hist]}", flush=True)
            if smoother == "line":
                for e in log:
                    print(f"14a line factor: level dofs={e['ndof']} axis="
                          f"{e['axis']} host_s={e['s']:.2f} tables host f64 "
                          f"GB={e['host_gb']:.3f} (card f32 "
                          f"{e['host_gb'] / 2:.3f})", flush=True)
                print_profile("14a one line-smoothed f64 V-cycle",
                              profile_apply(lambda: step(x, b), reps=1),
                              unit="cycle")
                fine = max(log, key=lambda e: e["ndof"])
                solve = lines.line_solve(fine["fac"], dtype=torch.float32,
                                         device=dev)
                print_profile(f"14a one line solve (K={fine['fac']['dims'][1]}"
                              f" positions, {fine['fac']['dims'][0]} lines)",
                              profile_apply(lambda: solve(b32), reps=3),
                              unit="solve")
                log.clear()
            del step, data
        if not all(np.isfinite(h).all() for h in hists.values()) \
                or not rates["line"] < rates["gs"]:
            raise AssertionError(f"14a: line rate {rates['line']:.4f} does "
                                 f"not beat gs {rates['gs']:.4f}")
        print(f"14a contraction per cycle at {basis.ndof} dofs: line "
              f"{rates['line']:.4f} < gs {rates['gs']:.4f}", flush=True)

        x, info = api.solve_linear(basis, A, b, tol=1e-8, maxiter=80,
                                   method="onchip", smoother="line",
                                   coarse="dgcg", jacobi_damping=1.0)
        print(f"14a api.solve_linear(onchip, line): steps={info['steps']} "
              f"cycles={info['cycles']} solve_s={info['seconds']:.2f} "
              f"host_verified_rel_residual={info['rel_residual']:.3e} "
              f"factor_host_s={sum(e['s'] for e in log):.2f} "
              f"peak_mem_GB={_peak_gb(dev):.2f}", flush=True)
        if not (info["verified"] and info["rel_residual"] <= 1e-8):
            raise AssertionError("14a: the line-smoothed solve is not "
                                 f"verified ({info['rel_residual']:.3e})")
    finally:
        lines.line_tridiag_factor = factor
        log.clear()


def dgcg_path(dev, n: int = 16, p: int = 4):
    """Phase 14b: the DG->CG coarse path on an n^3 p-lattice beside the
    GS coarse solve that ``coarse="auto"`` picks there."""
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.mesh import structured
    from hpdg_tpu_torch.solvers import multigrid as mg
    from hpdg_tpu_torch.transfer import dgtocg

    m = structured((n,) * 3)
    basis = DGBasis(m, np.full(m.n_elements, p, dtype=np.int32))
    A = api.laplace(basis, penalty=PENALTY, dirichlet=True,
                    penalty_scaling=SCALING, device=dev)
    b = api.l2_functional(basis, _sines, device=dev)
    A32 = bm.BlockSparseMatrix(A.pattern, A.dim, {k: v.float() for k, v
                                                   in A.values.items()})
    _, data = mg.multigrid_solver(basis, A32, dtype=torch.float32)
    cb, cA = data.bases[0], data.matrices[0]
    t0 = time.perf_counter()
    T = dgtocg.dg_to_cg_transfer(cb)
    t_tr = time.perf_counter() - t0
    t0 = time.perf_counter()
    Tnc = dgtocg.dg_to_cg_transfer_nc(cb)
    t_nc = time.perf_counter() - t0
    if not (Tnc.n_dofs == T.n_vertices == (n + 1) ** 3
            and np.array_equal(Tnc.wdof[:, :, 0], T.vmap)
            and np.all(Tnc.wval[:, :, 0] == 1.0)):
        raise AssertionError("14b: the hanging-node transfer differs from "
                             "the conforming one on a conforming mesh")
    print(f"14b DG->CG p-lattice {n}^3 p={p}: dofs={basis.ndof}, coarse "
          f"DG-P1 dofs={cb.ndof}, CG-P1 vertices={T.n_vertices}, "
          f"auto coarse={data.coarse}; dg_to_cg_transfer_s={t_tr:.3f}, "
          f"dg_to_cg_transfer_nc_s={t_nc:.3f} (vertex x box search)",
          flush=True)
    for coarse in ("gs", "dgcg"):
        t0 = time.perf_counter()
        if coarse == "dgcg":
            mg.dgcg_coarse_solver(cb, cA, dtype=torch.float32)
        else:
            mg.gs_coarse_solver(cb, cA)
        torch.cuda.synchronize()
        t_coarse = time.perf_counter() - t0
        # the 40-sweep GS coarse solve of 32,768 dofs contracts slowly
        # (about 0.94 per cycle): room for it to reach 1e-8
        x, info = api.solve_linear(basis, A, b, tol=1e-8, maxiter=640,
                                   method="onchip", coarse=coarse)
        print(f"14b coarse={coarse}: coarse_setup_s={t_coarse:.3f} "
              f"steps={info['steps']} cycles={info['cycles']} "
              f"solve_s={info['seconds']:.2f} s_per_cycle="
              f"{info['seconds'] / max(info['cycles'], 1):.4f} "
              f"host_verified_rel_residual={info['rel_residual']:.3e}",
              flush=True)
        if not (info["verified"] and info["rel_residual"] <= 1e-8):
            raise AssertionError(f"14b coarse={coarse} not verified "
                                 f"({info['rel_residual']:.3e})")


def cg_space(dev, imp: dict, k: int = 2):
    """Phase 14c: the continuous Q_k space on 13c's imported O-grid: the
    matrix-free apply against the assembled SpMV, plain CG verified by
    the host f64 matrix, the CG-vs-DG nodal agreement, the R9
    refusal."""
    from hpdg_tpu_torch.assemble.cg import (assemble_cg_laplace,
                                            cg_l2_functional,
                                            cg_laplace_operator)
    from hpdg_tpu_torch.basis.cgbasis import cg_basis
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.examples.unstructured_cg import cg_solve
    from hpdg_tpu_torch.transfer import dgtocg

    m = imp["mesh"]
    t0 = time.perf_counter()
    cg = cg_basis(m, k, device=dev)
    t_basis = time.perf_counter() - t0
    t0 = time.perf_counter()
    Acg = assemble_cg_laplace(cg, dirichlet=True)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    op = cg_laplace_operator(cg, dirichlet=True)
    print(f"14c CG-Q{k} on the imported O-grid ({m.n_elements} hexes): "
          f"dofs={cg.n_dofs} per-entity {np.bincount(cg.entity_dim).tolist()}"
          f" boundary={int(cg.boundary.sum())} cg_basis_s={t_basis:.2f} "
          f"assemble_cg_laplace_s={t_asm:.2f} nnz={len(Acg.rows)}",
          flush=True)
    gen_ = torch.Generator(device=dev).manual_seed(1887)
    v = torch.randn(cg.n_dofs, generator=gen_, dtype=torch.float64,
                    device=dev)
    check_rel("14c matrix-free CG apply vs assembled SpMV",
              {k: Acg.matvec(v)}, {k: op(v)}, 1e-12)
    for tag, fn in (("matrix-free", lambda: op(v)),
                    ("assembled SpMV", lambda: Acg.matvec(v))):
        ms = float(np.median(event_times(fn, 20)))
        prof = profile_apply(fn)
        print(f"14c {tag} f64 apply: {ms:.4f} ms (events, median of 20)"
              + ("" if prof is None else
                 f", {prof['launches']:.0f} launches, device "
                 f"{prof['device_ms']:.4f} ms"), flush=True)

    b = cg_l2_functional(cg, lambda x: torch.ones_like(x[..., 0]),
                         dirichlet=True)
    t0 = time.perf_counter()
    x, its, rel = cg_solve(op, b, tol=1e-10, maxiter=6000)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    xh, bh = x.cpu().numpy(), b.cpu().numpy()
    vals = Acg.vals.cpu().numpy()
    Ax = np.bincount(Acg.rows, weights=vals * xh[Acg.cols],
                     minlength=cg.n_dofs)
    hrel = float(np.linalg.norm(bh - Ax) / np.linalg.norm(bh))
    print(f"14c plain CG: iterations={its} solve_s={t_solve:.2f} "
          f"recurrence rel={rel:.3e} host_verified_rel_residual={hrel:.3e}",
          flush=True)
    if not (hrel <= 1e-8 and bool(torch.isfinite(x).all())):
        raise AssertionError(f"14c CG solve not verified ({hrel:.3e})")
    if imp["p"] == k:
        u_cg = cg.gather(x).cpu().numpy()
        u_dg = imp["x"][k].cpu().numpy()
        agree = np.abs(u_cg - u_dg).max() / np.abs(u_dg).max()
        print(f"14c CG vs DG (13c's SIPG solution) nodal agreement: "
              f"max|u_cg - u_dg| / max|u_dg| = {agree:.3e}", flush=True)
        if not agree <= 5e-2:
            raise AssertionError(f"14c: CG and DG disagree ({agree:.3e})")
    b1 = DGBasis(m, np.ones(m.n_elements, dtype=np.int32))
    try:
        dgtocg.dg_to_cg_transfer(b1)
    except ValueError as e:
        print(f"14c R9: dg_to_cg_transfer refuses per-element charts: "
              f"{str(e)[:60]}...; CG-P1 by physical nodes has "
              f"{cg_basis(m, 1, device=dev).n_dofs} dofs", flush=True)
    else:
        raise AssertionError("14c: dg_to_cg_transfer did not refuse")


def presets_and_tools(dev, n: int = 32, p: int = 2, steps: int = 5):
    """Phase 14d: ``models.HeatProblem`` stepped with checkpoints, a VTU
    of the last state, point evaluation card against host, step times by
    ``utils.Timer``."""
    import shutil
    import tempfile
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api, gridfunction
    from hpdg_tpu_torch.blocks.plot import write_vtu
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.mesh import structured
    from hpdg_tpu_torch.models import HeatProblem
    from hpdg_tpu_torch.utils import Timer
    from hpdg_tpu_torch.utils.checkpoint import SolverCheckpointManager

    torch.cuda.reset_peak_memory_stats(dev)
    m = structured((n,) * 3)
    basis = DGBasis(m, np.full(m.n_elements, p, dtype=np.int32))
    timer = Timer()
    # the DG->CG coarse solve: the preset's default leaves the 262,144
    # dofs of the p=1 level to a 40-sweep GS coarse solve (0.99 per
    # cycle), and h-levels of Galerkin SIPG matrices down to 8^3 still
    # contract by 0.97 (400 cycles reached 1.3e-5)
    prob = HeatProblem(basis, dt=0.01, mg_kwargs=dict(coarse="dgcg"),
                       device=dev)
    t_setup = timer.elapsed(prob.S.values)
    u = api.interpolate(basis, lambda x: torch.exp(-30 * (
        (x[..., 0] - 0.5) ** 2 + (x[..., 1] - 0.5) ** 2
        + (x[..., 2] - 0.5) ** 2)), device=dev)
    S_h, M_h = _to_host(prob.S.values), _to_host(prob.M.values)
    print(f"14d HeatProblem {n}^3 p={p}: dofs={basis.ndof} dt=0.01 "
          f"coarse=dgcg (CG-P1: {(n + 1) ** 3} vertices) setup_s="
          f"{t_setup:.2f} (assembly of A, M, S and the hierarchy)",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="hpdg_smoke_")
    try:
        mgr = SolverCheckpointManager(os.path.join(tmp, "ckpt"),
                                      max_to_keep=3)
        e0 = float(bv.dot(u, bm.matvec(prob.M, u)))
        for k in range(steps):
            u_old = _to_host(u)
            timer.reset()
            # the correction tolerance relative to the state's energy
            # norm: the state decays, an absolute 1e-10 would not
            unorm = float(torch.sqrt(bv.dot(u, bm.matvec(prob.S, u))))
            u, info = graph_route(f"14d step {k} loop_solve",
                                  lambda: prob.advance(  # noqa: B023
                                      u, tol=1e-12 * unorm, maxiter=400))
            t_step = timer.elapsed(u)
            rhs = host_matvec(prob.M.pattern, M_h, u_old)
            rel = _host_rel(prob.S.pattern, S_h, _to_host(u), rhs)
            e = float(bv.dot(u, bm.matvec(prob.M, u)))
            timer.reset()
            mgr.save(k, u)
            t_save = timer.elapsed()
            print(f"14d step {k}: cycles={info['iterations']} "
                  f"step_s={t_step:.3f} host_verified_rel_residual="
                  f"{rel:.3e} ||u||_M^2={e:.8e} checkpoint_s={t_save:.3f}",
                  flush=True)
            if not (rel <= 1e-8 and e <= e0 + 1e-12):
                raise AssertionError(f"14d step {k}: residual {rel:.3e} "
                                     f"or energy {e:.3e} > {e0:.3e}")
            e0 = e
        # the step's loop_solve on a prefix of 3 V-cycles by both routes
        loop_routes("14d loop_solve", lambda m: (lambda x, i: (
            x, i["iterations"]))(*prob.advance(u, tol=0.0, maxiter=m)),
            (1, 3), 1e-9)
        got = mgr.restore(device=dev)
        if mgr.steps() != list(range(steps - 3, steps)) or not all(
                torch.equal(got[q], u[q]) for q in u):
            raise AssertionError(f"14d: checkpoints {mgr.steps()} or the "
                                 "restore is not bitwise")
        path = os.path.join(tmp, "heat.vtu")
        timer.reset()
        write_vtu(path, basis, u)
        print(f"14d checkpoints kept {mgr.steps()}, restore bitwise; "
              f"write_vtu: {os.path.getsize(path) / 1e6:.1f} MB in "
              f"{timer.elapsed():.2f} s", flush=True)
    finally:
        shutil.rmtree(tmp)
    pts = np.random.default_rng(1887).random((1000, 3))
    timer.reset()
    on_card = gridfunction.evaluate(basis, u, pts, gradient=True)
    t_card = timer.elapsed()
    on_host = gridfunction.evaluate(basis, {q: v.cpu() for q, v in u.items()},
                                    pts, gradient=True)
    err = max(np.abs(a - c).max() / np.abs(c).max()
              for a, c in zip(on_card, on_host))
    print(f"14d gridfunction.evaluate at 1000 points (values, gradients): "
          f"card vs host rel {err:.3e}, {t_card:.3f} s; peak_mem_GB="
          f"{_peak_gb(dev):.2f}", flush=True)
    if not err <= 1e-12:
        raise AssertionError(f"14d: evaluate card vs host {err:.3e}")


# ---------------------------------------------------------------------------
# phase 15: the sharded hp layer through a shard group of 8 shards
# ---------------------------------------------------------------------------

def _deepest_h(cells, grid) -> int:
    """The most 2x h-coarsenings ``build_hp_sharded_hmg`` accepts."""
    h, c = 0, tuple(cells)
    while True:
        nxt = tuple(x // 2 for x in c)
        if any(x % 2 for x in c) or any(nxt[a] % grid[a]
                                        for a in range(len(grid))):
            return h
        h, c = h + 1, nxt


def _median(v) -> float:
    return float(np.median(np.asarray(v)))


def sharded_poisson(dev, cells=(32, 32, 32), degs=(2, 3, 4), tag="15a"):
    """Phase 15a and 15d: the parallel Poisson example at size, by slabs
    and by a (2, 2, 2) grid of one process's 8 shards; returns the slab
    hierarchy's fine level, its right-hand side and the probe vector."""
    from hpdg_tpu_torch import mesh as hmesh
    from hpdg_tpu_torch.assemble import l2_functional
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockvector as bv
    from hpdg_tpu_torch.matrixfree.sumfact import (mass_operator,
                                                   sipg_operator)
    from hpdg_tpu_torch.parallel import hp
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.parallel.heat import hp_heat_apply
    f64, f32 = torch.float64, torch.float32
    kw = dict(penalty=PENALTY, dirichlet=True, penalty_scaling=SCALING)
    degrees = np.random.default_rng(1887).choice(list(degs),
                                                 size=int(np.prod(cells)))
    t0 = time.perf_counter()
    basis = DGBasis(hmesh.structured(cells), degrees)
    ser64 = sipg_operator(basis, dtype=f64, device=dev, **kw)
    ser32 = sipg_operator(basis, dtype=f32, device=dev, **kw)
    print(f"{tag} problem: cells {cells}, degrees {sorted(set(degs))} "
          f"(seed 1887), {basis.ndof} dofs; serial operators built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(7)
    xg = {p: torch.as_tensor(rng.standard_normal(
        (basis.bucket_size(p), (p + 1) ** 3)), device=dev)
        for p in basis.bucket_degrees}
    xg32 = {p: v.float() for p, v in xg.items()}
    b = l2_functional(basis, lambda x: torch.ones_like(x[..., 0]),
                      device=dev)
    nb = float(bv.norm(b))
    y64 = ser64(xg)
    group = ShardGroup(8, dev)
    keep = None
    for label, grid in (("slabs", None), ("blocks", (2, 2, 2))):
        h_levels = _deepest_h(cells, grid or (8,))
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        pmg = hp.build_hp_sharded_hmg(cells, degrees, h_levels=h_levels,
                                      group=group, device_grid=grid,
                                      dtype=f64, **kw)
        torch.cuda.synchronize(dev)
        t_hier = time.perf_counter() - t
        host = [lv.build_seconds for lv in pmg.levels]
        print(f"{tag} {label}: device grid {pmg.levels[-1].device_grid}, "
              f"{len(pmg.levels)} levels ({h_levels} h-levels); hierarchy "
              f"built in {t_hier:.2f} s, host build per level (coarsest "
              f"first) " + ", ".join(
                  f"{lv.cells}/p{sorted(set(lv.degree_set))}: {s:.2f} s"
                  for lv, s in zip(pmg.levels, host))
              + f"; rest (transfers, rho estimates) "
              f"{t_hier - sum(host):.2f} s",
              flush=True)
        fine = pmg.levels[-1]
        xs = fine.scatter_global(xg, basis)
        check_rel(f"{tag} {label} sharded apply f64 vs serial sipg_operator",
                  y64, fine.gather_global(fine.apply(xs), basis), 1e-11)
        fine32 = fine.astype(f32)
        xs32 = {p: v.float() for p, v in xs.items()}
        check_rel(f"{tag} {label} sharded apply f32 vs serial f64", y64,
                  fine32.gather_global(fine32.apply(xs32), basis), 1e-5)
        ms = {k: _median(event_times(fn, 10)) for k, fn in (
            ("sharded f64", lambda: fine.apply(xs)),
            ("serial f64", lambda: ser64(xg)),
            ("sharded f32", lambda: fine32.apply(xs32)),
            ("serial f32", lambda: ser32(xg32)))}
        print(f"{tag} {label} apply ms (CUDA events, median of 10): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)
        halo = fine.halo
        print(f"{tag} {label} halo per apply: {halo['elements']} elements, "
              f"{halo['dofs']} dofs ({halo['padded_rows']} padded rows) in "
              f"{halo['exchanges']} exchanges", flush=True)
        print_profile(f"{tag} {label} sharded f64",
                      profile_apply(lambda: fine.apply(xs)))
        print_profile(f"{tag} {label} serial f64",
                      profile_apply(lambda: ser64(xg)))
        bs = fine.scatter_global(b, basis)
        iters, verified, t_solve = 24, None, 0.0
        while True:
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            x, rel = graph_route(f"{tag} {label} hp_pmg_pcg_solve",
                                 lambda: hp.hp_pmg_pcg_solve(  # noqa: B023
                                     pmg, bs, iters=iters))
            rel = float(rel)
            t_solve = time.perf_counter() - t
            r = bv.sub(b, ser64(fine.gather_global(x, basis)))
            verified = float(bv.norm(r)) / nb
            print(f"{tag} {label} hp_pmg_pcg_solve: {iters} iterations in "
                  f"{t_solve:.2f} s ({1e3 * t_solve / iters:.1f} ms/it); "
                  f"recursive rel {rel:.3e}, verified by the serial f64 "
                  f"apply {verified:.3e}", flush=True)
            if verified <= 1e-8 or iters >= 200:
                break
            need = iters * np.log(1e-9) / np.log(max(verified, 1e-300))
            iters = int(min(200, max(2 * iters, np.ceil(need))))
        if not verified <= 1e-8:
            raise AssertionError(f"{tag} {label}: verified {verified:.3e}")
        if label == "slabs":  # the blocks run the same driver
            loop_routes(f"{tag} {label} hp_pmg_pcg_solve", lambda m: (
                hp.hp_pmg_pcg_solve(pmg, bs, iters=m)[0], m),  # noqa: B023
                (1, 2), 1e-9)
        print(f"{tag} {label}: peak_mem_GB={_peak_gb(dev):.2f}", flush=True)
        if label == "slabs":
            keep = dict(fine=fine, xs=xs, bs=bs, degrees=degrees, cells=cells)
        del pmg, fine32, xs32
    # 15d: the implicit-Euler operator on the slab lattice
    dt = 0.01
    fine, xs = keep["fine"], keep["xs"]
    heat = hp_heat_apply(fine, dt, dtype=f64)
    mass = mass_operator(basis, dtype=f64, device=dev)(xg)
    want = {p: mass[p] + dt * y64[p] for p in y64}
    check_rel("15d hp_heat_apply vs serial mass + dt A (f64)", want,
              fine.gather_global(heat(xs), basis), 1e-11)
    print(f"15d heat apply ms (CUDA events, median of 10): "
          f"{_median(event_times(lambda: heat(xs), 10)):.3f}", flush=True)
    return keep


def sharded_tnnmg(dev, n2: int = 128, p: int = 3, serial_its: int = 560,
                  sharded_its: int = 120):
    """Phase 15b: the reference's sharded-TNNMG check at config 5's size
    (f32, f = 1, upper obstacle 0.01, penalty 2, "normal"), with the
    dryrun's bounds: truncated > 0, iterates within 1e-3 of max, and
    energies within 1e-6 (1 + |e|), an absolute bound of about 1e-6 at
    |e| = 6.6e-3.  Both solvers run to its tolerance (1e-6 on the
    correction), not to its 40 iterations: at this size the serial
    TNNMG is still far from the solution after 40 (energy -2.43e-3
    against -6.58e-3; the reference's serial solver gives the same
    energy there, ``tests/tnnmg_serial_at_size.py``), the sharded one
    takes about 60.  The serial one never meets the tolerance in f32: its
    correction reaches its floor, about 1.5e-6, by iteration 540, hence
    ``serial_its``."""
    from hpdg_tpu_torch import mesh as hmesh
    from hpdg_tpu_torch.assemble import assemble_laplace, l2_functional
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.parallel.hp import build_hp_sharded_pmg
    from hpdg_tpu_torch.parallel.obstacle import solve_tnnmg_sharded
    from hpdg_tpu_torch.solvers.tnnmg import solve_tnnmg
    f32 = torch.float32
    cells = (n2, n2)
    degrees = np.full(n2 * n2, p)
    basis = DGBasis(hmesh.structured(cells), degrees)
    A32 = assemble_laplace(basis, penalty=PENALTY, dirichlet=True,
                           dtype=f32, penalty_scaling=SCALING, device=dev)
    b = l2_functional(basis, lambda x: torch.ones_like(x[..., 0]),
                      dtype=f32, device=dev)
    lo = {q: torch.full_like(v, -torch.inf) for q, v in b.items()}
    up = {q: torch.full_like(v, 0.01) for q, v in b.items()}
    t = time.perf_counter()
    x_ser, info_s = solve_tnnmg(A32, b, basis, lo, up, tol=1e-6,
                                maxiter=serial_its, fused=True)
    torch.cuda.synchronize(dev)
    t_ser = time.perf_counter() - t
    t = time.perf_counter()
    pmg = build_hp_sharded_pmg(cells, degrees, group=ShardGroup(8, dev),
                               penalty=PENALTY, dirichlet=True, dtype=f32,
                               coarse_cg_iters=3, penalty_scaling=SCALING)
    t_build = time.perf_counter() - t
    fine = pmg.levels[-1]
    bs, los, ups = (fine.scatter_global(v, basis) for v in (b, lo, up))
    t = time.perf_counter()
    x_sh, info_p = graph_route("15b solve_tnnmg_sharded",
                               lambda: solve_tnnmg_sharded(
                                   pmg, bs, los, ups, tol=1e-6,
                                   maxiter=sharded_its))
    t_sh = time.perf_counter() - t
    # a prefix of 3 iterations by both routes: f32 with colliding
    # index_add_ atomics, held to the dryrun's iterate bound
    loop_routes("15b solve_tnnmg_sharded", lambda m: (lambda x, h: (
        x, h["iterations"]))(*solve_tnnmg_sharded(
            pmg, bs, los, ups, tol=0.0, maxiter=m)), (1, 3), 1e-3)
    xg = fine.gather_global(x_sh, basis)
    scale = max(float(v.abs().max()) for v in x_ser.values())
    err = max(float((x_ser[q] - xg[q]).abs().max()) for q in x_ser)
    e_ser, e_sh = info_s["energy"][-1], info_p["energy"][-1]
    print(f"15b sharded TNNMG at {n2}^2 p={p} ({basis.ndof} dofs, f32): "
          f"serial {info_s['iterations']} its in {t_ser:.2f} s, sharded "
          f"{info_p['iterations']} its in {t_sh:.2f} s (build "
          f"{t_build:.2f} s); energy serial {e_ser:.9e} sharded "
          f"{e_sh:.9e} (difference {abs(e_ser - e_sh):.3e}, bound "
          f"{1e-6 * (1.0 + abs(e_ser)):.3e} absolute); iterate err "
          f"{err:.3e} of max {scale:.3e} (bound {1e-3 * scale:.3e}); "
          f"truncated max {max(info_p['truncated'])}", flush=True)
    for name, info in (("serial", info_s), ("sharded", info_p)):
        print(f"15b {name} correction every 10 its: "
              f"{[f'{v:.2e}' for v in info['correction'][::10]]}, last "
              f"{info['correction'][-1]:.2e}", flush=True)
    if not (max(info_p["truncated"]) > 0 and err <= 1e-3 * scale
            and abs(e_ser - e_sh) <= 1e-6 * (1.0 + abs(e_ser))):
        raise AssertionError("15b: sharded TNNMG outside the dryrun's bounds")


def sharded_adaptive(dev, n: int = 128, cycles: int = 3, cg_iters: int = 30):
    """Phase 15c: ``sharded_adaptive_solve(solver="mg-pcg")`` from n x n
    p=2, checked on the final mesh against a serial PCG on the card."""
    from hpdg_tpu_torch import mesh as hmesh
    from hpdg_tpu_torch.assemble import assemble_laplace, l2_functional
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.matrixfree.norms import jump_indicator
    from hpdg_tpu_torch.parallel.adaptive import sharded_adaptive_solve
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.solvers.cg import pcg
    from hpdg_tpu_torch.solvers.smoothers import block_jacobi_preconditioner
    f64 = torch.float64
    m0 = hmesh.structured((n, n))
    one = lambda x: torch.ones_like(x[..., 0])  # noqa: E731
    meshes = []
    for part in ("planes", "inherit"):
        t = time.perf_counter()
        mesh, deg, x, info = graph_route(
            f"15c mg-pcg partition={part}", lambda: sharded_adaptive_solve(
                m0, np.full(n * n, 2), one, group=ShardGroup(8, dev),
                cycles=cycles, frac=0.3, penalty=PENALTY,
                penalty_scaling=SCALING, cg_iters=cg_iters, dtype=f64,
                solver="mg-pcg", partition=part),  # noqa: B023
            per_iteration=False)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t
        reuse = info["plan_reuse"] or "none recorded (mg-pcg replans)"
        print(f"15c mg-pcg partition={part}: {secs:.2f} s for {cycles} "
              f"cycles; elements {info['n_elements']}, balance "
              f"{[round(v, 4) for v in info['balance']]}, plan reuse "
              f"{reuse}, eta {[f'{v:.6e}' for v in info['eta']]}, residual "
              f"{[f'{v:.3e}' for v in info['residual']]}", flush=True)
        meshes.append((mesh, deg, x, info))
    (mesh, deg, x, info), (mesh2, deg2, _, _) = meshes
    if not (np.array_equal(mesh.lower, mesh2.lower)
            and np.array_equal(deg, deg2)):
        raise AssertionError("15c: mg-pcg meshes depend on the partition")
    gba = DGBasis(mesh, deg)
    Aa = assemble_laplace(gba, penalty=PENALTY, dirichlet=True,
                          penalty_scaling=SCALING, dtype=f64, device=dev)
    ba = l2_functional(gba, one, dtype=f64, device=dev)
    t = time.perf_counter()
    x_ref, pinfo = graph_route("15c serial pcg", lambda: pcg(
        lambda v: bm.matvec(Aa, v), ba,
        precond=block_jacobi_preconditioner(Aa), tol=1e-10, maxiter=20000))
    t_ref = time.perf_counter() - t
    scale = max(float(v.abs().max()) for v in x_ref.values())
    err = max(float((x_ref[q] - x[q]).abs().max()) for q in x_ref)
    eta_ref = float(torch.sqrt(jump_indicator(
        gba, penalty=PENALTY, penalty_scaling=SCALING, dtype=f64,
        device=dev)(x_ref).sum()))
    print(f"15c final mesh {mesh.n_elements} elements ({gba.ndof} dofs): "
          f"serial block-Jacobi PCG {pinfo['iterations']} its in "
          f"{t_ref:.2f} s; x err {err:.3e} of max {scale:.3e}; residual "
          f"{info['residual'][-1]:.3e}; eta {info['eta'][-1]:.9e} vs serial "
          f"{eta_ref:.9e}", flush=True)
    if not (err <= 1e-3 * scale and info["residual"][-1] <= 1e-5
            and abs(eta_ref - info["eta"][-1]) <= 1e-3 * eta_ref):
        raise AssertionError("15c: sharded adaptive outside the bounds")


def rank_route(dev, keep: dict):
    """Phase 15e: the same 8 slabs through a ``torch.distributed`` group
    of world size 1 (NCCL on the card) against the one-process group."""
    import tempfile
    import torch.distributed as dist
    from hpdg_tpu_torch.parallel import hp
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    backend = "nccl" if dev.type == "cuda" else "gloo"
    fine, xs, bs = keep["fine"], keep["xs"], keep["bs"]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            g = ShardGroup.from_process_group(8, device=dev)
            prob = hp.build_hp_sharded(keep["cells"], keep["degrees"],
                                       group=g, penalty=PENALTY,
                                       dirichlet=True,
                                       penalty_scaling=SCALING,
                                       dtype=torch.float64)
            rels = []
            for what, a, b in (
                    ("apply", fine.apply(xs), prob.apply(xs)),
                    ("10 PCG iterations",
                     graph_route("15e one process hp_pcg_solve",
                                 lambda: hp.hp_pcg_solve(fine, bs, 10))[0],
                     graph_route(f"15e {backend} hp_pcg_solve",
                                 lambda: hp.hp_pcg_solve(prob, bs, 10))[0])):
                scale = max(float(v.abs().max()) for v in a.values())
                rel = max(float((a[p] - b[p]).abs().max())
                          for p in a) / scale
                rels.append(rel)
                print(f"15e {backend} world 1 vs one process, {what}: rel "
                      f"{rel:.3e} (bound 1e-13)", flush=True)
            loop_routes(f"15e {backend} hp_pcg_solve", lambda m: (
                hp.hp_pcg_solve(prob, bs, m)[0], m), (2, 6), 1e-9)
            ms = _median(event_times(lambda: prob.apply(xs), 10))
            print(f"15e {backend} sharded apply ms (CUDA events, median "
                  f"of 10): {ms:.3f}; host build {prob.build_seconds:.2f} s;"
                  f" torch.cuda.device_count() = {torch.cuda.device_count()}",
                  flush=True)
        finally:
            dist.destroy_process_group()
    if not max(rels) <= 1e-13:
        raise AssertionError(f"15e: rank route differs, rel {max(rels):.3e}")


# ---------------------------------------------------------------------------
# phase 16: the sharded elasticity through a shard group of 8 shards
# ---------------------------------------------------------------------------

def _on_card(tag: str, dev, *tensors):
    """Raises if a shard tensor is off the card (no silent host route)."""
    for t in tensors:
        if t.device != dev:
            raise AssertionError(f"{tag}: a shard tensor lives on "
                                 f"{t.device}, not {dev}")


def _elasticity_force(x):
    return torch.stack(
        [3 * np.pi ** 2 * torch.sin(np.pi * x[..., 0])
         * torch.sin(np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]),
         torch.zeros_like(x[..., 0]), torch.zeros_like(x[..., 0])], dim=-1)


def _pmg_pcg_verified(tag, pmg, b, serial, dev, iters: int, cap: int = 200,
                      counts=(1, 2), profile: bool = False):
    """``elasticity_pmg_pcg_solve`` from ``iters`` iterations up to
    ``cap``, verified by the serial f64 apply (<= 1e-8, hard), through
    its graph route; then a prefix by both routes (``loop_routes`` at
    ``counts``, under the profiler where ``profile``)."""
    from hpdg_tpu_torch.parallel.elasticity import elasticity_pmg_pcg_solve
    p = pmg.levels[-1].p
    nb = float(b.norm())
    while True:
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        x, rel = graph_route(f"{tag} elasticity_pmg_pcg_solve",
                             lambda: elasticity_pmg_pcg_solve(  # noqa: B023
                                 pmg, b, iters=iters))
        rel = float(rel)
        t_solve = time.perf_counter() - t
        _on_card(tag, dev, x)
        verified = float((b - serial({p: x})[p]).norm()) / nb
        print(f"{tag} elasticity_pmg_pcg_solve: {iters} iterations (cap "
              f"{cap}) in {t_solve:.2f} s ({1e3 * t_solve / iters:.1f} "
              f"ms/it); recursive rel {rel:.3e}, verified by the serial "
              f"f64 apply {verified:.3e}", flush=True)
        if verified <= 1e-8 or iters >= cap:
            break
        need = iters * np.log(1e-9) / np.log(max(verified, 1e-300))
        iters = int(min(cap, max(2 * iters, np.ceil(need))))
    if not (verified <= 1e-8 and bool(torch.isfinite(x).all())):
        raise AssertionError(f"{tag}: verified {verified:.3e}")
    loop_routes(f"{tag} elasticity_pmg_pcg_solve", lambda m: (
        elasticity_pmg_pcg_solve(pmg, b, iters=m)[0], m), counts, 1e-9,
        profile=profile)
    return x, iters


def sharded_elasticity(dev, cells=(24, 24, 24), p: int = 2,
                       box: dict | None = None, iters: int = 26,
                       pmg_shards: int = 4):
    """Phase 16a: config 4 (24^3 p=2, mu 1, lam 1, penalty 4, Dirichlet)
    through ``parallel.elasticity`` on 8 slabs: the sharded apply against
    the serial ``elasticity_operator`` under both boundary kinds, its
    times and launches beside phase 8's serial apply and SpMV (``box``),
    and the pmg-PCG with patch smoothing and one h-level verified by the
    serial f64 apply.  The pmg runs on ``pmg_shards`` slabs: an h-level
    halves every slab, which 8 slabs of 3 layers cannot do, 4 of 6 can.
    Its coarse PCG takes 20 iterations, not the reference's 60: with
    patch smoothing the coarse solve's accuracy barely moves the
    contraction, and its launches are most of a V-cycle's.  Returns
    what 16d needs."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import l2_functional_vec
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.matrixfree.elasticity import elasticity_operator
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.parallel.elasticity import (
        build_sharded_elasticity, build_sharded_elasticity_pmg)
    f64, f32 = torch.float64, torch.float32
    kw = dict(mu=1.0, lam=1.0, penalty=4.0)
    group = ShardGroup(8, dev)
    n = int(np.prod(cells))
    basis = DGBasis(hm.structured(cells), np.full(n, p))
    bs = 3 * (p + 1) ** 3
    gen = torch.Generator(device=dev).manual_seed(1887)
    x64 = torch.randn((n, bs), generator=gen, dtype=f64, device=dev)
    x32 = x64.float()
    print(f"16a problem: cells {cells} p={p}, {n * bs} dofs in "
          f"{group.ndev} slabs of {cells[0] // group.ndev} layers", flush=True)
    keep = None
    for diri in (True, False):
        serial = elasticity_operator(basis, dirichlet=diri, dtype=f64,
                                     device=dev, **kw)
        y64 = serial({p: x64})[p]
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        prob = build_sharded_elasticity(cells, p, group=group,
                                        dirichlet=diri, dtype=f64, **kw)
        prob32 = build_sharded_elasticity(cells, p, group=group,
                                          dirichlet=diri, dtype=f32, **kw)
        torch.cuda.synchronize(dev)
        t_build = time.perf_counter() - t
        ys = prob.apply(x64)
        _on_card("16a", dev, ys)
        tag = f"16a dirichlet={diri}"
        check_rel(f"{tag} sharded apply f64 vs serial elasticity_operator",
                  {p: y64}, {p: ys}, 1e-11)
        check_rel(f"{tag} sharded apply f32 vs f64", {p: y64},
                  {p: prob32.apply(x32)}, 1e-5)
        ms = {k: _median(event_times(fn, 10)) for k, fn in (
            ("sharded f64", lambda: prob.apply(x64)),
            ("sharded f32", lambda: prob32.apply(x32)),
            ("serial f64", lambda: serial({p: x64})))}
        ph8 = ", ".join(f"{k} {v:.3f}" for k, v in (box or {}).get(
            "apply_ms", {}).items())
        print(f"{tag} build {t_build:.2f} s (f64 and f32); apply ms (CUDA "
              f"events, median of 10): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + (f" | phase 8 (refined-order mesh): {ph8}" if ph8 else "")
              + f"; peak_mem_GB={_peak_gb(dev):.2f}", flush=True)
        print_profile(f"{tag} sharded f64",
                      profile_apply(lambda: prob.apply(x64)))
        if diri:
            keep = dict(prob=prob, x=x64, serial=serial, cells=cells, p=p)
        del prob32
    # the pmg-PCG of config 4 (f64, vertex-patch smoothing, one h-level)
    if cells[0] % (2 * pmg_shards):
        raise ValueError(f"16a: {pmg_shards} slabs of {cells} cannot halve")
    b = l2_functional_vec(basis, _elasticity_force, device=dev)[p]
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    pmg = build_sharded_elasticity_pmg(cells, p,
                                       group=ShardGroup(pmg_shards, dev),
                                       dirichlet=True, dtype=f64,
                                       smoother="patch", h_levels=1,
                                       coarse_cg_iters=20, **kw)
    torch.cuda.synchronize(dev)
    t_build = time.perf_counter() - t
    if len(pmg.levels) != 3 or pmg.levels[0].cells[0] * 2 != cells[0]:
        raise AssertionError("16a: the pmg has no h-level")
    levels = ", ".join(f"{lv.cells}/p{lv.p}" for lv in pmg.levels)
    print(f"16a pmg on {pmg_shards} slabs: levels [{levels}] (coarsest "
          f"first), patch smoothing on every level, rho estimates "
          f"{[round(v, 6) for v in pmg.lmaxs]}, built in {t_build:.2f} s, "
          f"peak_mem_GB={_peak_gb(dev):.2f}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    _pmg_pcg_verified("16a", pmg, b, keep["serial"], dev, iters)
    print(f"16a solve peak_mem_GB={_peak_gb(dev):.2f}", flush=True)
    keep["b"] = b
    return keep


def _lattice_order(mesh, cells) -> np.ndarray:
    """Element ids of ``mesh`` (parametric boxes tiling the unit cube on
    the ``cells`` lattice) in C-lattice order."""
    h = 1.0 / np.asarray(cells, np.float64)
    ic = np.rint(mesh.lower / h).astype(np.int64)
    return np.argsort(np.ravel_multi_index(ic.T, cells), kind="stable")


def sharded_elasticity_curved(dev, n_el: int = 24, p: int = 2,
                              iters: int = 70, pmg_kw: dict | None = None):
    """Phase 16b: 13b's quarter hollow cylinder (``isoparametric`` on
    (n_el/4)^3, refined twice; its corners put in C-lattice order)
    through ``gmesh=``: the apply against the serial curved operator
    under both penalty scalings, then the pmg-PCG with Chebyshev
    smoothing ("measure") verified by the serial f64 apply.  ``pmg_kw``:
    the coarse PCG's iterations and the Chebyshev degree (default 20
    and 6, not the reference's 60 and 3: Chebyshev smoothing limits the
    contraction here, so stronger smoothing and a cheaper coarse solve
    reach 1e-8 sooner; PERF.md has both on the card)."""
    pmg_kw = pmg_kw or dict(coarse_cg_iters=20, pre_steps=6, post_steps=6)
    from dataclasses import replace
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import l2_functional_vec
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.examples.meshes import cylinder_quarter
    from hpdg_tpu_torch.matrixfree.elasticity import elasticity_operator
    from hpdg_tpu_torch.mesh import geometry as geo
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.parallel.elasticity import (
        build_sharded_elasticity, build_sharded_elasticity_pmg)
    f64 = torch.float64
    kw = dict(mu=1.0, lam=1.0, penalty=4.0, dirichlet=True)
    cells = (n_el,) * 3
    t = time.perf_counter()
    mf = geo.isoparametric(hm.structured((n_el // 4,) * 3), cylinder_quarter)
    for _ in range(2):
        mf = hm.refine(mf)
    gm = replace(hm.structured(cells),
                 corners=mf.corners[_lattice_order(mf, cells)])
    basis = DGBasis(gm, np.full(gm.n_elements, p))
    t_mesh = time.perf_counter() - t
    group = ShardGroup(8, dev)
    n, bs = gm.n_elements, 3 * (p + 1) ** 3
    gen = torch.Generator(device=dev).manual_seed(1887)
    x64 = torch.randn((n, bs), generator=gen, dtype=f64, device=dev)
    print(f"16b problem: 13b's quarter cylinder in C-lattice order, cells "
          f"{cells} p={p}, {n * bs} dofs, volume "
          f"{gm.volumes.sum():.6f} (3 pi/4 = {3 * np.pi / 4:.6f}); host "
          f"mesh {t_mesh:.2f} s", flush=True)
    # the pmg under "measure": its block-Jacobi blocks take that scaling
    # whatever the operator's, as the reference's do, and under "normal"
    # in 3D the Chebyshev window then misses the spectrum (ROADMAP R11).
    # Its fine level is the sharded operator checked below.
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    pmg = build_sharded_elasticity_pmg(cells, p, group=group, gmesh=gm,
                                       dtype=f64, smoother="cheb",
                                       h_levels=0, **pmg_kw, **kw)
    torch.cuda.synchronize(dev)
    print(f"16b pmg: levels "
          f"[{', '.join(f'{lv.cells}/p{lv.p}' for lv in pmg.levels)}], "
          f"{pmg_kw}, rho estimates {[round(v, 6) for v in pmg.lmaxs]}, "
          f"built in {time.perf_counter() - t:.2f} s, "
          f"peak_mem_GB={_peak_gb(dev):.2f}", flush=True)
    serial = None
    for scaling in ("normal", "measure"):
        serial = elasticity_operator(basis, dtype=f64, device=dev,
                                     penalty_scaling=scaling, **kw)
        t = time.perf_counter()
        prob = pmg.levels[-1] if scaling == "measure" else \
            build_sharded_elasticity(cells, p, group=group, gmesh=gm,
                                     dtype=f64, penalty_scaling=scaling,
                                     **kw)
        torch.cuda.synchronize(dev)
        t_build = time.perf_counter() - t
        ys = prob.apply(x64)
        _on_card("16b", dev, ys)
        tag = f"16b {scaling}"
        check_rel(f"{tag} sharded curved apply f64 vs serial curved "
                  "operator", serial({p: x64}), {p: ys}, 1e-11)
        ms = {k: _median(event_times(fn, 10)) for k, fn in (
            ("sharded f64", lambda: prob.apply(x64)),
            ("serial f64", lambda: serial({p: x64})))}
        print(f"{tag} build {t_build:.2f} s (host geometry tables of 8 "
              f"shards; the pmg's fine level under measure); apply ms "
              f"(CUDA events, median of 10): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)
        if scaling == "measure":
            print_profile(f"{tag} sharded f64",
                          profile_apply(lambda: prob.apply(x64)))
        del prob
    b = l2_functional_vec(basis, _elasticity_force, device=dev)[p]
    _pmg_pcg_verified("16b", pmg, b, serial, dev, iters, profile=True)


def sharded_elasticity_example(dev):
    """Phase 16c: the ``--sharded`` branch of the elasticity example at
    the reference's own size, on the card."""
    from hpdg_tpu_torch.examples import elasticity as example
    t = time.perf_counter()
    out = example.main(["--sharded", "1", "--device", dev.type])
    sh = out["sharded"]
    print(f"16c examples.elasticity --sharded 1: {time.perf_counter() - t:.2f}"
          f" s; {sh['ndev']} shards, {sh['ndof']} dofs, rel residual "
          f"{sh['rel']:.3e}", flush=True)
    if not (sh["ndev"] == 8 and np.isfinite(sh["rel"]) and sh["rel"] < 1e-3):
        raise AssertionError(f"16c: {sh}")


def elasticity_rank_route(dev, keep: dict):
    """Phase 16d: 16a's slabs through a ``torch.distributed`` group of
    world size 1 (NCCL on the card) against the one-process group: the
    apply and 10 block-Jacobi PCG iterations."""
    import tempfile
    import torch.distributed as dist
    from hpdg_tpu_torch.parallel.comm import ShardGroup
    from hpdg_tpu_torch.parallel.elasticity import (build_sharded_elasticity,
                                                    elasticity_pcg_solve)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = dict(mu=1.0, lam=1.0, penalty=4.0, dirichlet=True)
    one, x, b = keep["prob"], keep["x"], keep["b"]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            g = ShardGroup.from_process_group(8, device=dev)
            prob = build_sharded_elasticity(keep["cells"], keep["p"],
                                            group=g, dtype=torch.float64,
                                            **kw)
            rels = []
            for what, a, c in (
                    ("apply", one.apply(x), prob.apply(x)),
                    ("10 PCG iterations",
                     graph_route("16d one process elasticity_pcg_solve",
                                 lambda: elasticity_pcg_solve(
                                     one, b, iters=10, **kw))[0],
                     graph_route(f"16d {backend} elasticity_pcg_solve",
                                 lambda: elasticity_pcg_solve(
                                     prob, b, iters=10, **kw))[0])):
                rel = float((a - c).abs().max()) / float(a.abs().max())
                rels.append(rel)
                print(f"16d {backend} world 1 vs one process, {what}: rel "
                      f"{rel:.3e} (bound 1e-13)", flush=True)
            loop_routes(f"16d {backend} elasticity_pcg_solve", lambda m: (
                elasticity_pcg_solve(prob, b, iters=m, **kw)[0], m), (2, 6),
                1e-9)
            ms = _median(event_times(lambda: prob.apply(x), 10))
            print(f"16d {backend} sharded elasticity apply ms (CUDA "
                  f"events, median of 10): {ms:.3f}", flush=True)
        finally:
            dist.destroy_process_group()
    if not max(rels) <= 1e-13:
        raise AssertionError(f"16d: rank route differs, rel {max(rels):.3e}")


# ---------------------------------------------------------------------------
# phase 17: the native host kernels and assemble_laplace(geom_scale=)
# ---------------------------------------------------------------------------

def _canon_faces(m) -> tuple:
    f, b = m.faces, m.bfaces
    return (sorted(zip(f.inside.tolist(), f.outside.tolist(),
                       f.axis.tolist(), f.nc_code.tolist())),
            sorted(zip(b.elem.tolist(), b.axis.tolist(), b.side.tolist())))


def _cells_bit(cells):
    """VTK-ordered hexes -> corner ids in the bit convention (the default
    frame ``from_cell_vertices`` starts from)."""
    from hpdg_tpu_torch.mesh import geometry as geo
    B = geo._bits(3).astype(np.int64)
    vtk_of_bit = [int(np.where((geo._VTK_CORNER_REF == B[c]).all(1))[0][0])
                  for c in range(8)]
    return np.asarray(cells, np.int64)[:, vtk_of_bit]


def native_kernels(dev, n: int = 32, n_adapt: int = 14, n_import: int = 16,
                   nb: int = 16, layers: int = 16, solved: dict | None = None):
    """Phase 17a-d: the native library builds and loads; the native face
    matcher equals the numpy one on the ``n``^3 lattice and phase 6's
    refined mesh; the native frame matcher equals the Python BFS on a
    non-twisted import and returns None on 13c's twisted O-grid;
    ``solved`` (phase 4's 32^3 solution) re-verified by the native host
    apply beside the torch f64 CPU apply."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch import native
    from hpdg_tpu_torch.examples import meshes as gen
    from hpdg_tpu_torch.matrixfree.uniform import uniform_sipg_factorized_host
    from hpdg_tpu_torch.mesh import geometry as geo
    from hpdg_tpu_torch.mesh.adaptive import close_marks, refine_local
    # 17a
    if not native.available():
        raise AssertionError("17a: g++ is not on the PATH: no native "
                             "host kernels")
    t = time.perf_counter()
    native.build()
    print(f"17a native library {native.library_path().name}: built and "
          f"loaded in {time.perf_counter() - t:.2f} s", flush=True)
    # 17b
    m0 = hm.structured((n_adapt,) * 3)
    rng = np.random.default_rng(3)
    adapt = refine_local(m0, close_marks(m0, rng.random(m0.n_elements) < 0.3))
    for label, m in ((f"{n}^3 lattice", hm.structured((n,) * 3)),
                     (f"phase 6's {n_adapt}^3 30% refined", adapt)):
        secs, found = {}, {}
        for route in ("native", "python"):
            t = time.perf_counter()
            mm = hm.from_boxes(m.lower, m.extent, topology=route)
            secs[route] = time.perf_counter() - t
            found[route] = _canon_faces(mm)
        same = found["native"] == found["python"]
        print(f"17b from_boxes on the {label} ({m.n_elements} elements, "
              f"{len(found['python'][0])} faces): native "
              f"{secs['native']:.4f} s, python {secs['python']:.4f} s; "
              f"canonically equal {same}", flush=True)
        if not same:
            raise AssertionError(f"17b: native faces differ on the {label}")
    # 17c
    pts, cells = gen.lattice((n_import,) * 3)
    cells = gen.shuffle_and_rotate(cells, np.random.default_rng(5))
    if native.frame_cells(_cells_bit(cells), 3) is None:
        raise AssertionError("17c: the native frame matcher refused a "
                             "lattice import")
    meshes, secs = {}, {}
    for route, env in (("native", "1"), ("python", "0")):
        old = os.environ.get("HPDG_NATIVE_TOPOLOGY")
        os.environ["HPDG_NATIVE_TOPOLOGY"] = env
        try:
            t = time.perf_counter()
            meshes[route] = geo.from_cell_vertices(pts, cells)
            secs[route] = time.perf_counter() - t
        finally:
            if old is None:
                os.environ.pop("HPDG_NATIVE_TOPOLOGY")
            else:
                os.environ["HPDG_NATIVE_TOPOLOGY"] = old
    a, c = meshes["native"], meshes["python"]
    fs = lambda m: set(zip(m.faces.inside.tolist(),  # noqa: E731
                           m.faces.outside.tolist(), m.faces.axis.tolist()))
    frames = all(
        (getattr(a, k) is None and getattr(c, k) is None)
        or np.array_equal(getattr(a, k), getattr(c, k))
        for k in ("corners", "jac", "shift"))
    same = (fs(a) == fs(c) and frames
            and _canon_faces(a)[1] == _canon_faces(c)[1])
    opts, ocells, _ = gen.ogrid_cylinder(nb, layers)
    scrambled = gen.shuffle_and_rotate(ocells, np.random.default_rng(0))
    t = time.perf_counter()
    twisted = native.frame_cells(_cells_bit(scrambled), 3)
    t_tw = time.perf_counter() - t
    print(f"17c from_cell_vertices of {n_import}^3 shuffled hexes: native "
          f"{secs['native']:.3f} s, python {secs['python']:.3f} s; equal "
          f"frames and faces {same}; 13c's O-grid ({len(scrambled)} hexes): "
          f"native frame matcher returns "
          f"{'None' if twisted is None else 'frames'} in {t_tw:.3f} s",
          flush=True)
    if not same:
        raise AssertionError("17c: native and Python imports differ")
    if twisted is not None:
        raise AssertionError("17c: the twisted O-grid did not defer to "
                             "the Python route")
    # 17d
    if solved is not None:
        basis, p = solved["basis"], solved["p"]
        x, b, A_host = solved["x_host"], solved["b_host"], solved["A_host"]
        t = time.perf_counter()
        nat = uniform_sipg_factorized_host(basis, penalty=PENALTY,
                                           dirichlet=True,
                                           penalty_scaling=SCALING)
        t_setup = time.perf_counter() - t
        xn = x[p].numpy()
        t = time.perf_counter()
        y_nat = nat(xn)
        t_nat = time.perf_counter() - t
        t = time.perf_counter()
        y_t = A_host(x)[p].numpy()
        t_torch = time.perf_counter() - t
        bn = b[p].numpy()
        # the two applies sum in other orders: their difference is f64
        # roundoff of the summands, sum_t |A_t| |x|, which is far above
        # |A x| = |b| here; the bound is relative to that scale
        s_abs = _abs_factorized(basis)({p: x[p].abs()})[p].numpy()
        diff = float(np.abs(y_nat - y_t).max())
        apply_rel = diff / float(s_abs.max())
        of_y = diff / float(np.abs(y_t).max())
        r_nat = float(np.linalg.norm(bn - y_nat) / np.linalg.norm(bn))
        r_t = float(np.linalg.norm(bn - y_t) / np.linalg.norm(bn))
        print(f"17d phase 4's 32^3 p=4 solution ({xn.size} dofs) on the "
              f"host: native apply {t_nat:.3f} s (set-up {t_setup:.3f} s, "
              f"{os.cpu_count()} host cores), torch f64 CPU apply "
              f"{t_torch:.3f} s; verified rel residual native {r_nat:.6e}, "
              f"torch {r_t:.6e}, difference {abs(r_nat - r_t):.3e} (bound "
              f"1e-12); applies differ by {apply_rel:.3e} of "
              f"max(sum_t |A_t| |x|) = {float(s_abs.max()):.3e} (bound "
              f"1e-12), {of_y:.3e} of max|y| = {float(np.abs(y_t).max()):.3e}",
              flush=True)
        if not (abs(r_nat - r_t) <= 1e-12 and r_nat <= 1e-8
                and apply_rel <= 1e-12):
            raise AssertionError(f"17d: native host residual {r_nat:.3e} "
                                 f"against {r_t:.3e}, applies {apply_rel:.3e}")


def _abs_factorized(basis):
    """Phase 4's factorized f64 host apply with every 1D factor replaced
    by its absolute value: on |x| it gives sum_t |A_t| |x| >= |A| |x|,
    the scale of the f64 roundoff of the factorized sums in any order."""
    from unittest import mock
    from hpdg_tpu_torch.matrixfree import uniform
    blocks = uniform.sipg_factor_blocks

    def abs_blocks(*args, **kw):
        cells, nb, Mm, *lines = blocks(*args, **kw)
        return (cells, nb, np.abs(Mm),
                *({ax: np.abs(M) for ax, M in D.items()} for D in lines))

    with mock.patch.object(uniform, "sipg_factor_blocks", abs_blocks):
        return uniform.uniform_sipg_factorized(
            basis, penalty=PENALTY, dirichlet=True, penalty_scaling=SCALING,
            dtype=torch.float64, device="cpu")


def geom_scale_assembly(dev, n: int = 16, p: int = 4):
    """Phase 17e: ``assemble_laplace(geom_scale=s)`` at n^3 p on the card
    for s = 1 and s = 0.5 (a 0-dim tensor on the card), the latter
    against the assembly of the mesh with halved extents."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import assemble_laplace
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    kw = dict(penalty=PENALTY, dirichlet=True, penalty_scaling=SCALING,
              device=dev)
    cells = (n,) * 3
    basis = DGBasis(hm.structured(cells), np.full(n ** 3, p))
    half = DGBasis(hm.structured(cells, upper=(0.5,) * 3), np.full(n ** 3, p))
    out = {}
    for s in (1.0, torch.tensor(0.5, dtype=torch.float64, device=dev)):
        assemble_laplace(basis, geom_scale=s, **kw)  # warm
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        A = assemble_laplace(basis, geom_scale=s, **kw)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t
        out[float(s)] = A
        print(f"17e assemble_laplace(geom_scale={float(s)}) {n}^3 p={p} "
              f"({basis.ndof} dofs): {secs:.3f} s, "
              f"{basis.ndof / secs:.4e} DOF/s", flush=True)
    Ah = assemble_laplace(half, **kw)
    check_rel("17e geom_scale=0.5 vs the mesh of halved extents",
              Ah.values, out[0.5].values, 1e-12)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hpdg_tpu_torch.ops import block_spmv, nvcc, uniform_stencil
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
    if "--window-probe" in sys.argv[1:]:
        window_probe(dev)
        return 0

    # ---- phase 2: build (one nvcc per source, all at once) ----
    t0 = time.perf_counter()
    sources = (uniform_stencil.SOURCE, block_spmv.SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(nvcc.load, sources))
    uniform_stencil.build()
    block_spmv.build()
    print(f"build K1 and K2 in parallel: {time.perf_counter() - t0:.2f} s",
          flush=True)
    for src in sources:
        log = f"{nvcc.library_path(src)}.log"
        print(f"{src.name} -> {nvcc.library_path(src).name}", flush=True)
        if os.path.exists(log):
            print(open(log).read().strip(), flush=True)
    for bs in (125, 27, 8, 64):
        print(f"K1 {uniform_stencil.kernel_layout(bs)[0]} (bs={bs}): "
              f"{uniform_stencil.occupancy(bs)} resident blocks per SM",
              flush=True)

    # ---- phase 3: kernel vs plain twin ----
    timing = check_kernel(dev)
    profile_levels(timing)

    # ---- phase 3b: K2 on blocks wider than 375 (F3) ----
    wide_blocks(dev)

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
    obstacle = obstacle_solve(dev)

    # ---- phase 11b: K2 at config 5's shapes ----
    k2_config5 = k2_levels(obstacle["data"], obstacle["A64"], dev,
                           prefix="config 5 ")
    del obstacle
    torch.cuda.empty_cache()

    # ---- phase 12: the hp-adaptive L-shape (config 3) ----
    adaptive_lshape_loop(dev)

    # ---- phase 13: first-class element geometry ----
    geometry_poisson(dev)
    geometry_elasticity(dev, box=box)
    imported = geometry_import(dev)

    # ---- phase 14: CG spaces, DG->CG coarse path, line smoother ----
    t14 = time.perf_counter()
    line_mg(dev)
    dgcg_path(dev)
    cg_space(dev, imported)
    del imported
    presets_and_tools(dev, steps=4)  # 4 steps, not 5: the run's time
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)

    # ---- phase 15: the sharded hp layer (8 shards, one process) ----
    t15 = time.perf_counter()
    keep = sharded_poisson(dev)
    sharded_tnnmg(dev)
    sharded_adaptive(dev, cycles=2)  # two cycles, not three: run time
    rank_route(dev, keep)
    del keep
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)

    # ---- phase 16: the sharded elasticity (8 shards, one process) ----
    t16 = time.perf_counter()
    keep = sharded_elasticity(dev, box=box)
    elasticity_rank_route(dev, keep)
    del keep
    torch.cuda.empty_cache()
    sharded_elasticity_curved(dev)
    sharded_elasticity_example(dev)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)

    # ---- phase 17: the native host kernels, geom_scale ----
    t17 = time.perf_counter()
    native_kernels(dev, solved=main_run)
    geom_scale_assembly(dev)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s", flush=True)

    if "jax" in sys.modules or "hpdg_tpu" in sys.modules:
        raise AssertionError("the port imported jax or hpdg_tpu")
    t4 = timing[((32, 32, 32), 4)]
    k2p2 = box["k2"][0]  # the p=2 level, f32: the cycle's largest apply
    summary = {"kernels": [{
        "name": "uniform_stencil",
        "route": "cuda",
        "source": "hpdg_tpu_torch/csrc/uniform_stencil.cu",
        "replaces": "hpdg_tpu/ops/pallas_uniform.py:230",
        "launches": main_run["launches"],
        "graph_launches": main_run["graph_launches"],
        "max_abs_err": t4["max_abs_err"],
        "ms": t4["ms"],
        "plain_ms": t4["plain_ms"],
        "bound_ms": t4["bound_ms"],
        "bound_by": t4["bound_by"],
        "library_ms": t4["library_ms"],
    }, {
        "name": "block_spmv",
        "route": "cuda",
        "source": "hpdg_tpu_torch/csrc/block_spmv.cu",
        "replaces": "none (hpdg_tpu/linalg/blockmatrix.py:102 matvec, XLA "
                    "einsum + segment_sum)",
        "launches": box["k2_launches"],
        "graph_launches": box["k2_chain"],
        "max_abs_err": k2p2["max_abs_err"],
        "ms": k2p2["ms"],
        "plain_ms": k2p2["plain_ms"],
        "bound_ms": k2p2["bound_ms"],
        "bound_by": k2p2["bound_by"],
        "library_ms": k2p2["library_ms"],
        # config 5's largest p=1 level (81,408 blocks of 4 x 4, f32)
        "config5_16384e_p1": next(
            {k: r[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "bitwise_emulation")}
            for r in k2_config5 if "16384e/p1" in r["tag"]),
    }]}
    print(smi(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
