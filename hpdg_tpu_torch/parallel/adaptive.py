"""Sharded adaptive refinement loop (solve -> estimate -> mark -> refine
-> repartition -> migrate) over a shard group.

Port of ``hpdg_tpu.parallel.adaptive``:

* the SOLVE runs sharded (``build_hp_sharded_general`` + block-Jacobi
  PCG, or the sharded hp-multigrid with PCG) on the current partition;
* estimation, Dörfler marking and 2:1-closed refinement are host-side
  numpy passes on the gathered solution;
* after each refinement the partition is rebuilt and the solution
  migrates by persist-interpolation into the new layout.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.assemble import l2_functional
from hpdg_tpu_torch.matrixfree.norms import jump_indicator
from hpdg_tpu_torch.estimators.utility import mark_fraction
from hpdg_tpu_torch.mesh.adaptive import refine_local, close_marks
from hpdg_tpu_torch.blocks.persist import (save_state, interpolate_to,
                                           degrees_after_refine)
from hpdg_tpu_torch.parallel.comm import ShardGroup, resolve_group
from hpdg_tpu_torch.parallel.hp import (build_hp_sharded_general,
                                        hp_pcg_solve, build_hp_sharded_pmg,
                                        build_hp_sharded_hmg_general,
                                        balanced_partition, morton_partition,
                                        hp_pmg_pcg_solve, hp_norm)


def sharded_adaptive_solve(mesh0, degrees0, f, group: ShardGroup | None = None,
                           cycles: int = 3, frac: float = 0.3,
                           penalty: float = 2.0,
                           penalty_scaling: str = "normal",
                           cg_iters: int = 300, dtype=torch.float64,
                           hp_mode: bool = False,
                           smooth_cut: float = 0.5, max_p: int = 6,
                           solver: str = "jacobi-pcg",
                           partition: str = "planes",
                           repartition_threshold: float = 1.5):
    """``cycles`` sharded adaptive cycles of -Δu = f with homogeneous
    Dirichlet data.

    ``hp_mode``: marked elements whose Legendre-decay indicator is below
    ``smooth_cut`` raise their degree (up to ``max_p``) instead of
    splitting.  ``solver``: ``"jacobi-pcg"`` or ``"mg-pcg"`` (the sharded
    hp-multigrid over the refinement history).  ``partition``:
    ``"planes"`` (cut-plane slabs), ``"balanced"``, ``"morton"`` or
    ``"inherit"`` (children keep their parent's shard, rebalanced past
    ``repartition_threshold``, with the content-hash plan cache).

    Returns ``(mesh, degrees, x, info)``: ``x`` the final serial bucketed
    solution on the group's device; ``info`` per cycle: element count,
    eta, relative residual, balance, planning seconds and plan reuse."""
    group = resolve_group(group)
    dev_ = group.device
    ndev = group.ndev
    mesh = mesh0
    degrees = np.asarray(degrees0).reshape(-1)
    x_serial = None
    info = {"n_elements": [], "eta": [], "residual": [], "balance": [],
            "plan_seconds": [], "plan_reuse": []}
    plan_cache = {}
    shard_prev = None
    for c in range(cycles):
        gbasis = DGBasis(mesh, degrees)
        if solver == "mg-pcg":
            if mesh.parent_mesh is not None:
                pmg = build_hp_sharded_hmg_general(
                    mesh, degrees, group=group, penalty=penalty,
                    dirichlet=True, penalty_scaling=penalty_scaling,
                    dtype=dtype)
            else:
                pmg = build_hp_sharded_pmg(
                    None, degrees, gmesh=mesh, group=group,
                    penalty=penalty, dirichlet=True,
                    penalty_scaling=penalty_scaling, dtype=dtype)
            prob = pmg.levels[-1]
        else:
            if partition == "inherit":
                if shard_prev is None:
                    shard = balanced_partition(mesh, ndev)
                else:
                    shard = shard_prev[mesh.parent] \
                        if mesh.parent is not None else shard_prev
                    counts_i = np.bincount(shard, minlength=ndev)
                    if (counts_i.max()
                            > repartition_threshold * max(counts_i.min(), 1)):
                        shard = balanced_partition(mesh, ndev)
            else:
                shard = {"balanced": balanced_partition,
                         "morton": morton_partition}.get(
                    partition, lambda *_: None)(mesh, ndev)
            t_plan = time.perf_counter()
            prob = build_hp_sharded_general(
                mesh, degrees, group=group, penalty=penalty,
                dirichlet=True, penalty_scaling=penalty_scaling, dtype=dtype,
                elem_shard=shard, plan_cache=plan_cache)
            info["plan_seconds"].append(time.perf_counter() - t_plan)
            info["plan_reuse"].append(plan_cache["__stats__"][-1])
            shard_prev = shard
        counts = [sum(len(prob.owned_slots[(s, p)])
                      for p in prob.degree_set) for s in range(prob.ndev)]
        info["balance"].append(max(counts) / max(min(counts), 1))
        b = prob.scatter_global(l2_functional(gbasis, f, dtype=dtype,
                                              device=dev_),
                                gbasis, dtype=dtype)
        x0 = (prob.scatter_global(x_serial, gbasis, dtype=dtype)
              if x_serial is not None else None)
        if solver == "mg-pcg":
            x_sh, rnorm = hp_pmg_pcg_solve(pmg, b, iters=cg_iters)
            rnorm = rnorm * hp_norm(b, group)  # a RELATIVE norm
        else:
            x_sh, rnorm = hp_pcg_solve(prob, b, iters=cg_iters, x0=x0)
        nb = hp_norm(b, group)
        info["residual"].append(float(rnorm) / max(float(nb), 1e-300))
        xg = prob.gather_global(x_sh, gbasis)
        eta = jump_indicator(gbasis, penalty=penalty,
                             penalty_scaling=penalty_scaling, dtype=dtype,
                             device=dev_)(xg).cpu().numpy()
        info["n_elements"].append(mesh.n_elements)
        info["eta"].append(float(np.sqrt(eta.sum())))
        x_serial = xg
        if c == cycles - 1:
            break
        marks = mark_fraction(eta, frac)
        new_deg = np.asarray(degrees).copy()
        if hp_mode:
            from hpdg_tpu_torch.estimators.smoothness import \
                smoothness_indicator
            smooth = smoothness_indicator(gbasis, xg)
            raise_p = marks & (smooth < smooth_cut) & (new_deg < max_p)
            new_deg[raise_p] += 1
            marks = marks & ~raise_p
        marks = close_marks(mesh, marks)
        saved = save_state(gbasis, xg)
        mesh = refine_local(mesh, marks)
        degrees = degrees_after_refine(new_deg, mesh)
        x_serial = interpolate_to(saved, DGBasis(mesh, degrees), dtype=dtype,
                                  device=dev_)
    return mesh, degrees, x_serial, info
