"""hp-adaptive L-shape Poisson (BASELINE config 3).

Port of ``examples/adaptive_lshape.py``: solve -> estimate (the jump
indicator) -> Dörfler-mark -> hp decision (the smoothness indicator:
raise p where smooth, refine h where rough) -> persist -> repeat, for
-Δu = 1 on the L-shape with Dirichlet boundaries (SIPG, penalty 2).

    python -m hpdg_tpu_torch.examples.adaptive_lshape --steps 4 --frac 0.4

``levels > 0`` starts from ``levels`` uniform refinements of
``lshape(n)`` and hands the solver the refinement history (the uniform
levels, then every ``refine_local`` mesh since) as its h-levels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble.plan import build_plan
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.blocks.persist import (degrees_after_refine,
                                           interpolate_to, save_state)
from hpdg_tpu_torch.estimators.smoothness import smoothness_indicator
from hpdg_tpu_torch.estimators.utility import mark_fraction
from hpdg_tpu_torch.matrixfree.norms import jump_indicator
from hpdg_tpu_torch.mesh.adaptive import refine_local
from hpdg_tpu_torch.mesh.structured import hierarchy, lshape

PENALTY = 2.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n: int = 2, steps: int = 4, frac: float = 0.4,
        smooth_cut: float = 0.5, levels: int = 0, method: str = "multigrid",
        device=None) -> list:
    """The adaptive loop; returns one record per step: the solved
    ``basis``, its h-levels ``meshes`` (or ``None``), ``x`` and solve
    ``info``, ``ndof``, the ``degrees`` histogram, the jump indicator
    ``eta`` per element and its root sum ``eta_total``, the Dörfler
    ``marks`` and their split into
    ``raise_p`` and ``refine_h``, the carried state ``x_next`` on the
    next basis, and host-clock seconds (after a device sync) of the
    set-up (``mesh_s``, ``assembly_s``, ``hierarchy_s``), ``solve_s``,
    ``estimate_s`` and ``interpolate_s``."""
    device = dev.resolve(device)
    meshes = hierarchy(lshape(n), levels) if levels > 0 else None
    m = meshes[-1] if meshes else lshape(n)
    basis = DGBasis(m, np.full(m.n_elements, 1))
    f = lambda x: 1.0 + 0.0 * x[..., 0]  # noqa: E731
    records = []
    t_mesh = 0.0
    for it in range(steps):
        t0 = time.perf_counter()
        plan = build_plan(basis)
        A = api.laplace(basis, penalty=PENALTY, dirichlet=True, plan=plan,
                        device=device)
        b = api.l2_functional(basis, f, device=device)
        _sync(device)
        t_asm = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, info = api.solve_linear(basis, A, b, tol=1e-9, maxiter=80,
                                   meshes=meshes, method=method)
        _sync(device)
        t_all = time.perf_counter() - t0
        t_solve = info.get("seconds", t_all)

        t0 = time.perf_counter()
        eta = jump_indicator(basis, penalty=PENALTY, plan=plan,
                             device=device)(x).cpu().numpy()
        marks = mark_fraction(eta, frac)
        smooth = smoothness_indicator(basis, x)
        raise_p = marks & (smooth < smooth_cut)
        refine_h = marks & ~raise_p
        t_est = time.perf_counter() - t0

        saved, solved_meshes = save_state(basis, x), meshes
        t0 = time.perf_counter()
        new_deg = basis.degrees.copy()
        new_deg[raise_p] += 1
        if refine_h.any():
            newmesh = refine_local(basis.mesh, refine_h)
            new_deg = degrees_after_refine(new_deg, newmesh)
            new_basis = DGBasis(newmesh, new_deg)
            if meshes is not None:
                meshes = meshes + [newmesh]
        else:
            new_basis = basis.with_degrees(new_deg)
        t_next_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        x_next = interpolate_to(saved, new_basis, device=device)
        _sync(device)
        t_interp = time.perf_counter() - t0

        records.append(dict(
            step=it, basis=basis, meshes=solved_meshes, x=x, info=info,
            ndof=basis.ndof,
            degrees=dict(zip(*np.unique(basis.degrees, return_counts=True))),
            eta=eta, eta_total=float(np.sqrt(eta.sum())), marks=marks,
            raise_p=raise_p, refine_h=refine_h, x_next=x_next,
            mesh_s=t_mesh, assembly_s=t_asm, hierarchy_s=t_all - t_solve,
            solve_s=t_solve, estimate_s=t_est, interpolate_s=t_interp))
        basis, t_mesh = new_basis, t_next_mesh
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--frac", type=float, default=0.4)
    ap.add_argument("--smooth-cut", type=float, default=0.5)
    ap.add_argument("--levels", type=int, default=0)
    ap.add_argument("--method", default="multigrid",
                    choices=("multigrid", "cg+mg", "mf", "onchip"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    for r in run(args.n, args.steps, args.frac, args.smooth_cut,
                 args.levels, args.method, args.device):
        iters = r["info"].get("cycles", r["info"].get("iterations"))
        print(f"step {r['step']}: {r['ndof']} dofs, max p = "
              f"{r['basis'].max_degree()}, eta = {r['eta_total']:.4e}, "
              f"iters = {iters}")


if __name__ == "__main__":
    main()
