"""Sharded p-multigrid for uniform-degree SIPG on structured slabs.

Port of ``hpdg_tpu.parallel.multigrid``: every level a sharded
matrix-free operator (``parallel.sharded``), element-local p-transfers
(no communication), damped block-Jacobi, x-line or vertex-patch
smoothing, and a fixed-count sharded PCG coarse solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.parallel.comm import ShardGroup, resolve_group
from hpdg_tpu_torch.parallel.sharded import (build_sharded_poisson,
                                             pcg_step, init_state, _dot)


@dataclass
class ShardedPMG:
    levels: list  # coarsest..finest ShardedPoisson problems
    transfers: list  # (bs_f, bs_c) interpolation matrices per gap
    step: callable  # (x, b) -> x on sharded arrays


def line_smoother_x(cells, p: int, penalty: float, dirichlet: bool,
                    dtype=torch.float32, penalty_scaling: str = "measure",
                    omega: float = 0.8, group: ShardGroup | None = None):
    """Line smoother along axis 0: every x-line of elements solved as one
    block-tridiagonal system (one dense inverse per line, assembled and
    inverted on the host in f64), cross-line couplings Jacobi-lagged.
    Lines span the slab axis, so the residual is re-laid-out globally per
    application (an all-gather over ranks)."""
    from hpdg_tpu_torch import mesh as hmesh
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.assemble import assemble_laplace

    group = resolve_group(group)
    dim = len(cells)
    Lx = int(cells[0])
    nlines = int(np.prod(cells[1:]))
    bs = (p + 1) ** dim
    gmesh = hmesh.structured(cells)
    gb = DGBasis(gmesh, np.full(gmesh.n_elements, p))
    A = assemble_laplace(gb, penalty=penalty, dirichlet=dirichlet,
                         penalty_scaling=penalty_scaling,
                         dtype=torch.float64, device="cpu")
    mats = np.zeros((nlines, Lx * bs, Lx * bs))
    for (pr, pc), (rows, cols) in A.pattern.entries.items():
        vals = A.values[(pr, pc)].numpy()
        re = gb.bucket_elems[pr][rows]
        ce = gb.bucket_elems[pc][cols]
        lr, pr0 = re % nlines, re // nlines
        lc, pc0 = ce % nlines, ce // nlines
        for k in np.where(lr == lc)[0]:  # x-line-internal couplings
            i0, j0 = int(pr0[k]) * bs, int(pc0[k]) * bs
            mats[lr[k], i0:i0 + bs, j0:j0 + bs] += vals[k]
    inv = torch.as_tensor(np.linalg.inv(mats), dtype=dtype,
                          device=group.device)
    n_loc = Lx * nlines // group.ndev

    def smooth(apply_fn, x, b):
        r = group.all_rows(b - apply_fn(x))  # [n, bs], x slowest
        rl = r.reshape(Lx, nlines, bs).transpose(0, 1).reshape(
            nlines, Lx * bs)
        d = torch.einsum("lab,lb->la", inv.to(r.dtype), rl)
        d = d.reshape(nlines, Lx, bs).transpose(0, 1).reshape(r.shape)
        return x + omega * group.local_rows(d, n_loc)

    return smooth


def build_sharded_pmg(cells, p: int, group: ShardGroup | None = None,
                      penalty: float = 2.0, dirichlet: bool = True,
                      dtype=torch.float32, pre_steps: int = 3,
                      post_steps: int = 3, jacobi_omega: float = 0.5,
                      smoother: str = "jacobi", coarse_cg_iters: int = 60,
                      smoother_sweeps: int = 1) -> ShardedPMG:
    """A sharded p-multigrid V-cycle for uniform-degree SIPG Poisson on a
    structured mesh.  ``smoother``: ``"jacobi"`` (damped block Jacobi,
    omega = min(jacobi_omega, 1/rho(D^-1 A))), ``"line"`` (x-line
    block-tridiagonal solves) or ``"patch"`` (colored vertex-patch
    Schwarz, block Jacobi on levels whose patches exceed 1024 dofs)."""
    group = resolve_group(group)
    dim = len(cells)
    orders = [p]
    while orders[-1] > 1:
        orders.append(max(1, orders[-1] // 2))
    orders = orders[::-1]  # coarsest..finest

    probs = [build_sharded_poisson(cells, q, group=group, penalty=penalty,
                                   dirichlet=dirichlet, dtype=dtype)
             for q in orders]
    Ts = [torch.as_tensor(tensor.interpolation_matrix(
        orders[l], orders[l + 1], dim), dtype=dtype, device=group.device)
        for l in range(len(orders) - 1)]

    omegas = []
    for prob in probs:
        v = torch.ones((group.L * prob.n_local, (prob.p + 1) ** dim),
                       dtype=dtype, device=group.device)
        v = v / torch.sqrt(_dot(prob, v, v))
        for _ in range(20):
            w = prob.precond(prob.apply(v))
            v = w / torch.sqrt(_dot(prob, w, w))
        w = prob.precond(prob.apply(v))
        rho = float(torch.sqrt(_dot(prob, w, w)))
        omegas.append(min(jacobi_omega, 1.0 / rho))

    if smoother == "line":
        line_smooths = [line_smoother_x(cells, q, penalty, dirichlet,
                                        dtype=dtype, group=group)
                        for q in orders]

    patch_sweeps = [None] * len(orders)
    if smoother == "patch":
        from hpdg_tpu_torch import mesh as hmesh
        from hpdg_tpu_torch.basis.dgbasis import DGBasis
        from hpdg_tpu_torch.assemble import assemble_laplace
        from hpdg_tpu_torch.parallel.patches import sharded_patch_sweeps
        for li, (q, prob) in enumerate(zip(orders, probs)):
            if 2 ** dim * (q + 1) ** dim > 1024:
                continue
            gmesh = hmesh.structured(cells)
            gb = DGBasis(gmesh, np.full(gmesh.n_elements, q, dtype=np.int32))
            Ag = assemble_laplace(gb, penalty=penalty, dirichlet=dirichlet,
                                  dtype=torch.float64, device="cpu")
            patch_sweeps[li] = sharded_patch_sweeps(prob, Ag, gb,
                                                    dtype=dtype)

    def jacobi(lvl, x, b, steps):
        prob, om = probs[lvl], omegas[lvl]
        for _ in range(steps):
            if smoother == "line":
                x = line_smooths[lvl](prob.apply, x, b)
            else:
                x = x + om * prob.precond(b - prob.apply(x))
        return x

    def coarse_solve(b):
        step = pcg_step(probs[0])
        state = init_state(probs[0], b)
        for _ in range(coarse_cg_iters):
            state = step(state)
        return state[0]

    def run(l, x, b):
        if l == 0:
            return coarse_solve(b)
        prob = probs[l]
        if patch_sweeps[l] is not None:
            for _ in range(smoother_sweeps):
                x = patch_sweeps[l][0](x, b)
        else:
            x = jacobi(l, x, b, pre_steps)
        r = b - prob.apply(x)
        rc = r @ Ts[l - 1]  # restriction = T^T per element
        xc = run(l - 1, torch.zeros_like(rc), rc)
        x = x + xc @ Ts[l - 1].T
        if patch_sweeps[l] is not None:
            for _ in range(smoother_sweeps):
                x = patch_sweeps[l][1](x, b)
        else:
            x = jacobi(l, x, b, post_steps)
        return x

    nlev = len(orders)
    return ShardedPMG(levels=probs, transfers=Ts,
                      step=lambda x, b: run(nlev - 1, x, b))


def solve_sharded_pmg(pmg: ShardedPMG, b, cycles: int = 20):
    """``cycles`` V-cycles from zero; returns ``(x, ||b - A x||)``."""
    fine = pmg.levels[-1]
    x = torch.zeros_like(b)
    for _ in range(cycles):
        x = pmg.step(x, b)
    r = b - fine.apply(x)
    return x, torch.sqrt(_dot(fine, r, r))
