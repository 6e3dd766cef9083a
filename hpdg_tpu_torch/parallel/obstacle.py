"""Sharded TNNMG: obstacle problems over a shard group.

Port of ``hpdg_tpu.parallel.obstacle``.  Per iteration:

1. projected damped block-Jacobi pre-smoothing (a batched projected
   scalar GS inside each diagonal block, Jacobi-lagged neighbours): one
   halo exchange per sweep;
2. truncation where the iterate sits on an obstacle;
3. V-cycle-preconditioned CG on the truncated defect problem;
4. projection of the correction into the constraints;
5. exact quadratic line search by group psums, NaN-guarded.

The host loop reads the correction norm (and the history columns) once
per iteration.  Padding rows sit at the trivial constraint lo = up = 0,
so they stay exactly zero.
"""

from __future__ import annotations

import torch

from hpdg_tpu_torch.parallel.comm import safe_div
from hpdg_tpu_torch.parallel.hp import (HPShardedPMG, hp_dot, hp_axpy,
                                        hp_norm, _zeros_like)


def solve_tnnmg_sharded(pmg: HPShardedPMG, b: dict, lo: dict, up: dict,
                        tol: float = 1e-9, maxiter: int = 100,
                        pre_sweeps: int = 3, omega: float | None = None,
                        inner_cg_iters: int = 8, active_eps: float = 1e-13):
    """Sharded TNNMG loop.  ``b``, ``lo``, ``up`` are sharded bucket
    dicts (``HPSharded.scatter_global``: its zero padding pins the
    padding rows).  Returns ``(x, history)`` with the columns
    correction, damping, truncated count and energy.

    ``omega``: projected-Jacobi damping, default min(0.95/rho(D^-1 A), 1)
    by power iteration from the ones vector.  ``inner_cg_iters``: the
    V-cycle-preconditioned CG iterations of the truncated solve."""
    fine = pmg.levels[-1]
    g = fine.group
    dim = fine.ndim
    # padding rows always count as truncated: subtract them
    n_pad_dofs = sum(
        (fine.ndev * fine.m_own[p]
         - sum(len(fine.owned_slots[(s, p)]) for s in range(fine.ndev)))
        * (p + 1) ** dim for p in fine.degree_set)

    if omega is None:
        v = {p: torch.ones_like(a) for p, a in b.items()}
        nw = torch.ones((), dtype=next(iter(b.values())).dtype,
                        device=g.device)
        for _ in range(30):
            w = fine.dinv_mul(fine.apply(v))
            nw = hp_norm(w, g)
            inv = torch.where(nw > 0, 1.0 / nw, torch.zeros_like(nw))
            v = {p: a * inv for p, a in w.items()}
        rho = float(nw)
        omega = min(0.95 / max(rho, 1e-3), 1.0)

    def local_projected_solve(Dm, r_loc, y, lo_b, up_b, inner=2):
        """Batched projected scalar GS inside each diagonal block."""
        bs = Dm.shape[1]
        y = y.clone()
        for _ in range(inner):
            for i in range(bs):
                s = torch.einsum("nj,nj->n", Dm[:, i, :], y) \
                    - Dm[:, i, i] * y[:, i]
                yi = (r_loc[:, i] - s) / Dm[:, i, i]
                y[:, i] = torch.minimum(torch.maximum(yi, lo_b[:, i]),
                                        up_b[:, i])
        return y

    def clip(v, lo_, up_):
        return torch.minimum(torch.maximum(v, lo_), up_)

    def psmooth(x):
        for _ in range(pre_sweeps):
            r = {p: b[p] - v for p, v in fine.apply(x).items()}
            out = {}
            for p in x:
                Dm = fine.diag[p].to(x[p].dtype)
                r_loc = r[p] + torch.einsum("nij,nj->ni", Dm, x[p])
                y = local_projected_solve(Dm, r_loc, x[p], lo[p], up[p])
                out[p] = clip(x[p] + omega * (y - x[p]), lo[p], up[p])
            x = out
        return x

    def truncated_solve(free, r_masked):
        """MG-PCG on A_tr c = r_masked, A_tr = M A M + (I - M)."""
        def A_tr(v):
            vm = {p: torch.where(free[p], v[p], 0.0) for p in v}
            Av = fine.apply(vm)
            return {p: torch.where(free[p], Av[p], v[p]) for p in v}

        def prec(r):
            rm = {p: torch.where(free[p], r[p], 0.0) for p in r}
            z = pmg.step(_zeros_like(r), rm)
            return {p: torch.where(free[p], z[p], r[p]) for p in r}

        x = _zeros_like(r_masked)
        r = r_masked
        z = prec(r)
        rz = hp_dot(r, z, g)
        pv = z
        for _ in range(inner_cg_iters):
            Ap = A_tr(pv)
            alpha = safe_div(rz, hp_dot(pv, Ap, g))
            x = hp_axpy(alpha, pv, x)
            r = hp_axpy(-alpha, Ap, r)
            z = prec(r)
            rz_new = hp_dot(r, z, g)
            pv = hp_axpy(safe_div(rz_new, rz), pv, z)
            rz = rz_new
        return x

    def step(x):
        x_start = x
        x = psmooth(x)
        r = {p: b[p] - v for p, v in fine.apply(x).items()}
        free = {}
        ntrunc = 0
        for p in x:
            tol_p = active_eps * (1 + x[p].abs())
            at_lo = torch.isfinite(lo[p]) & (x[p] - lo[p] <= tol_p)
            at_up = torch.isfinite(up[p]) & (up[p] - x[p] <= tol_p)
            free[p] = ~(at_lo | at_up)
            ntrunc = ntrunc + (~free[p]).sum()
        ntrunc = g.psum(ntrunc)
        r_masked = {p: torch.where(free[p], r[p], 0.0) for p in r}
        c = truncated_solve(free, r_masked)
        c = {p: torch.where(free[p], c[p], 0.0) for p in c}
        c = {p: clip(x[p] + c[p], lo[p], up[p]) - x[p] for p in c}
        cAc = hp_dot(c, fine.apply(c), g)
        rc = hp_dot(r, c, g)
        alpha = torch.where(cAc > 0, rc / torch.where(cAc == 0, 1.0, cAc),
                            torch.ones_like(cAc))
        alpha = torch.nan_to_num(alpha, nan=0.0).clamp(0.0, 1.0)
        x = hp_axpy(alpha, c, x)
        corr = hp_norm({p: x[p] - x_start[p] for p in x}, g)
        energy = 0.5 * hp_dot(x, fine.apply(x), g) - hp_dot(b, x, g)
        return x, corr, alpha, ntrunc, energy

    x = {p: clip(torch.zeros_like(v), lo[p], up[p]) for p, v in b.items()}
    history = {"correction": [], "damping": [], "truncated": [],
               "energy": []}
    for _ in range(maxiter):
        x, corr, alpha, ntrunc, energy = step(x)
        vals = torch.stack([corr, alpha.to(corr.dtype),
                            ntrunc.to(corr.dtype), energy]).tolist()
        history["correction"].append(vals[0])
        history["damping"].append(vals[1])
        history["truncated"].append(int(vals[2]) - n_pad_dofs)
        history["energy"].append(vals[3])
        if vals[0] < tol:
            break
    history["iterations"] = len(history["correction"])
    return x, history
