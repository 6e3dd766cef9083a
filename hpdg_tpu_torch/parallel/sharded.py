"""Sharded matrix-free SIPG operator and solver steps (uniform degree).

Port of ``hpdg_tpu.parallel.sharded``: a slab decomposition of a
structured box mesh along axis 0 over a shard group.  Every shard runs
the same local program:

* bulk and slab-interior face terms: the batched sum-factorized apply
  on the local sub-mesh.  A rank's ``L`` slabs are laid out as ``L``
  detached copies of the template slab (constant coefficients: the
  geometry is translation invariant), so one operator serves all of
  them at once;
* shard-interface terms: one element layer to each neighbour by
  ``ppermute``, then the cross-face SIPG terms, masked by "do I have a
  neighbour";
* domain x-boundaries: the Dirichlet terms where there is NO neighbour.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from hpdg_tpu_torch import mesh as hmesh
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.assemble.plan import build_plan
from hpdg_tpu_torch.matrixfree.sumfact import sipg_operator
from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks
from hpdg_tpu_torch.parallel.comm import (ShardGroup, Sharding,
                                          resolve_group, safe_div)
from hpdg_tpu_torch.solvers.graphs import repeat


def detached_copies(m, L: int, gap: float):
    """``L`` copies of box mesh ``m`` along axis 0, ``gap`` apart so that
    no two share a face (copy by copy, each in ``m``'s element order):
    one mesh in which one operator serves a rank's ``L`` shards."""
    if L == 1:
        return m
    shift = np.zeros(m.dim)
    shift[0] = gap
    return hmesh.from_boxes(
        np.concatenate([m.lower + s * shift for s in range(L)]),
        np.tile(m.extent, (L, 1)), validate=False)


@dataclass
class ShardedPoisson:
    """A sharded 2D/3D Poisson SIPG problem (uniform degree)."""

    cells: tuple  # global cells
    p: int
    ndev: int
    axis_name: str
    group: ShardGroup
    local_basis: DGBasis
    layer: int  # elements per x-layer
    n_local: int
    apply: callable  # [L*n_local, bs] -> same
    precond: callable  # block-Jacobi r -> Dinv r
    sharding: Sharding

    @property
    def n_global(self) -> int:
        return self.n_local * self.ndev


def build_sharded_poisson(cells, p: int, group: ShardGroup | None = None,
                          penalty: float = 2.0, dirichlet: bool = True,
                          axis_name: str = "x",
                          dtype=torch.float64) -> ShardedPoisson:
    cells = tuple(int(c) for c in cells)
    dim = len(cells)
    group = resolve_group(group)
    ndev, L, dev_ = group.ndev, group.L, group.device
    if cells[0] % ndev != 0:
        raise ValueError(f"cells[0]={cells[0]} not divisible by {ndev} shards")
    local_cells = (cells[0] // ndev,) + cells[1:]
    h = 1.0 / np.asarray(cells)
    layer = int(np.prod(local_cells[1:]))
    n_local = int(np.prod(local_cells))
    bs = (p + 1) ** dim

    lmesh = hmesh.structured(local_cells,
                             upper=tuple(np.asarray(local_cells) * h))
    lbasis = DGBasis(lmesh, np.full(n_local, p))
    # the rank's L slabs as detached copies (a gap of one element)
    cmesh = detached_copies(lmesh, L, (local_cells[0] + 1) * h[0])
    cbasis = DGBasis(cmesh, np.full(L * n_local, p))
    plan = build_plan(cbasis)
    # the slab x-boundaries are handled by the masked interface terms
    plan_nox = replace(plan, boundary_groups=tuple(
        bg for bg in plan.boundary_groups if bg.axis != 0))
    op_inner = sipg_operator(cbasis, penalty=penalty, dirichlet=dirichlet,
                             plan=plan_nox, dtype=dtype, device=dev_)

    J = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                  device=dev_)
    nq1 = p + 2
    fin = tensor.face_tables(p, dim, 0, 1, nq1, family=lbasis.family)
    fout = tensor.face_tables(p, dim, 0, 0, nq1, family=lbasis.family)
    w = J(fin["weights"])
    Vi, Di = J(fin["V"]), J(fin["Dn"])
    Vo, Do = J(fout["V"]), J(fout["Dn"])
    fmeas = float(np.prod(h[1:]))
    inv_h = float(1.0 / h[0])
    pen_w = penalty * p**2 * w
    zw = fmeas * w[None, :]

    def cross_face_out(u_in, u_out):
        """Output into the OUTSIDE (low-side-local) elements of an x-face."""
        jump = u_in @ Vi - u_out @ Vo
        avg = 0.5 * ((u_in @ Di) * inv_h + (u_out @ Do) * inv_h)
        t1 = zw * avg - pen_w[None, :] * jump
        t2 = zw * (-0.5 * jump) * inv_h
        return t1 @ Vo.T + t2 @ Do.T

    def cross_face_in(u_in, u_out):
        """Output into the INSIDE (high-side-local) elements of an x-face."""
        jump = u_in @ Vi - u_out @ Vo
        avg = 0.5 * ((u_in @ Di) * inv_h + (u_out @ Do) * inv_h)
        t1 = zw * (-avg) + pen_w[None, :] * jump
        t2 = zw * (-0.5 * jump) * inv_h
        return t1 @ Vi.T + t2 @ Di.T

    def diri_terms(side):
        ft = tensor.face_tables(p, dim, 0, side, p + 2, family=lbasis.family)
        V, D = J(ft["V"]), J(ft["Dn"])
        sign = 1.0 if side == 1 else -1.0

        def apply_b(u):
            uq = u @ V
            dnq = (u @ D) * (sign * inv_h)
            t1 = zw * (-dnq) + pen_w[None, :] * uq
            t2 = zw * (-uq) * (sign * inv_h)
            return t1 @ V.T + t2 @ D.T

        return apply_b

    diri_low, diri_high = diri_terms(0), diri_terms(1)
    sid = np.asarray(list(group.shards))
    has_left = J((sid > 0).astype(float)).reshape(L, 1, 1)
    has_right = J((sid < ndev - 1).astype(float)).reshape(L, 1, 1)
    right_perm = [(i, i + 1) for i in range(ndev - 1)]
    left_perm = [(i + 1, i) for i in range(ndev - 1)]

    def apply(x):
        xs = x.reshape(L, n_local, bs)
        xl = group.ppermute(xs[:, -layer:].contiguous(), 0, right_perm)
        xr = group.ppermute(xs[:, :layer].contiguous(), 0, left_perm)
        y = op_inner({p: x})[p].reshape(L, n_local, bs)
        u0, un = xs[:, :layer], xs[:, -layer:]
        low = has_left * cross_face_out(xl, u0)
        high = has_right * cross_face_in(un, xr)
        if dirichlet:
            low = low + (1 - has_left) * diri_low(u0)
            high = high + (1 - has_right) * diri_high(un)
        y = torch.cat([y[:, :layer] + low, y[:, layer:-layer],
                       y[:, -layer:] + high], 1) if n_local > layer else \
            y + low + high
        return y.reshape(L * n_local, bs)

    # block Jacobi: the local operator's diagonal blocks plus the
    # interface (or Dirichlet) contributions of the slab x-faces, masked
    D0 = sipg_diagonal_blocks(cbasis, penalty=penalty, dirichlet=dirichlet,
                              plan=plan_nox, dtype=torch.float64,
                              device=dev_)[p]
    wnp = fin["weights"]
    E = lambda a, b: np.einsum("iq,q,jq->ij", a, wnp, b)  # noqa: E731
    pen_s = penalty * p**2
    AVDo, BVVo = E(fout["V"], fout["Dn"]), E(fout["V"], fout["V"])
    AVDi, BVVi = E(fin["V"], fin["Dn"]), E(fin["V"], fin["V"])
    M22 = 0.5 * fmeas * inv_h * (AVDo + AVDo.T) + pen_s * BVVo
    M11 = -0.5 * fmeas * inv_h * (AVDi + AVDi.T) + pen_s * BVVi
    ft0 = tensor.face_tables(p, dim, 0, 0, p + 2, family=lbasis.family)
    ft1 = tensor.face_tables(p, dim, 0, 1, p + 2, family=lbasis.family)
    AVD0, BVV0 = E(ft0["V"], ft0["Dn"]), E(ft0["V"], ft0["V"])
    AVD1, BVV1 = E(ft1["V"], ft1["Dn"]), E(ft1["V"], ft1["V"])
    Md0 = fmeas * inv_h * (AVD0 + AVD0.T) + pen_s * BVV0
    Md1 = -fmeas * inv_h * (AVD1 + AVD1.T) + pen_s * BVV1
    if not dirichlet:
        Md0 = Md1 = np.zeros((bs, bs))
    F = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                  device=dev_)
    hl, hr = has_left.double(), has_right.double()
    D = D0.reshape(L, n_local, bs, bs).clone()
    D[:, :layer] += (hl * F(M22) + (1 - hl) * F(Md0))[:, None]
    D[:, -layer:] += (hr * F(M11) + (1 - hr) * F(Md1))[:, None]
    Dinv = torch.linalg.inv(D).reshape(L * n_local, bs, bs).to(dtype)

    def precond(r):
        return torch.einsum("nij,nj->ni", Dinv, r)

    return ShardedPoisson(cells=cells, p=p, ndev=ndev, axis_name=axis_name,
                          group=group, local_basis=lbasis, layer=layer,
                          n_local=n_local, apply=apply, precond=precond,
                          sharding=Sharding(group, n_local))


def _dot(prob, a, b):
    return prob.group.psum(torch.vdot(a.reshape(-1), b.reshape(-1)))


def pcg_step(prob: ShardedPoisson):
    """One preconditioned-CG iteration on sharded arrays: reductions are
    group psums, the apply exchanges halos."""

    def step(state):
        x, r, z, pvec, rz = state
        Ap = prob.apply(pvec)
        alpha = safe_div(rz, _dot(prob, pvec, Ap))
        x = x + alpha * pvec
        r = r - alpha * Ap
        z = prob.precond(r)
        rz_new = _dot(prob, r, z)
        beta = safe_div(rz_new, rz)
        pvec = z + beta * pvec
        return x, r, z, pvec, rz_new

    return step


def init_state(prob: ShardedPoisson, b):
    r = b
    z = prob.precond(r)
    return (torch.zeros_like(b), r, z, z, _dot(prob, r, z))


def pcg_solve(prob: ShardedPoisson, b, iters: int):
    """``iters`` PCG iterations with no host read inside the loop, the
    reference's ``fori_loop``: one iteration captured as a CUDA graph and
    replayed on a card (``solvers.graphs.repeat``); returns ``(x,
    ||r||)``."""
    x, r, *_ = repeat(pcg_step(prob), init_state(prob, b), iters)
    return x, torch.sqrt(_dot(prob, r, r))
