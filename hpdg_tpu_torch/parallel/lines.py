"""Sharded line-block smoothing: per-shard block-tridiagonal solves along
element lines.

Port of ``hpdg_tpu.parallel.lines``.  ``hp_line_precond`` builds, for a
sharded problem (:class:`~hpdg_tpu_torch.parallel.hp.HPSharded`), the
preconditioner r -> M^{-1} r with M the line-block-tridiagonal part of
the operator:

- lines are built on the GLOBAL mesh and cut at shard boundaries: each
  shard factors the contiguous segments of its OWNED elements, so any
  partition works (cut lines degrade toward block Jacobi at the cuts);
- the per-segment block-Thomas factors come from the serially assembled
  operator (f64, host factorization), as the per-shard diagonal blocks
  do;
- the solve is one forward and one backward walk over line position,
  each step one batched ``[lines, B, B]`` product over the segments of
  ALL local shards at once: shard-local, no halo traffic; mixed degrees
  are padded to B = (p_max+1)^dim.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.solvers.lines import build_lines, line_tridiag_factor


def _auto_axis(mesh) -> int:
    """Strong coupling runs along the SHORTEST element extent."""
    return int(np.argmin(np.mean(mesh.extent, axis=0)))


def hp_line_precond(prob, degrees, axis: int | None = None,
                    penalty: float = 2.0, dirichlet: bool = True,
                    penalty_scaling: str = "measure", dtype=torch.float64,
                    diffusion=None):
    """Line-block-tridiagonal preconditioner for a sharded problem: a
    callable on its sharded bucket-dict layout."""
    from hpdg_tpu_torch import mesh as hmesh
    from hpdg_tpu_torch.assemble import assemble_laplace

    group = prob.group
    dev_ = group.device
    degrees = np.asarray(degrees, dtype=np.int32).reshape(-1)
    gmesh = prob.gmesh if prob.gmesh is not None \
        else hmesh.structured(prob.cells)
    if axis is None:
        axis = _auto_axis(gmesh)
    gbasis = DGBasis(gmesh, degrees)
    A = assemble_laplace(gbasis, penalty=penalty, dirichlet=dirichlet,
                         penalty_scaling=penalty_scaling,
                         dtype=torch.float64, diffusion=diffusion,
                         device=dev_)

    glines = build_lines(gmesh, axis)
    ndev = prob.ndev
    shard_of = np.full(gmesh.n_elements, -1, dtype=np.int64)
    for (s, p), ids in prob.owned_slots.items():
        shard_of[ids] = s

    # contiguous owned runs per shard ("segments")
    seg_lists = [[] for _ in range(ndev)]
    for line in glines:
        run_shard, run = -1, []
        for e in list(line) + [-1]:
            s = shard_of[e] if e >= 0 else -1
            if s != run_shard:
                if run:
                    seg_lists[run_shard].append(run)
                run, run_shard = [], s
            if s >= 0:
                run.append(int(e))
    NL = max(max((len(sl) for sl in seg_lists), default=1), 1)
    K = max((len(seg) for sl in seg_lists for seg in sl), default=1)
    dim = gmesh.dim
    B = (gbasis.max_degree() + 1) ** dim

    Lr = group.L
    lo = group.shards.start
    Sinv = np.zeros((Lr, NL, K, B, B))
    W = np.zeros((Lr, NL, K, B, B))
    U = np.zeros((Lr, NL, K, B, B))
    Sinv[:] = np.eye(B)  # padding segments: identity pivots
    e2lk = {}            # (s, e) -> (l, k)
    for s in group.shards:
        sl = seg_lists[s]
        if not sl:
            continue
        tab = np.full((len(sl), K), -1, dtype=np.int64)
        for li, seg in enumerate(sl):
            tab[li, : len(seg)] = seg
            for k, e in enumerate(seg):
                e2lk[(s, e)] = (li, k)
        fac = line_tridiag_factor(A, gbasis, axis=axis, lines=tab)
        Sinv[s - lo, : len(sl)] = fac["Sinv"]
        W[s - lo, : len(sl)] = fac["W"]
        U[s - lo, : len(sl)] = fac["U"]

    # per-bucket (line row, position) of every local owned slot, line
    # rows flattened over the local shards; padding slots -> dump row
    dump = Lr * NL
    maps = {}
    for p in prob.degree_set:
        li = np.full((Lr, prob.m_own[p]), dump, dtype=np.int64)
        po = np.zeros((Lr, prob.m_own[p]), dtype=np.int64)
        for s in group.shards:
            for j, e in enumerate(prob.owned_slots[(s, p)]):
                l_, k_ = e2lk[(s, int(e))]
                li[s - lo, j], po[s - lo, j] = (s - lo) * NL + l_, k_
        maps[p] = (torch.as_tensor(li.reshape(-1), device=dev_),
                   torch.as_tensor(po.reshape(-1), device=dev_))

    up = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(np.swapaxes(a.reshape((Lr * NL,) + a.shape[2:]),
                                         0, 1)), dtype=dtype, device=dev_)
    ST, WT, UT = up(Sinv), up(W), up(U)    # [K, lines, B, B]
    n_lines = Lr * NL

    def solve(r: dict) -> dict:
        Y = torch.zeros((K, n_lines + 1, B), dtype=dtype, device=dev_)
        for p, rp in r.items():
            li, po = maps[p]
            Y[po, li, :rp.shape[-1]] = rp.to(dtype)
        Y = Y[:, :n_lines]
        for k in range(1, K):
            Y[k] = Y[k] - torch.einsum("lij,lj->li", WT[k], Y[k - 1])
        X = torch.empty_like(Y)
        X[K - 1] = torch.einsum("lij,lj->li", ST[K - 1], Y[K - 1])
        for k in range(K - 2, -1, -1):
            X[k] = torch.einsum(
                "lij,lj->li", ST[k],
                Y[k] - torch.einsum("lij,lj->li", UT[k], X[k + 1]))
        X = torch.cat([X, X.new_zeros((K, 1, B))], 1)  # dump row = 0
        return {p: X[maps[p][1], maps[p][0], :rp.shape[-1]].to(rp.dtype)
                for p, rp in r.items()}

    return solve
