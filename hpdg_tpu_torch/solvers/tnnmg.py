"""TNNMG: truncated nonsmooth Newton multigrid for obstacle problems.

Port of ``hpdg_tpu.solvers.tnnmg``: minimize J(x) = 1/2 x^T A x - b^T x
subject to lo <= x <= up.  One TNNMG iteration is

1. projected block Gauss-Seidel pre-smoothing: a colored sweep whose
   local solver is a projected scalar GS inside each diagonal block,
   batched over the blocks of a color (``matrixfree.jacobi
   .local_projected_gs``);
2. truncation: dofs at an active obstacle are frozen;
3. one linear multigrid step on the truncated defect problem;
4. projection of the correction into the defect constraints;
5. an exact quadratic line search, NaN-guarded.

Every path is a host loop whose iteration reads one number from the
device, the correction norm, and keeps the other diagnostics on the
device until the loop ends.  The reference fuses the loop into one
``lax.while_loop`` program; its counterpart here,
:func:`tnnmg_fused_solver`, captures one iteration as a CUDA graph on a
card and replays it once per iteration.

:func:`solve_obstacle_verified` solves to a host-verified f64 free-dof
residual: f32 TNNMG settles the contact set, then a primal-dual
active-set (PDAS) loop solves the truncated systems by f64 iterative
refinement around f32 parametric V-cycles (:class:`TruncatedRefinement`,
on a card two replayed graphs per step).  The card has native f64, so
the anchor is a plain f64 residual on the device where the reference
needed exact-split pairs.  On CPU tensors the graphs' bodies run
eagerly; on a card a body that cannot be captured raises, with no
eager fallback.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.matrixfree.jacobi import local_projected_gs
from hpdg_tpu_torch.solvers import smoothers as sm
from hpdg_tpu_torch.solvers.multigrid import (multigrid_solver,
                                              parametric_cycle,
                                              setup_hierarchy)
from hpdg_tpu_torch.solvers.refine import _sync, capture_graph


def projected_block_gs_step(A: bm.BlockSparseMatrix, basis: DGBasis,
                            lo: dict, up: dict, colors=None,
                            inner_sweeps: int = 2):
    """Colored block GS whose local solve is a projected scalar GS on the
    diagonal block (obstacle clamping inside the block sweep).  Per
    color a fresh residual; the local right-hand side is the block
    residual plus ``D x`` so the block unknowns are recomputed from
    scratch.  Returns ``step(x, b) -> x``."""
    colors = sm.greedy_coloring(basis.mesh) if colors is None else colors
    D = bm.extract_diagonal(A)
    device = next(iter(D.values())).device
    # per color and bucket: positions, diagonal blocks and bounds
    per_color = []
    for c in range(int(colors.max()) + 1):
        per_p = {}
        for p in basis.bucket_degrees:
            pos = np.flatnonzero(colors[basis.bucket_elems[p]] == c)
            if len(pos):
                pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
                per_p[p] = (pos, D[p][pos], lo[p][pos], up[p][pos])
        per_color.append(per_p)

    def step(x, b):
        for per_p in per_color:
            r = bv.sub(b, bm.matvec(A, x))
            x = dict(x)
            for p, (pos, Dm, lo_b, up_b) in per_p.items():
                x_loc = x[p][pos]
                r_loc = r[p][pos] + torch.bmm(
                    Dm, x_loc.unsqueeze(-1)).squeeze(-1)
                y = local_projected_gs(Dm, r_loc, x_loc, lo_b, up_b,
                                       sweeps=inner_sweeps)
                x[p] = x[p].index_copy(0, pos, y)
        return x

    return step


def truncated_matrix(A: bm.BlockSparseMatrix, free: dict
                     ) -> bm.BlockSparseMatrix:
    """Zero the rows and columns of non-free (active-obstacle) dofs and
    put a unit diagonal there: the truncated linearization matrix.  The
    result keeps ``A``'s pattern object, so the Galerkin products of a
    renewed hierarchy hit their symbolic cache."""
    vals = {}
    for key in A.pattern.entries:
        v = A.values[key]
        rows, cols = A.index(key, v.device)
        fr = free[key[0]][rows].to(v.dtype)
        fc = free[key[1]][cols].to(v.dtype)
        vals[key] = v * fr[:, :, None] * fc[:, None, :]
    for p, n in A.pattern.row_sizes.items():
        # diagonal-first layout: block (r, r) sits at slot r
        v = vals[(p, p)]
        inactive = 1.0 - free[p][:n].to(v.dtype)
        v[:n] += inactive[:, :, None] * torch.eye(v.shape[1], dtype=v.dtype,
                                                  device=v.device)
    return bm.BlockSparseMatrix(A.pattern, A.dim, vals, A.block_shape)


def _tnnmg_one_iter(A, b, basis, lo, up, mg_step, pre_sweeps, active_eps,
                    hierarchy=None):
    """One TNNMG iteration (stages 1-5 and the diagnostics) as a function
    ``x -> (x_new, (corr, alpha, energy, ntrunc))`` of 0-dim device
    tensors, with no host sync.

    ``hierarchy = (data, cycle)``: the correction comes from a
    parametric cycle on the Galerkin hierarchy of the TRUNCATED matrix,
    renewed every iteration (the reference's per-iterate preprocessing);
    otherwise ``mg_step`` runs on the untruncated hierarchy and the
    truncation acts on the fine level only."""
    smoother = projected_block_gs_step(A, basis, lo, up)
    dtype = next(iter(b.values())).dtype

    def energy(v):
        return 0.5 * bv.dot(v, bm.matvec(A, v)) - bv.dot(b, v)

    def masks(xv):
        free = {}
        ntrunc = 0
        for p in xv:
            tol_p = active_eps * (1 + xv[p].abs())
            at_lo = torch.isfinite(lo[p]) & (xv[p] - lo[p] <= tol_p)
            at_up = torch.isfinite(up[p]) & (up[p] - xv[p] <= tol_p)
            free[p] = ~(at_lo | at_up)
            ntrunc = ntrunc + (~free[p]).sum()
        return free, ntrunc

    def one_iter(x_old):
        x = x_old
        for _ in range(pre_sweeps):
            x = smoother(x, b)
        free, ntrunc = masks(x)
        r = bv.sub(b, bm.matvec(A, x))
        r_masked = {p: torch.where(free[p], r[p], 0.0) for p in r}
        if hierarchy is None:
            c = mg_step(bv.zeros_like(b), r_masked)
        else:
            data, cycle = hierarchy
            data.renew(truncated_matrix(A, free), dtype=dtype)
            dinvs = [sm.inverse_diagonal_blocks(M) for M in data.matrices]
            c = cycle(data.matrices, dinvs, bv.zeros_like(b), r_masked)
        # project the truncated correction into the box, line-search
        c = {p: torch.clamp(x[p] + torch.where(free[p], c[p], 0.0),
                            lo[p], up[p]) - x[p] for p in c}
        cAc = bv.dot(c, bm.matvec(A, c))
        rc = bv.dot(r, c)
        alpha = torch.where(cAc > 0, rc / cAc, 1.0)
        alpha = torch.clamp(torch.nan_to_num(alpha, nan=0.0), 0.0, 1.0)
        x_new = bv.axpy(alpha, c, x)
        corr = bv.norm(bv.sub(x_new, x_old))
        return x_new, (corr, alpha, energy(x_new), ntrunc)

    return one_iter


def _tnnmg_loop(one_iter, x, tol, maxiter, stall_window, verbose=False):
    """Iterate ``one_iter`` with the stopping rules: correction < tol,
    or (with ``stall_window``) corrections below 1e-3 of the first AND
    no decrease over the window (the f32 correction floor).  One
    device -> host read per iteration (the correction); the other
    diagnostics come down once at the end."""
    corrs, stats = [], []
    history = {}
    for it in range(maxiter):
        x, (corr_d, alpha, en, ntrunc) = one_iter(x)
        corr = float(corr_d)  # the iteration's one sync
        corrs.append(corr)
        stats.append(torch.stack([alpha.double(), en.double(),
                                  torch.as_tensor(ntrunc).double()]))
        if verbose:
            print(f"tnnmg it={it} corr={corr:.3e} alpha={float(alpha):.3f} "
                  f"trunc={int(ntrunc)}")
        if corr < tol:
            break
        if stall_window and len(corrs) > stall_window:
            small = corr < 1e-3 * corrs[0]
            flat = corr > 0.9 * corrs[-1 - stall_window]
            if small and flat:
                history["stalled"] = True
                break
    st = torch.stack(stats).cpu().numpy() if stats else np.zeros((0, 3))
    history.update(correction=corrs, damping=[float(v) for v in st[:, 0]],
                   truncated=[int(v) for v in st[:, 2]],
                   energy=[float(v) for v in st[:, 1]],
                   iterations=len(corrs))
    return x, history


class FusedTNNMG:
    """The TNNMG loop over a static iterate, built once and called as
    ``solve(x0=None) -> (x, history)``.

    :meth:`body` is one iteration on the static ``x``: it returns the
    correction, damping, energy and truncated count as 0-dim tensors
    and, after the correction has read the old ``x``, copies the new
    iterate into it.  On a card it is captured here as a CUDA graph
    (``graph``, its outputs ``diag``; the reference compiles its loop
    once) and every iteration replays it; on CPU tensors it runs
    eagerly.  The host applies the stepwise loop's stopping rules after
    every iteration, as the reference's ``while_loop`` does after every
    body, so the iterates are the stepwise route's."""

    def __init__(self, one_iter, b: dict, lo: dict, up: dict, tol: float,
                 maxiter: int, stall_window: int):
        self.one_iter, self.lo, self.up = one_iter, lo, up
        self.tol, self.maxiter, self.stall_window = tol, maxiter, stall_window
        self.x = {p: torch.clamp(torch.zeros_like(b[p]), lo[p], up[p])
                  for p in b}
        device = next(iter(b.values())).device
        self.graph = self.diag = None
        if device.type == "cuda":
            self.graph, self.diag = capture_graph(self.body, device)

    def body(self):
        x_new, diag = self.one_iter(self.x)
        for p in self.x:
            self.x[p].copy_(x_new[p])
        return diag

    def _step(self, _):
        if self.graph is None:
            return self.x, self.body()
        self.graph.replay()
        # the next replay rewrites the outputs: the history keeps copies
        return self.x, tuple(v.clone() for v in self.diag)

    def __call__(self, x0: dict | None = None):
        for p in self.x:
            x = torch.zeros_like(self.x[p]) if x0 is None else x0[p]
            self.x[p].copy_(torch.clamp(x, self.lo[p], self.up[p]))
        x, history = _tnnmg_loop(self._step, self.x, self.tol, self.maxiter,
                                 self.stall_window)
        return {p: v.clone() for p, v in x.items()}, history


def tnnmg_fused_solver(A: bm.BlockSparseMatrix, b: dict, basis: DGBasis,
                       lo: dict, up: dict, mg_step=None, tol: float = 1e-9,
                       maxiter: int = 100, pre_sweeps: int = 1,
                       active_eps: float = 1e-13,
                       stall_window: int = 0) -> FusedTNNMG:
    """Build once, solve many: the TNNMG loop as a reusable callable
    ``solve(x0=None) -> (x, history)`` (the multigrid set-up, the
    smoother's tables and, on a card, the iteration's CUDA graph are
    built here, once: :class:`FusedTNNMG`)."""
    if mg_step is None:
        mg_step, _ = multigrid_solver(basis, A,
                                      dtype=next(iter(b.values())).dtype)
    one_iter = _tnnmg_one_iter(A, b, basis, lo, up, mg_step, pre_sweeps,
                               active_eps)
    return FusedTNNMG(one_iter, b, lo, up, tol, maxiter, stall_window)


def solve_tnnmg(A: bm.BlockSparseMatrix, b: dict, basis: DGBasis,
                lo: dict, up: dict, mg_step=None, x0: dict | None = None,
                tol: float = 1e-9, maxiter: int = 100, pre_sweeps: int = 1,
                active_eps: float = 1e-13, verbose: bool = False,
                truncate_hierarchy: bool = False, stall_window: int = 0,
                fused: bool = False):
    """The TNNMG loop (solveObstacle analog) on the device of ``A``.

    Returns ``(x, history)``: per iteration the correction norm, the
    damping factor, the truncated-dof count and the energy, plus
    ``iterations`` and ``stalled`` when the stall rule stopped it.

    ``truncate_hierarchy=True`` re-Galerkin-restricts the TRUNCATED
    matrix down the hierarchy every iteration and runs one parametric
    cycle on it (the reference-faithful variant; the structure is built
    once).  The default truncates on the fine level only, around the
    untruncated ``mg_step``.  ``fused=True`` runs the default path
    through :func:`tnnmg_fused_solver` (same iterates, same history).
    """
    if fused and truncate_hierarchy:
        raise ValueError(
            "fused=True needs the default path: truncate_hierarchy "
            "renews the Galerkin hierarchy on the host every iteration")
    x = bv.zeros_like(b) if x0 is None else x0
    x = {p: torch.clamp(x[p], lo[p], up[p]) for p in x}
    dtype = next(iter(b.values())).dtype
    if fused:
        return tnnmg_fused_solver(
            A, b, basis, lo, up, mg_step=mg_step, tol=tol, maxiter=maxiter,
            pre_sweeps=pre_sweeps, active_eps=active_eps,
            stall_window=stall_window)(x)
    hierarchy = None
    if truncate_hierarchy:
        data = setup_hierarchy(basis, A, dtype=dtype)
        hierarchy = (data, parametric_cycle(data, dtype=dtype))
    elif mg_step is None:
        mg_step, _ = multigrid_solver(basis, A, dtype=dtype)
    one_iter = _tnnmg_one_iter(A, b, basis, lo, up, mg_step, pre_sweeps,
                               active_eps, hierarchy)
    return _tnnmg_loop(one_iter, x, tol, maxiter, stall_window, verbose)


# ---------------------------------------------------------------------
# Verified deep-tolerance obstacle solves
# ---------------------------------------------------------------------

def _np_matvec(A64, x64: dict) -> dict:
    """``A x`` in host numpy f64 for numpy bucket dicts ``x64`` (the
    values of ``A64`` come to the host in each call): a route
    independent of the device SpMV."""
    pattern = A64.pattern
    out = {}
    for (pr, pc), (rows, cols) in pattern.entries.items():
        W = A64.values[(pr, pc)].detach().cpu().numpy().astype(np.float64)
        y = out.setdefault(pr, np.zeros((pattern.row_sizes[pr], W.shape[1])))
        np.add.at(y, rows, np.einsum("nij,nj->ni", W, x64[pc][cols]))
    return out


def check_feasible(x64: dict, lo64: dict, up64: dict) -> tuple:
    """``(feasible, feas_tol)`` of a host f64 iterate: every finite bound
    holds within ``feas_tol = 1e-10 (1 + max|x|)``.  A non-finite entry
    of ``x`` makes it infeasible (``max`` in Python drops a NaN, so the
    comparison alone would let one through)."""
    if not all(np.all(np.isfinite(v)) for v in x64.values()):
        return False, float("nan")
    feas_tol = 1e-10 * (1.0 + max(float(np.max(np.abs(v)))
                                  for v in x64.values()))
    viol = 0.0
    for k in x64:
        lo_v = np.where(np.isfinite(lo64[k]), lo64[k] - x64[k], -np.inf)
        up_v = np.where(np.isfinite(up64[k]), x64[k] - up64[k], -np.inf)
        viol = max(viol, float(np.max(lo_v)), float(np.max(up_v)))
    return viol <= feas_tol, feas_tol


def complementarity(r64: dict, x64: dict, lo64: dict, free: dict,
                    feas_tol: float, nb: float) -> float:
    """The largest wrong-signed multiplier ``lambda = A x - b = -r`` on
    the active dofs, relative to ``||b||``: lower-active dofs need
    lambda >= 0, upper-active ones lambda <= 0.  A non-finite multiplier
    on an active dof gives ``inf``."""
    comp = 0.0
    for k in r64:
        act = ~free[k]
        if not np.any(act):
            continue
        lam = -r64[k]
        if not np.all(np.isfinite(lam[act])):
            return float("inf")
        at_lo = act & np.isfinite(lo64[k]) \
            & (np.abs(x64[k] - lo64[k]) <= feas_tol)
        at_up = act & ~at_lo
        if np.any(at_lo):
            comp = max(comp, float(np.max(np.maximum(-lam[at_lo], 0.0))) / nb)
        if np.any(at_up):
            comp = max(comp, float(np.max(np.maximum(lam[at_up], 0.0))) / nb)
    return comp


class TruncatedRefinement:
    """The inner solve of a PDAS outer iteration, the counterpart of the
    reference's ``_truncated_refine_prog``: the truncated system ``F A F
    y = b_tr`` by f64 refinement from the last outer's ``y``.  Per step
    the f64 anchor ``r = F (b_tr - A64 (F y)) - (I - F) y`` and its norm
    ``nr`` (one read: the step's barrier), a stop at ``nr <= tol_cut``,
    else the chain: ``chain_k`` f32 parametric cycles from zero on
    ``r / nr``, then ``y += nr c``.  Built once per solve and reused by
    every outer and every run.

    ``fused=True`` keeps static buffers: the level matrices' values and
    their inverse diagonal blocks, ``F`` in f64, ``b_tr``, ``y`` and the
    anchor's ``r`` and ``nr``.  On a card the anchor and the chain are
    captured here as two CUDA graphs over them (one memory pool) and
    replayed; the host replays the chain only while the anchor misses,
    where the reference's ``lax.cond`` skips it.  Each outer renews the
    truncated hierarchy eagerly, as the reference does outside its
    program, and copies it into the buffers: ``MultigridData.renew``
    rebinds the level matrices to new tensors, which a graph captured on
    the old ones would never read.  On CPU tensors the same bodies run
    eagerly on the buffers.  ``fused=False`` runs them on the renewed
    hierarchy itself, the route the graphs are held against.
    """

    def __init__(self, A64: bm.BlockSparseMatrix, A32: bm.BlockSparseMatrix,
                 data, cycle, b64: dict, *, chain_k: int = 8,
                 max_steps: int = 12, fused: bool = True):
        self.A64, self.A32, self.data, self.cycle = A64, A32, data, cycle
        self.chain_k, self.max_steps, self.fused = chain_k, max_steps, fused
        self.keys = sorted(b64)
        self.y = {k: torch.zeros_like(b64[k]) for k in self.keys}
        self.mats = list(data.matrices)
        self.dinvs = [sm.inverse_diagonal_blocks(M) for M in self.mats]
        self.ff = {k: torch.ones_like(b64[k]) for k in self.keys}
        # the capture's warm-up solves the untruncated system for b64
        self.b_tr = {k: b64[k].clone() for k in self.keys}
        self.graphs = None
        if not fused:
            return
        self.mats = [bm.BlockSparseMatrix(
            M.pattern, M.dim, {key: v.clone() for key, v in M.values.items()},
            M.block_shape) for M in self.mats]
        device = b64[self.keys[0]].device
        if device.type == "cuda":
            g_anchor, _ = capture_graph(self._anchor, device)
            g_anchor.replay()  # the chain's warm-up reads a real residual
            g_chain, _ = capture_graph(self._chain, device,
                                       pool=g_anchor.pool())
            self.graphs = (g_anchor, g_chain)
            self.reset()  # the warm-ups moved y

    def _anchor(self):
        ff, y = self.ff, self.y
        Ay = bm.matvec(self.A64, {k: ff[k] * y[k] for k in self.keys})
        self.r = {k: ff[k] * (self.b_tr[k] - Ay[k]) - (1.0 - ff[k]) * y[k]
                  for k in self.keys}
        self.nr = bv.norm(self.r)

    def _chain(self):
        inv = 1.0 / self.nr
        rhs = {k: (self.r[k] * inv).to(torch.float32) for k in self.keys}
        c = bv.zeros_like(rhs)
        for _ in range(self.chain_k):
            c = self.cycle(self.mats, self.dinvs, c, rhs)
        for k in self.keys:
            self.y[k].add_(self.nr * c[k].to(torch.float64))

    def reset(self):
        """Zero the warm start (a new solve)."""
        for v in self.y.values():
            v.zero_()

    def load(self, free: dict, b_tr: dict):
        """Renew the truncated hierarchy for the free mask ``free`` and
        take ``b_tr``: into the static buffers (``fused``) or as they
        are."""
        data = self.data
        data.renew(truncated_matrix(self.A32, free), dtype=torch.float32)
        dinvs = [sm.inverse_diagonal_blocks(M) for M in data.matrices]
        ff = {k: free[k].to(torch.float64) for k in self.keys}
        if not self.fused:
            self.mats, self.dinvs = list(data.matrices), dinvs
            self.ff, self.b_tr = ff, b_tr
            return
        for S, M, Ds, D in zip(self.mats, data.matrices, self.dinvs, dinvs):
            for key, v in M.values.items():
                S.values[key].copy_(v)
            for p, d in D.items():
                Ds[p].copy_(d)
        for k in self.keys:
            self.ff[k].copy_(ff[k])
            self.b_tr[k].copy_(b_tr[k])

    def __call__(self, free: dict, b_tr: dict, tol_cut: float) -> list:
        """One outer's solve from the current ``y``; returns the anchored
        residual norms, one per step.  The answer stays in ``self.y``,
        the next outer's warm start."""
        self.load(free, b_tr)
        anchor, chain = self._anchor, self._chain
        if self.graphs is not None:
            anchor, chain = (g.replay for g in self.graphs)
        hist = []
        while len(hist) < self.max_steps:
            anchor()
            nr = float(self.nr)  # the step's one device -> host read
            hist.append(nr)
            if nr <= tol_cut:
                break
            chain()
        return hist


def solve_obstacle_verified(A64, b64: dict, basis: DGBasis, lo, up,
                            tol: float = 1e-8, *, maxiter: int = 40,
                            stall_window: int = 3, pre_sweeps: int = 1,
                            max_outer: int = 12, chain_k: int = 8,
                            max_steps: int = 12, mg_pre_steps: int = 3,
                            mg_post_steps: int = 3, dedup: bool = True,
                            meshes: list | None = None,
                            n_runs: int = 1, verbose: bool = False):
    """Obstacle problem solved to a VERIFIED f64 free-dof residual, on
    the device of ``A64`` (f64).

    1. f32 TNNMG (:func:`tnnmg_fused_solver`, correction tol ``1e-6
       ||b||``, the stall rule) settles the contact set;
    2. a primal-dual active-set loop: per outer iteration the active set
       follows the PDAS rule ``active_lo = {lambda + c (lo - x) > 0}``
       with ``lambda = A x - b`` in f64 on the device and ``c`` the mean
       diagonal entry of A; the truncated system ``F A F y = F (b - A
       x_act)`` is solved by f64 refinement (per step: the f64 residual
       ``r = F (b_tr - A (F y)) - (I - F) y``, one read of its norm, stop
       at ``tol ||b||``, else ``chain_k`` f32 parametric cycles from zero
       on the renewed truncated hierarchy: :class:`TruncatedRefinement`),
       warm-started from the last outer's solution; the loop ends when
       the active set is stationary.

    On a card both phases replay CUDA graphs captured once per call: one
    TNNMG iteration, and the refinement's anchor and chain.

    The returned ``info`` holds ``stationary`` (whether the active set
    settled within ``max_outer``) and host numpy f64 measurements:
    ``free_residual`` (relative to ``||b||``), ``feasible`` and
    ``complementarity``; ``verified`` iff feasible and the free-dof
    residual met ``tol``.  ``n_runs`` repeats the whole solve (phase 1
    from zero each time) and returns the best run; ``info["runs"]``
    holds each run's record.  ``seconds_capture`` is the build of the
    two phases' programs (their tables, warm-ups and captures), outside
    every run's ``seconds``, as the reference's compile and warm-up are.
    ``dedup`` selected the exact-split anchor's chunk store in the
    reference and has no effect here.
    """
    f32, f64 = torch.float32, torch.float64
    keys = sorted(b64)
    device = b64[keys[0]].device
    b64 = {k: b64[k].to(f64) for k in keys}
    lo64 = {k: lo[k].to(device=device, dtype=f64) for k in keys}
    up64 = {k: up[k].to(device=device, dtype=f64) for k in keys}
    nb = float(bv.norm(b64))
    A32 = bm.BlockSparseMatrix(A64.pattern, A64.dim,
                               {k: v.to(f32) for k, v in A64.values.items()},
                               A64.block_shape)
    b32 = {k: v.to(f32) for k, v in b64.items()}
    lo32 = {k: v.to(f32) for k, v in lo64.items()}
    up32 = {k: v.to(f32) for k, v in up64.items()}
    b_host = {k: v.cpu().numpy() for k, v in b64.items()}
    lo_host = {k: v.cpu().numpy() for k, v in lo64.items()}
    up_host = {k: v.cpu().numpy() for k, v in up64.items()}

    # PDAS scale c: the mean diagonal entry of A (units of A)
    diag = bm.extract_diagonal(A32)
    cscale = float(np.mean([float(diag[p].diagonal(dim1=1, dim2=2)
                                  .abs().mean()) for p in diag]))

    # phase 1: f32 TNNMG to the correction floor
    mg_step, _ = multigrid_solver(basis, A32, meshes=meshes, dtype=f32)
    t0 = time.perf_counter()
    solver1 = tnnmg_fused_solver(A32, b32, basis, lo32, up32,
                                 mg_step=mg_step, tol=1e-6 * nb,
                                 maxiter=maxiter, pre_sweeps=pre_sweeps,
                                 stall_window=stall_window)
    t_capture = time.perf_counter() - t0
    # phase 2 machinery, built once: the hierarchy of the truncated
    # matrix (renewed per outer), the parametric cycle and the inner solve
    free_all = {k: torch.ones(b32[k].shape, dtype=torch.bool, device=device)
                for k in keys}
    data = setup_hierarchy(basis, truncated_matrix(A32, free_all),
                           meshes=meshes, dtype=f32)
    cycle = parametric_cycle(data, pre_steps=mg_pre_steps,
                             post_steps=mg_post_steps, dtype=f32)
    t0 = time.perf_counter()
    refine = TruncatedRefinement(A64, A32, data, cycle, b64,
                                 chain_k=chain_k, max_steps=max_steps)
    t_capture += time.perf_counter() - t0
    tol_cut = tol * nb

    def one_solve():
        _sync(device)
        t0 = time.perf_counter()
        x32, hist1 = solver1()
        x64 = {k: x32[k].to(f64) for k in keys}
        _sync(device)
        t1 = time.perf_counter()
        free = None
        stationary = False
        outer_hist = []
        refine.reset()
        for outer in range(max_outer):
            Ax = bm.matvec(A64, x64)
            lam = {k: Ax[k] - b64[k] for k in keys}  # lambda = A x - b
            act_lo = {k: torch.isfinite(lo64[k])
                      & (lam[k] + cscale * (lo64[k] - x64[k]) > 0)
                      for k in keys}
            act_up = {k: torch.isfinite(up64[k]) & ~act_lo[k]
                      & (-lam[k] + cscale * (x64[k] - up64[k]) > 0)
                      for k in keys}
            free_new = {k: ~(act_lo[k] | act_up[k]) for k in keys}
            if free is not None and all(torch.equal(free_new[k], free[k])
                                        for k in keys):
                stationary = True
                break  # active set stationary: converged
            free = free_new
            x_act = {k: torch.where(act_lo[k], lo64[k],
                                    torch.where(act_up[k], up64[k], 0.0))
                     for k in keys}
            Axa = bm.matvec(A64, x_act)
            b_tr = {k: torch.where(free[k], b64[k] - Axa[k], 0.0)
                    for k in keys}
            # warm start: near stationarity the active set changes by a
            # handful of dofs per outer, so the last solution is close
            h = refine(free, b_tr, tol_cut)
            x64 = {k: x_act[k] + torch.where(free[k], refine.y[k], 0.0)
                   for k in keys}
            ntr = int(sum(int((~free[k]).sum()) for k in keys))
            outer_hist.append({"steps": len(h), "truncated": ntr,
                               "anchored": [v / nb for v in h]})
            if verbose:
                print(f"pdas outer={outer} trunc={ntr} steps={len(h)} "
                      f"r={outer_hist[-1]['anchored'][-1:]}")
        _sync(device)
        t2 = time.perf_counter()
        # host numpy f64 verification
        x_np = {k: v.cpu().numpy() for k, v in x64.items()}
        free_np = {k: v.cpu().numpy() for k, v in free.items()}
        r64 = {k: b_host[k] - v
               for k, v in _np_matvec(A64, x_np).items()}
        free_res = float(np.sqrt(sum(
            float(np.vdot(r64[k][free_np[k]], r64[k][free_np[k]]))
            for k in keys))) / nb
        feasible, feas_tol = check_feasible(x_np, lo_host, up_host)
        comp = complementarity(r64, x_np, lo_host, free_np, feas_tol, nb)
        seconds = time.perf_counter() - t0
        info = {"tnnmg": hist1, "outer": outer_hist,
                "free_residual": free_res, "feasible": feasible,
                "complementarity": comp, "seconds": seconds,
                "seconds_tnnmg": t1 - t0, "seconds_pdas": t2 - t1,
                "truncated": (outer_hist[-1]["truncated"]
                              if outer_hist else 0),
                "stationary": stationary,
                "verified": bool(feasible and free_res <= tol)}
        return x_np, info

    def record(info):
        return {"seconds": round(info["seconds"], 3),
                "free_residual": float(f"{info['free_residual']:.3e}"),
                **{k: info[k] for k in ("seconds_tnnmg", "seconds_pdas",
                                        "verified", "feasible",
                                        "complementarity", "truncated",
                                        "stationary")},
                "tnnmg_iterations": info["tnnmg"]["iterations"],
                "stalled": info["tnnmg"].get("stalled", False),
                "steps": [o["steps"] for o in info["outer"]]}

    best_x, best = one_solve()
    runs = [record(best)]
    for _ in range(n_runs - 1):
        x64, info = one_solve()
        runs.append(record(info))
        if (info["verified"] and not best["verified"]) or (
                info["verified"] == best["verified"]
                and info["seconds"] < best["seconds"]):
            best_x, best = x64, info
    best.update(runs=runs, seconds_capture=t_capture)
    return best_x, best
