"""Block smoothers for hp-multigrid.

Port of ``hpdg_tpu.solvers.smoothers`` (the l1 smoothers of the
parallel layer wait for ROADMAP queue 1, item 21):

* damped block Jacobi: the inverses of all diagonal blocks, precomputed
  once per bucket with a batched ``torch.linalg.inv`` in f64 on the
  blocks' device and cast to their dtype (the reference inverts on the
  host, in the blocks' dtype);
* multi-color block Gauss-Seidel: the element face-adjacency graph is
  colored on the host; per color a fresh full residual, then one batched
  solve of that color's blocks;
* lexicographic block Gauss-Seidel, the reference-exact sequential
  sweep (``DynamicBlockGS``): a host loop over block rows with three
  launches per row.  Slow by construction; it exists for residual-history
  parity;
* Chebyshev polynomial smoothing of the block-Jacobi-preconditioned
  operator, with a power-iteration estimate of its spectral radius.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.linalg.blockmatrix import (BlockSparseMatrix,
                                               extract_diagonal, matvec)


def inverse_diagonal_blocks(A) -> dict:
    """p -> [n_p, bs, bs] inverses of the diagonal blocks of ``A``: a
    ``BlockSparseMatrix``, or its diagonal blocks ``{p: [n_p, bs, bs]}``
    as ``matrixfree.sipg_diagonal_blocks`` returns them.  Inverted in
    f64, returned in the blocks' dtype."""
    D = extract_diagonal(A) if isinstance(A, BlockSparseMatrix) else A
    return {p: torch.linalg.inv(d.double()).to(d.dtype) for p, d in D.items()}


def apply_blockdiag(Dinv: dict, x: dict) -> dict:
    return {p: torch.bmm(Dinv[p], x[p].unsqueeze(-1)).squeeze(-1)
            for p in x}


def block_jacobi_preconditioner(A):
    """r -> Dinv r (for PCG); ``A`` as for
    :func:`inverse_diagonal_blocks`."""
    Dinv = inverse_diagonal_blocks(A)
    return lambda r: apply_blockdiag(Dinv, r)


def block_jacobi_step(A: BlockSparseMatrix, omega: float = 1.0):
    """Damped block-Jacobi iteration step: x += omega * Dinv (b - A x)."""
    Dinv = inverse_diagonal_blocks(A)

    def step(x, b):
        r = bv.sub(b, matvec(A, x))
        return bv.axpy(omega, apply_blockdiag(Dinv, r), x)

    return step


# ---------------------------------------------------------------------------
def greedy_coloring(mesh) -> np.ndarray:
    """Color the element face-adjacency graph (host, greedy in element
    order): each element takes the smallest color none of its
    already-colored neighbors has.  Structured conforming meshes get 2
    colors.  Returns (n_elements,) int32 colors."""
    n = mesh.n_elements
    fi = np.asarray(mesh.faces.inside, dtype=np.int64)
    fo = np.asarray(mesh.faces.outside, dtype=np.int64)
    # neighbors of each element in CSR form
    src = np.concatenate([fi, fo])
    dst = np.concatenate([fo, fi])
    order = np.argsort(src, kind="stable")
    nbr = dst[order]
    start = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n))])
    colors = np.full(n, -1, dtype=np.int32)
    for e in range(n):
        cn = colors[nbr[start[e]:start[e + 1]]]
        used = cn[cn >= 0]
        c = 0
        while (used == c).any():
            c += 1
        colors[e] = c
    return colors


def colored_block_gs_step(A: BlockSparseMatrix, basis, colors=None,
                          reverse: bool = False):
    """Multi-color block Gauss-Seidel sweep (one step = all colors once):
    per color a fresh residual ``b - A x`` and one batched solve of that
    color's diagonal blocks; the colors run in order (reversed when
    ``reverse``)."""
    colors = greedy_coloring(basis.mesh) if colors is None else colors
    ncol = int(colors.max()) + 1
    Dinv = inverse_diagonal_blocks(A)
    device = next(iter(A.values.values())).device
    # per color and bucket: positions of that color's elements in the
    # bucket, and their inverse diagonal blocks
    masks = []
    for c in range(ncol):
        per_p = {}
        for p in basis.bucket_degrees:
            pos = np.flatnonzero(colors[basis.bucket_elems[p]] == c)
            if len(pos):
                pos_t = torch.as_tensor(pos, dtype=torch.int64, device=device)
                per_p[p] = (pos_t, Dinv[p][pos_t])
        masks.append(per_p)
    order = masks[::-1] if reverse else masks

    def step(x, b):
        for per_p in order:
            r = bv.sub(b, matvec(A, x))
            x = dict(x)
            for p, (pos, Dc) in per_p.items():
                upd = torch.bmm(Dc, r[p][pos].unsqueeze(-1)).squeeze(-1)
                x[p] = x[p].index_add(0, pos, upd)
        return x

    return step


def richardson(step_fn, sweeps: int):
    """Compose ``sweeps`` applications of an iteration step."""

    def multi(x, b):
        for _ in range(sweeps):
            x = step_fn(x, b)
        return x

    return multi


# ---------------------------------------------------------------------------
class LexicographicBlockGS:
    """Sequential block Gauss-Seidel in element order, the reference's
    ``DynamicBlockGS`` sweep: :meth:`forward` visits the rows 0..n-1,
    :meth:`backward` n-1..0 (the post-smoothing direction of a symmetric
    V-cycle).

    Every element's off-diagonal blocks are stored once as one padded
    ``[bs, maxnnz * bs]`` row (mixed degrees pad to the largest block,
    with zero blocks and identity diagonals, as the reference's mixed
    branch does), so a row costs three launches: gather the neighbor
    values, ``addmv`` the defect, ``mv`` by the inverse diagonal block.
    Both directions share the tables.
    """

    def __init__(self, A: BlockSparseMatrix, basis):
        n = basis.mesh.n_elements
        device = next(iter(A.values.values())).device
        dtype = next(iter(A.values.values())).dtype
        bs_of = {p: A.br(p) for p in basis.bucket_degrees}
        bsmax = max(bs_of.values())
        # off-diagonal blocks in element order
        re_all, ce_all, key_all, slot_all = [], [], [], []
        for (pr, pc), (rows, cols) in A.pattern.entries.items():
            re = basis.bucket_elems[pr][rows]
            ce = basis.bucket_elems[pc][cols]
            off = np.flatnonzero(re != ce)
            re_all.append(re[off])
            ce_all.append(ce[off])
            slot_all.append(off)
            key_all.append(np.full(len(off), len(key_all)))
        keys = list(A.pattern.entries)
        re_all = np.concatenate(re_all).astype(np.int64)
        ce_all = np.concatenate(ce_all).astype(np.int64)
        slot_all = np.concatenate(slot_all)
        key_all = np.concatenate(key_all)
        # k-th neighbor of each row in pattern order (stable by row)
        order = np.lexsort((np.arange(len(re_all)), re_all))
        counts = np.bincount(re_all, minlength=n)
        maxnnz = max(1, int(counts.max()) if len(counts) else 1)
        kth = np.arange(len(order)) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        blk = torch.zeros((n, maxnnz, bsmax, bsmax), dtype=dtype,
                          device=device)
        colid = np.zeros((n, maxnnz), dtype=np.int64)
        r_o, c_o, k_o = re_all[order], ce_all[order], kth
        colid[r_o, k_o] = c_o
        for ki, (pr, pc) in enumerate(keys):
            m = key_all[order] == ki
            if not m.any():
                continue
            src = torch.as_tensor(slot_all[order][m], device=device)
            blk[torch.as_tensor(r_o[m], device=device),
                torch.as_tensor(k_o[m], device=device),
                :bs_of[pr], :bs_of[pc]] = A.values[(pr, pc)][src]
        # [n, bs, maxnnz * bs]: row e times the stacked neighbor values
        self.boff = blk.permute(0, 2, 1, 3).reshape(n, bsmax, maxnnz * bsmax)
        self.colid = torch.as_tensor(colid, device=device)
        # padded inverse diagonal blocks (identity on the padding), f64
        D = extract_diagonal(A)
        Dpad = torch.eye(bsmax, dtype=torch.float64, device=device).repeat(
            n, 1, 1)
        for p in basis.bucket_degrees:
            e = torch.as_tensor(basis.bucket_elems[p], device=device)
            Dpad[e, :bs_of[p], :bs_of[p]] = D[p].double()
        self.dinv = torch.linalg.inv(Dpad).to(dtype)
        self.pos = {p: torch.as_tensor(basis.bucket_elems[p], device=device)
                    for p in basis.bucket_degrees}
        self.bs_of, self.bsmax, self.n = bs_of, bsmax, n
        self.dtype, self.device = dtype, device

    def _sweep(self, rows, x: dict, b: dict) -> dict:
        xf = torch.zeros((self.n, self.bsmax), dtype=self.dtype,
                         device=self.device)
        bf = torch.zeros_like(xf)
        for p, e in self.pos.items():
            xf[e, :self.bs_of[p]] = x[p]
            bf[e, :self.bs_of[p]] = b[p]
        boff, colid, dinv = self.boff, self.colid, self.dinv
        for r in rows:
            xg = xf.index_select(0, colid[r]).reshape(-1)
            res = torch.addmv(bf[r], boff[r], xg, alpha=-1.0)
            torch.mv(dinv[r], res, out=xf[r])
        return {p: xf[e, :self.bs_of[p]] for p, e in self.pos.items()}

    def forward(self, x: dict, b: dict) -> dict:
        return self._sweep(range(self.n), x, b)

    def backward(self, x: dict, b: dict) -> dict:
        return self._sweep(range(self.n - 1, -1, -1), x, b)


def lexicographic_block_gs_step(A: BlockSparseMatrix, basis,
                                reverse: bool = False):
    """One sequential block-GS sweep ``step(x, b) -> x`` in element
    order (backward when ``reverse``); see :class:`LexicographicBlockGS`."""
    gs = LexicographicBlockGS(A, basis)
    return gs.backward if reverse else gs.forward


# ---------------------------------------------------------------------------
def estimate_rho(apply_fn, precond_fn, x_like: dict, iters: int = 30) -> float:
    """Power-iteration estimate of rho(M^-1 A) (host loop at setup).

    The start vector is random, drawn from ``default_rng(1887)`` per
    bucket in dict order as the reference draws it: the ones vector
    under-estimates rho."""
    rng = np.random.default_rng(1887)
    v = {p: torch.as_tensor(rng.standard_normal(tuple(t.shape)),
                            dtype=t.dtype, device=t.device)
         for p, t in x_like.items()}
    nrm = 1.0
    for _ in range(iters):
        w = precond_fn(apply_fn(v))
        nrm = float(bv.norm(w))
        v = bv.scale(1.0 / max(nrm, 1e-30), w)
    return nrm


def chebyshev_smoother(apply_fn, precond_fn, lmax: float,
                       degree: int = 3, lmin_frac: float = 0.15):
    """Chebyshev(degree) smoother for the preconditioned operator
    M^-1 A on the eigenvalue band [lmin_frac lmax, lmax]; needs operator
    applies only.  Returns an ``(x, b) -> x`` iteration step.

    ``lmin_frac``: the band must reach down to what the coarse space
    represents (2:1 h-coarsening and p-halving cover up to about 0.25 of
    the fine spectrum)."""
    theta = 0.5 * (lmax * lmin_frac + lmax)
    delta = 0.5 * (lmax - lmax * lmin_frac)

    def step(x, b):
        r = precond_fn(bv.sub(b, apply_fn(x)))
        d = bv.scale(1.0 / theta, r)
        sigma = theta / delta
        rho_old = 1.0 / sigma
        x = bv.add(x, d)
        for _ in range(degree - 1):
            r = precond_fn(bv.sub(b, apply_fn(x)))
            rho_new = 1.0 / (2.0 * sigma - rho_old)
            d = bv.axpy(rho_new * rho_old, d,
                        bv.scale(2.0 * rho_new / delta, r))
            rho_old = rho_new
            x = bv.add(x, d)
        return x

    return step
