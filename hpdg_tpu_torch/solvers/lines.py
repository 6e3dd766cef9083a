"""Line-block smoothers: exact block-tridiagonal solves along element
lines.

Port of ``hpdg_tpu.solvers.lines``.  On meshes with stretched elements
the strong coupling runs along the short axis, and element-block
smoothers leave the along-line modes nearly undamped.  A LINE smoother
groups the elements into lines along the strong axis and solves each
line's block-tridiagonal system exactly: a block-Thomas factorization
over all lines at once (host numpy f64), and a solve that walks the
line positions with one batched ``[n_lines, B, B] x [n_lines, B]``
product per step on the device (three launches per position).

Mixed degrees (hp) pad every block to the largest size
B = ncomp (p_max+1)^dim, with identity diagonals and zero couplings on
the padding (ncomp: 1 for scalar problems, dim for elasticity systems).

Memory: the factorization keeps three [n_lines, K, B, B] arrays
(S^{-1}, L S^{-1}, U), three times the element-diagonal storage.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.linalg import blockvector as bv


def build_lines(mesh, axis: int) -> np.ndarray:
    """Group elements into lines along ``axis``: [n_lines, K] element
    ids, sorted by coordinate along the axis; ragged lines are padded
    with -1.  Elements are in the same line iff their centers agree in
    every other axis (quantized at 1e-9 of the domain size): exact for
    box meshes; hanging-node meshes get shorter (per-patch) lines."""
    c = mesh.centers()
    scale = float(np.abs(c).max()) + 1.0
    q = np.round(c / scale * 1e9).astype(np.int64)
    other = [a for a in range(mesh.dim) if a != axis]
    keys = q[:, other]
    uniq, line_of = np.unique(keys, axis=0, return_inverse=True)
    line_of = line_of.reshape(-1)
    n_lines = len(uniq)
    order = np.lexsort((c[:, axis], line_of))
    counts = np.bincount(line_of, minlength=n_lines)
    K = int(counts.max())
    lines = np.full((n_lines, K), -1, dtype=np.int64)
    pos = np.concatenate([np.arange(k) for k in counts])
    lines[line_of[order], pos] = order
    return lines


def _gather_blocks(A: bm.BlockSparseMatrix, basis: DGBasis, e_row, e_col,
                   out: np.ndarray):
    """``out[i] = `` host copy of block (e_row[i], e_col[i]), zero-padded
    to ``out``'s (B, B), where the pattern has it (non-adjacent
    elements: zero coupling, ``out[i]`` untouched).  The blocks are
    selected on the matrix' device and downloaded once per degree
    pair."""
    pr_all = basis.degrees[e_row]
    pc_all = basis.degrees[e_col]
    for (pr, pc) in A.pattern.entries:
        sel = np.flatnonzero((pr_all == pr) & (pc_all == pc))
        if not len(sel):
            continue
        slots = A.pattern.lookup(pr, pc, basis.elem_bucket_pos[e_row[sel]],
                                 basis.elem_bucket_pos[e_col[sel]])
        hit = slots >= 0
        sel, slots = sel[hit], slots[hit]
        if not len(sel):
            continue
        vals = A.values[(pr, pc)]
        blk = vals.index_select(0, torch.as_tensor(
            slots, dtype=torch.int64, device=vals.device))
        blk = blk.detach().cpu().double().numpy()
        out[sel, :blk.shape[1], :blk.shape[2]] = blk


def line_tridiag_factor(A: bm.BlockSparseMatrix, basis: DGBasis,
                        axis: int = 0, lines: np.ndarray | None = None):
    """Factor the line-block-tridiagonal part of ``A`` (host, f64).

    Block Thomas: S_0 = D_0, S_k = D_k - L_k S_{k-1}^{-1} U_{k-1}.
    Returns a dict of numpy arrays shaped [n_lines, K, B, B]:
      Sinv  inverted pivot blocks,
      W     L_k S_{k-1}^{-1} (forward elimination multiplier, 0 at k=0),
      U     upper coupling blocks (0 at k=K-1),
    plus the line table and per-bucket (line, position) maps.
    """
    if A.block_shape[0] != A.block_shape[1]:
        raise ValueError(f"non-square block shape {A.block_shape}")
    ncomp = A.block_shape[0]  # 1 for scalar, dim for elasticity systems
    mesh = basis.mesh
    if lines is None:
        lines = build_lines(mesh, axis)
    n_lines, K = lines.shape
    pmax = basis.max_degree()
    B = ncomp * (pmax + 1) ** mesh.dim

    D = np.zeros((n_lines, K, B, B))
    U = np.zeros((n_lines, K, B, B))
    Lo = np.zeros((n_lines, K, B, B))
    valid = lines >= 0
    # padding positions of ragged lines: identity pivots
    D[~valid] = np.eye(B)
    li, po = np.nonzero(valid)
    e = lines[li, po]
    blk = np.zeros((len(e), B, B))
    _gather_blocks(A, basis, e, e, blk)
    bs = ncomp * basis.block_sizes[e]
    # identity on the hp padding
    blk[:, np.arange(B), np.arange(B)] += np.arange(B)[None, :] >= bs[:, None]
    D[li, po] = blk
    # couplings to the next element of the same line
    nxt = valid[:, 1:] & valid[:, :-1]
    li, po = np.nonzero(nxt)
    e, en = lines[li, po], lines[li, po + 1]
    up = np.zeros((len(e), B, B))
    _gather_blocks(A, basis, e, en, up)
    U[li, po] = up
    lo = np.zeros((len(e), B, B))
    _gather_blocks(A, basis, en, e, lo)
    Lo[li, po + 1] = lo

    Sinv = np.zeros_like(D)
    W = np.zeros_like(D)
    Sinv[:, 0] = np.linalg.inv(D[:, 0])
    for k in range(1, K):
        W[:, k] = Lo[:, k] @ Sinv[:, k - 1]
        Sinv[:, k] = np.linalg.inv(D[:, k] - W[:, k] @ U[:, k - 1])

    # per-bucket (line, pos) of every element, for bucketed <-> line layout
    line_of = np.full(mesh.n_elements, -1, dtype=np.int64)
    pos_of = np.full(mesh.n_elements, -1, dtype=np.int64)
    li_idx, po_idx = np.nonzero(valid)
    line_of[lines[li_idx, po_idx]] = li_idx
    pos_of[lines[li_idx, po_idx]] = po_idx
    maps = {}
    for p in basis.bucket_degrees:
        el = basis.bucket_elems[p]
        maps[p] = (line_of[el], pos_of[el])
    return dict(Sinv=Sinv, W=W, U=U, lines=lines, maps=maps, B=B,
                dims=(n_lines, K))


def line_solve(fac: dict, dtype=torch.float64, device=None):
    """Exact solve of the factored line system, ``r -> M^{-1} r``, on
    ``device`` in ``dtype``.

    Batched block Thomas: a forward and a backward walk over the line
    positions, each step one batched ``[n_lines, B, B] x [n_lines, B]``
    product (``baddbmm``) for all lines at once; the factors are moved
    to the device once, position-major."""
    device = dev.resolve(device)
    up = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(np.swapaxes(a, 0, 1)), dtype=dtype,
        device=device)
    SinvT, WT, UT = up(fac["Sinv"]), up(fac["W"]), up(fac["U"])
    maps = {p: tuple(torch.as_tensor(a, device=device) for a in m)
            for p, m in fac["maps"].items()}
    n_lines, K = fac["dims"]
    B = fac["B"]

    def solve(r: dict) -> dict:
        Y = torch.zeros((K, n_lines, B), dtype=dtype, device=device)
        for p, rp in r.items():
            lo, po = maps[p]
            Y[po, lo, :rp.shape[-1]] = rp.to(dtype)
        # forward: y_k = r_k - W_k y_{k-1}  (W_0 = 0)
        for k in range(1, K):
            Y[k].unsqueeze(-1).baddbmm_(WT[k], Y[k - 1].unsqueeze(-1),
                                        alpha=-1.0)
        # backward: x_k = Sinv_k (y_k - U_k x_{k+1})  (U_{K-1} = 0)
        X = torch.empty_like(Y)
        torch.bmm(SinvT[K - 1], Y[K - 1].unsqueeze(-1),
                  out=X[K - 1].unsqueeze(-1))
        for k in range(K - 2, -1, -1):
            t = torch.baddbmm(Y[k].unsqueeze(-1), UT[k],
                              X[k + 1].unsqueeze(-1), alpha=-1.0)
            torch.bmm(SinvT[k], t, out=X[k].unsqueeze(-1))
        out = {}
        for p, rp in r.items():
            lo, po = maps[p]
            out[p] = X[po, lo, :rp.shape[-1]].to(rp.dtype)
        return out

    return solve


def line_jacobi_step(A: bm.BlockSparseMatrix, basis: DGBasis,
                     axis: int = 0, omega: float = 1.0,
                     fac: dict | None = None, dtype=torch.float64):
    """Damped line-Jacobi: x <- x + omega * M^{-1}(b - A x) with M the
    line-block-tridiagonal part of A along ``axis``, on the device of
    ``A``."""
    if fac is None:
        fac = line_tridiag_factor(A, basis, axis)
    M = line_solve(fac, dtype=dtype,
                   device=next(iter(A.values.values())).device)

    def step(x: dict, b: dict) -> dict:
        r = bv.sub(b, bm.matvec(A, x))
        return bv.add(x, bv.scale(omega, M(r)))

    return step
