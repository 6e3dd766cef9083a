"""Deduplicated block-sparse SpMV: the general-mesh assembled apply.

Port of ``hpdg_tpu.matrixfree.dedup``.  A bucketed block-sparse SIPG
matrix on a (locally refined) lattice holds only a few hundred DISTINCT
blocks: equal geometry gives bitwise-equal blocks (interior stencil,
per-level variants, boundary and hanging-face variants).  The operator
stores the unique blocks plus int64 indices and applies

    y[rows_u] += x[cols_u] @ W_u^T        for each unique block u.

The reference issues one gather and one GEMM per unique block (~525 per
apply at 14^3 with 30% refined, p=4).  Here the unique blocks of one
(pr, pc) key are grouped into SIZE CLASSES: class c holds the blocks
used by m entries with 2^(c-1) < m <= 2^c, padded to 2^c entries
(at most 2x padding), and each class is one gather of ``x`` plus one
batched ``bmm``.  All products of a row bucket then land with ONE
``index_add_`` (padding entries land on a spare row that is dropped).

* :func:`dedup_spmv_operator` finds the dictionary in an assembled
  ``BlockSparseMatrix`` (bitwise row dedup, hash-accelerated).
* :func:`dedup_spmv_from_plan` never assembles: every constant-
  coefficient block is ``coef_row @ D`` (``assemble_laplace(
  coef_parts=True)``), so the dedup runs on the small ``[nnz, K]``
  coefficient table and only the unique blocks are multiplied out.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev


def _row_keys(u: np.ndarray) -> np.ndarray:
    """One int64 key per row of the u64 view ``u`` (two random odd
    multiplier sums, the reference's hash)."""
    rng = np.random.default_rng(0xD5D0)
    m = u.shape[1]
    w1 = rng.integers(1, 2**63, size=m, dtype=np.uint64) * 2 + 1
    w2 = rng.integers(1, 2**63, size=m, dtype=np.uint64) * 2 + 1
    with np.errstate(over="ignore"):
        h1 = (u * w1[None, :]).sum(axis=1, dtype=np.uint64)
        h2 = (u * w2[None, :]).sum(axis=1, dtype=np.uint64)
    return (h1.astype(np.int64) << np.int64(1)) ^ h2.astype(np.int64)


def _first_occurrence(gid: np.ndarray, ngroups: int):
    """Relabel group ids ``gid`` (any labelling) by first occurrence:
    returns ``(uid, reps)`` with ``reps[u]`` the first row of group u."""
    n = len(gid)
    firstpos = np.full(ngroups, n, np.int64)
    np.minimum.at(firstpos, gid, np.arange(n))
    order = np.argsort(firstpos, kind="stable")
    rank = np.empty(ngroups, np.int64)
    rank[order] = np.arange(ngroups)
    return rank[gid], firstpos[order]


def unique_rows(flat: np.ndarray):
    """Bitwise-unique rows of a 2D array, hash-accelerated.

    Each row is reduced to a 64-bit key (one sort of scalar keys), then
    every member is verified bitwise against its group's representative,
    so the grouping is EXACT, not probabilistic.  Returns ``(uid [n]
    int64 group ids, reps [nu] int64 representative row indices)`` with
    group ids ordered by first occurrence — on the hash-collision
    fallback too (where the reference orders them lexicographically).
    """
    n = flat.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    b = np.ascontiguousarray(flat).view(np.uint8).reshape(n, -1)
    # pad the byte rows to a multiple of 8 for a u64 view
    pad = (-b.shape[1]) % 8
    if pad:
        b = np.concatenate([b, np.zeros((n, pad), np.uint8)], axis=1)
    u = b.view(np.uint64)
    key = _row_keys(u)
    _, first, gid = np.unique(key, return_index=True, return_inverse=True)
    gid = gid.reshape(-1)
    if not (u == u[first[gid]]).all():
        # hash collision: exact (lexicographic) grouping, then relabel
        _, gid = np.unique(b, axis=0, return_inverse=True)
        gid = np.asarray(gid).reshape(-1)
    return _first_occurrence(gid, int(gid.max()) + 1)


def _group(rows, cols, uid, nu: int):
    """Entries sorted by unique-block id (stable): ``(rows_perm,
    cols_perm, bounds)``, block u's entries at ``bounds[u]:bounds[u+1]``."""
    perm = np.argsort(uid, kind="stable")
    return (rows[perm], cols[perm],
            [int(b) for b in np.searchsorted(uid[perm], np.arange(nu + 1))])


def dedup_blocks(pattern, values) -> dict:
    """Host-side dictionary build.  Returns per (pr, pc):
    ``(rows_perm, cols_perm, group_bounds, W_unique)`` with entries
    sorted by unique-block id (stable), so each unique block's entries
    are one contiguous slice."""
    out = {}
    for (pr, pc), (rows, cols) in pattern.entries.items():
        W = np.asarray(values[(pr, pc)])
        uid, reps = unique_rows(np.ascontiguousarray(W).reshape(len(W), -1))
        out[(pr, pc)] = _group(rows, cols, uid, len(reps)) + (W[reps],)
    return out


def _size_classes(rows_p, cols_p, bounds, U, dtype, device):
    """Grouped-GEMM layout of one (pr, pc) key from its grouped entries
    (:func:`_group`): a list of ``(cols_idx [g, m], rows_idx [g*m],
    Wt [g, bc, br])`` per size class, ``m`` a power of two.  Padding
    entries read column 0 and write row ``-1`` (the spare row, remapped
    by the caller)."""
    counts = np.diff(bounds)
    cls = np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
    out = []
    for c in np.unique(cls[counts > 0]):
        members = np.flatnonzero((cls == c) & (counts > 0))
        m = 1 << int(c)
        cidx = np.zeros((len(members), m), np.int64)
        ridx = np.full((len(members), m), -1, np.int64)
        for k, u in enumerate(members):
            sl = slice(bounds[u], bounds[u + 1])
            cidx[k, :counts[u]] = cols_p[sl]
            ridx[k, :counts[u]] = rows_p[sl]
        Wt = np.ascontiguousarray(U[members].transpose(0, 2, 1))
        out.append((torch.as_tensor(cidx, device=device),
                    torch.as_tensor(ridx.reshape(-1), device=device),
                    torch.as_tensor(Wt, dtype=dtype, device=device)))
    return out


class DedupSpMV:
    """``apply(x) -> y`` over grouped unique blocks.

    ``prep[(pr, pc)]`` is ``("dedup", classes)`` (see
    :func:`_size_classes`) or ``("plain", rows, cols, W)`` for keys
    without enough repetition.  ``launches`` is the number of gather,
    GEMM and scatter calls one apply issues (counted from the layout).
    """

    def __init__(self, row_sizes: dict, prep: dict):
        self.row_sizes = dict(row_sizes)
        self.prep = prep
        self.targets = {}
        for (pr, pc), item in prep.items():
            spare = self.row_sizes[pr]
            if item[0] == "dedup":
                for _, ridx, _ in item[1]:
                    self.targets.setdefault(pr, []).append(
                        torch.where(ridx < 0, spare, ridx))
            else:
                self.targets.setdefault(pr, []).append(item[1])
        self.targets = {pr: torch.cat(v) for pr, v in self.targets.items()}
        n_gemm = sum(len(it[1]) if it[0] == "dedup" else 1
                     for it in prep.values())
        # per class or plain key: a gather and a bmm; per row bucket: a
        # zero fill, a concatenation and one index_add_
        self.launches = 2 * n_gemm + 3 * len(self.targets)

    def __call__(self, x: dict) -> dict:
        parts = {pr: [] for pr in self.targets}
        for (pr, pc), item in self.prep.items():
            if item[0] == "dedup":
                for cidx, _, Wt in item[1]:
                    parts[pr].append(torch.bmm(x[pc][cidx], Wt).reshape(
                        -1, Wt.shape[2]))
            else:
                _, _, cols, W = item
                parts[pr].append(torch.bmm(W, x[pc][cols].unsqueeze(-1))
                                 .squeeze(-1))
        y = {}
        for pr, idx in self.targets.items():
            c = torch.cat(parts[pr])
            acc = torch.zeros((self.row_sizes[pr] + 1, c.shape[1]),
                              dtype=c.dtype, device=c.device)
            y[pr] = acc.index_add_(0, idx, c)[:-1]
        return y


def _plain(rows, cols, W, dtype, device):
    as_i = lambda a: torch.as_tensor(np.asarray(a, np.int64),  # noqa: E731
                                     device=device)
    return ("plain", as_i(rows), as_i(cols),
            torch.as_tensor(W, dtype=dtype, device=device))


def dedup_spmv_operator(A, dtype=torch.float32, max_unique_frac: float = 0.25,
                        device=None):
    """``(apply, stats)`` for a BlockSparseMatrix ``A`` using the
    unique-block dictionary.  Keys whose unique-block count exceeds
    ``max_unique_frac`` of their nnz keep the plain per-entry SpMV."""
    device = dev.resolve(device)
    pattern = A.pattern
    values = {k: v.detach().cpu().numpy().astype(np.float64)
              for k, v in A.values.items()}
    prep = {}
    stats = {"n_unique": {}, "nnz": {}, "dedup": {}}
    for key, (rows_p, cols_p, bounds, U) in dedup_blocks(pattern,
                                                         values).items():
        nnz, nu = len(rows_p), len(U)
        use = nu <= max(1, int(max_unique_frac * nnz))
        stats["n_unique"][key], stats["nnz"][key] = nu, nnz
        stats["dedup"][key] = use
        prep[key] = (("dedup", _size_classes(rows_p, cols_p, bounds, U,
                                             dtype, device)) if use else
                     _plain(*pattern.entries[key], values[key], dtype,
                            device))
    return _finish(pattern, prep, stats)


def _finish(pattern, prep, stats):
    op = DedupSpMV(pattern.row_sizes, prep)
    stats["compression"] = (sum(stats["n_unique"].values())
                            / max(1, sum(stats["nnz"].values())))
    stats["launches"] = op.launches
    return op, stats


def dedup_spmv_from_plan(basis, penalty: float = 2.0,
                         dirichlet: bool = False, dtype=torch.float32,
                         plan=None, penalty_scaling: str = "measure",
                         dg_form="sipg", sigma1: float = 0.0,
                         max_unique_frac: float = 0.25, device=None):
    """Dedup SpMV operator WITHOUT ever assembling the matrix: the
    dedup runs on the coefficient rows of ``assemble_laplace(
    coef_parts=True)`` and only the UNIQUE blocks are multiplied out
    (host f64).  Peak host memory is O(nnz * K).  Returns
    ``(apply, stats)``."""
    from hpdg_tpu_torch.assemble.plan import build_plan
    from hpdg_tpu_torch.assemble.sipg import assemble_laplace
    device = dev.resolve(device)
    plan = plan or build_plan(basis)
    parts = assemble_laplace(
        basis, penalty=penalty, dirichlet=dirichlet, plan=plan,
        penalty_scaling=penalty_scaling, dg_form=dg_form, sigma1=sigma1,
        coef_parts=True, device="cpu")
    pattern = plan.pattern
    prep = {}
    stats = {"n_unique": {}, "nnz": {}, "dedup": {}}
    for (pr, pc), (coef, D) in parts.items():
        rows, cols = pattern.entries[(pr, pc)]
        nnz = len(rows)
        br = (pr + 1) ** basis.mesh.dim
        bc = (pc + 1) ** basis.mesh.dim
        if D.shape[0] == 0:  # bucket pair never touched: all-zero blocks
            uid = np.zeros(nnz, np.int64)
            U = np.zeros((1 if nnz else 0, br, bc))
        else:
            uid, reps = unique_rows(np.ascontiguousarray(coef))
            U = (coef[reps] @ D).reshape(-1, br, bc)
        nu = U.shape[0]
        use = nu <= max(1, int(max_unique_frac * nnz))
        stats["n_unique"][(pr, pc)], stats["nnz"][(pr, pc)] = nu, nnz
        stats["dedup"][(pr, pc)] = use
        prep[(pr, pc)] = (
            ("dedup", _size_classes(*_group(rows, cols, uid, nu), U, dtype,
                                    device)) if use else
            _plain(rows, cols, (coef @ D).reshape(nnz, br, bc), dtype,
                   device))
    return _finish(pattern, prep, stats)
