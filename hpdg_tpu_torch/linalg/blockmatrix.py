"""Degree-bucketed block-sparse matrices.

Port of ``hpdg_tpu.linalg.blockmatrix``: a sparse matrix whose (i, j)
entry is a dense (p_i+1)^d x (p_j+1)^d block, with the blocks of each
(row-degree, col-degree) pair in one dense ``[nnz, br, bc]`` tensor.
The pattern is host-side numpy; SpMV is a batched ``bmm`` plus an
``index_add_`` scatter.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


class BlockPattern:
    """Static sparsity pattern.

    entries[(pr, pc)] = (rows, cols): int32 arrays of *bucket positions*
    (row r is the r-th element of row-bucket pr, likewise cols).
    """

    def __init__(self, row_sizes: dict, col_sizes: dict, entries: dict):
        self.row_sizes = dict(row_sizes)  # p -> number of block rows in bucket
        self.col_sizes = dict(col_sizes)
        self.entries = {}
        self._slot_index_cache = {}
        for key, (rows, cols) in entries.items():
            rows = np.asarray(rows, dtype=np.int32)
            cols = np.asarray(cols, dtype=np.int32)
            self.entries[key] = (rows, cols)

    def _slot_index(self, key):
        if key not in self._slot_index_cache:
            rows, cols = self.entries[key]
            self._slot_index_cache[key] = {
                (int(r), int(c)): s for s, (r, c) in enumerate(zip(rows, cols))
            }
        return self._slot_index_cache[key]


@dataclass
class BlockSparseMatrix:
    pattern: BlockPattern
    dim: int  # spatial dimension (block size = (p+1)^dim)
    values: dict  # (pr, pc) -> Tensor [nnz, (pr+1)^dim, (pc+1)^dim]
    # (key, device) -> (rows, cols) as int64 tensors on that device
    _index: dict = field(default_factory=dict, repr=False, compare=False)

    def index(self, key, device):
        if (key, device) not in self._index:
            rows, cols = self.pattern.entries[key]
            self._index[(key, device)] = (
                torch.as_tensor(rows, dtype=torch.int64, device=device),
                torch.as_tensor(cols, dtype=torch.int64, device=device))
        return self._index[(key, device)]


def matvec(A: BlockSparseMatrix, x: dict) -> dict:
    """y = A x for bucketed block vectors."""
    out = {}
    for (pr, pc) in A.pattern.entries:
        vals = A.values[(pr, pc)]
        rows, cols = A.index((pr, pc), vals.device)
        contrib = torch.bmm(vals, x[pc][cols].unsqueeze(-1)).squeeze(-1)
        y = torch.zeros((A.pattern.row_sizes[pr], vals.shape[1]),
                        dtype=vals.dtype, device=vals.device)
        # several blocks of a row land on the same output row: index_add_
        # sums them (the reference's segment_sum)
        y.index_add_(0, rows, contrib)
        out[pr] = out[pr] + y if pr in out else y
    return out


def diag_slots(pattern: BlockPattern) -> dict:
    """For a square pattern: p -> int32 array s.t. slot of block (r, r)
    of bucket (p, p) is out[p][r].  The plan's diag-first layout (slot
    of (r, r) == r) is detected; other layouts are looked up."""
    out = {}
    for p, n in pattern.row_sizes.items():
        rows, cols = pattern.entries[(p, p)]
        rng = np.arange(n, dtype=np.int32)
        if (len(rows) >= n and np.array_equal(rows[:n], rng)
                and np.array_equal(cols[:n], rng)):
            out[p] = rng
        else:
            ix = pattern._slot_index((p, p))
            out[p] = np.array([ix[(r, r)] for r in range(n)], np.int32)
    return out


def extract_diagonal(A: BlockSparseMatrix) -> dict:
    """p -> [n_p, br, br] diagonal blocks (for block-Jacobi smoothers)."""
    out = {}
    for p, slots in diag_slots(A.pattern).items():
        vals = A.values[(p, p)]
        out[p] = vals[torch.as_tensor(slots, dtype=torch.int64,
                                      device=vals.device)]
    return out


def to_dense(A: BlockSparseMatrix, basis_row, basis_col=None) -> np.ndarray:
    """Flat dense matrix in element order (host numpy, float64)."""
    basis_col = basis_col or basis_row
    M = np.zeros((basis_row.ndof, basis_col.ndof))
    for (pr, pc), (rows, cols) in A.pattern.entries.items():
        vals = A.values[(pr, pc)].detach().cpu().numpy()
        ro = basis_row.offsets[basis_row.bucket_elems[pr][rows]]
        co = basis_col.offsets[basis_col.bucket_elems[pc][cols]]
        br, bc = vals.shape[1], vals.shape[2]
        for k in range(len(rows)):
            M[ro[k]:ro[k] + br, co[k]:co[k] + bc] += vals[k]
    return M
