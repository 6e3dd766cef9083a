"""Degree-bucketed block-sparse matrices.

Port of ``hpdg_tpu.linalg.blockmatrix``: a sparse matrix whose (i, j)
entry is a dense block of ``ncomp (p_i+1)^d x ncomp (p_j+1)^d`` values,
with the blocks of each (row-degree, col-degree) pair in one dense
``[nnz, br, bc]`` tensor.  ``block_shape = (ncomp_row, ncomp_col)`` is
``(1, 1)`` for scalar problems and ``(d, d)`` for elasticity (dofs
component-major inside a block).  The pattern is host-side numpy.
SpMV (:func:`matvec`) on the card is K2, the hand-written kernel of
:mod:`hpdg_tpu_torch.ops.block_spmv`, one launch per bucket through a
row-sorted table built once per pattern and device
(:meth:`BlockSparseMatrix.spmv_table`); on the CPU it is the kernel's
plain version, a batched ``bmm`` plus an ``index_add_`` scatter.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.ops import block_spmv


class BlockPattern:
    """Static sparsity pattern.

    entries[(pr, pc)] = (rows, cols): int32 arrays of *bucket positions*
    (row r is the r-th element of row-bucket pr, likewise cols).
    ``diag_first``: bucket (p, p) stores its diagonal blocks at slots
    0..n-1 in row order (the layout of ``assemble.plan.build_plan`` and
    of the Galerkin coarse patterns).
    """

    def __init__(self, row_sizes: dict, col_sizes: dict, entries: dict,
                 diag_first: bool = True):
        self.row_sizes = dict(row_sizes)  # p -> number of block rows in bucket
        self.col_sizes = dict(col_sizes)
        self.diag_first = diag_first
        self.entries = {}
        self._slot_index_cache = {}
        self._sorted_codes = {}
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

    def lookup(self, pr: int, pc: int, rows, cols) -> np.ndarray:
        """Slots of the blocks (rows[i], cols[i]) of bucket (pr, pc), -1
        where the pattern has no such block (vectorized: one sort of the
        entry codes per bucket, then ``searchsorted``)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if (pr, pc) not in self.entries or self.nnz(pr, pc) == 0:
            return np.full(rows.shape, -1, dtype=np.int64)
        ncol = self.col_sizes[pc]
        if (pr, pc) not in self._sorted_codes:
            er, ec = self.entries[(pr, pc)]
            codes = er.astype(np.int64) * ncol + ec
            order = np.argsort(codes, kind="stable")
            self._sorted_codes[(pr, pc)] = (codes[order], order)
        sc, order = self._sorted_codes[(pr, pc)]
        want = rows * ncol + cols
        at = np.minimum(np.searchsorted(sc, want), len(sc) - 1)
        return np.where(sc[at] == want, order[at], -1)

    def slot(self, pr: int, pc: int, row: int, col: int) -> int:
        return self._slot_index((pr, pc))[(row, col)]

    def slots(self, pr: int, pc: int, rows, cols) -> np.ndarray:
        """Slots of existing blocks (KeyError if one is absent)."""
        if pr == pc and self.diag_first and np.array_equal(rows, cols):
            return np.asarray(rows, dtype=np.int32)
        s = self.lookup(pr, pc, rows, cols)
        if (s < 0).any():
            i = int(np.flatnonzero(s < 0)[0])
            raise KeyError((int(np.asarray(rows)[i]), int(np.asarray(cols)[i])))
        return s.astype(np.int32)

    def nnz(self, pr: int, pc: int) -> int:
        return len(self.entries[(pr, pc)][0])


@dataclass
class BlockSparseMatrix:
    pattern: BlockPattern
    dim: int  # spatial dimension (block size = ncomp (p+1)^dim)
    values: dict  # (pr, pc) -> Tensor [nnz, br(pr), bc(pc)]
    block_shape: tuple = (1, 1)  # per-dof components (rows, cols)
    # (key, device) -> (rows, cols) as int64 tensors on that device
    _index: dict = field(default_factory=dict, repr=False, compare=False)
    # (key, device) -> K2's row-sorted table on that device
    _spmv: dict = field(default_factory=dict, repr=False, compare=False)

    def br(self, p: int) -> int:
        return (p + 1) ** self.dim * self.block_shape[0]

    def bc(self, p: int) -> int:
        return (p + 1) ** self.dim * self.block_shape[1]

    def index(self, key, device):
        if (key, device) not in self._index:
            rows, cols = self.pattern.entries[key]
            self._index[(key, device)] = (
                torch.as_tensor(rows, dtype=torch.int64, device=device),
                torch.as_tensor(cols, dtype=torch.int64, device=device))
        return self._index[(key, device)]

    def spmv_table(self, key, device) -> dict:
        """K2's table of bucket ``key``: ``row_ptr``, ``slot`` and ``col``
        (the blocks' columns in slot order) as int32 tensors on
        ``device``, and the most blocks of one row.  The values keep
        their slot order: the kernel reads them through ``slot``."""
        if (key, device) not in self._spmv:
            rows, cols = self.pattern.entries[key]
            row_ptr, slot = block_spmv.row_table(
                rows, self.pattern.row_sizes[key[0]])
            i32 = lambda a: torch.as_tensor(  # noqa: E731
                a, dtype=torch.int32, device=device)
            self._spmv[(key, device)] = dict(
                row_ptr=i32(row_ptr), slot=i32(slot), col=i32(cols[slot]),
                max_row_nnz=int(np.diff(row_ptr).max(initial=0)))
        return self._spmv[(key, device)]


def zeros_values(pattern: BlockPattern, dim: int, block_shape=(1, 1),
                 dtype=torch.float64, device=None) -> dict:
    device = dev.resolve(device)
    vals = {}
    for (pr, pc), (rows, _) in pattern.entries.items():
        br = (pr + 1) ** dim * block_shape[0]
        bc = (pc + 1) ** dim * block_shape[1]
        vals[(pr, pc)] = torch.zeros((len(rows), br, bc), dtype=dtype,
                                     device=device)
    return vals


def matvec(A: BlockSparseMatrix, x: dict) -> dict:
    """y = A x for bucketed block vectors: K2 on CUDA tensors (one launch
    per bucket, later buckets of a row bucket adding into its y),
    :func:`plain_matvec` on CPU tensors."""
    if not any(v.device.type == "cuda" for v in A.values.values()):
        return plain_matvec(A, x)
    out = {}
    for (pr, pc) in A.pattern.entries:
        vals = A.values[(pr, pc)]
        out[pr] = block_spmv.launch(
            vals, x[pc], A.spmv_table((pr, pc), vals.device), out.get(pr))
    return out


def plain_matvec(A: BlockSparseMatrix, x: dict) -> dict:
    """K2's plain version on any device: per bucket a gather, a batched
    ``bmm``, a zero fill and an ``index_add_`` (the port's route on the
    card before K2)."""
    out = {}
    for (pr, pc) in A.pattern.entries:
        vals = A.values[(pr, pc)]
        rows, cols = A.index((pr, pc), vals.device)
        y = block_spmv.plain(vals, x[pc], rows, cols,
                             A.pattern.row_sizes[pr])
        out[pr] = out[pr] + y if pr in out else y
    return out


def matvec_t(A: BlockSparseMatrix, x: dict) -> dict:
    """y = A^T x (the restriction direction of transfer operators)."""
    out = {}
    for (pr, pc) in A.pattern.entries:
        vals = A.values[(pr, pc)]
        rows, cols = A.index((pr, pc), vals.device)
        contrib = torch.bmm(x[pr][rows].unsqueeze(1), vals).squeeze(1)
        y = torch.zeros((A.pattern.col_sizes[pc], vals.shape[2]),
                        dtype=vals.dtype, device=vals.device)
        y.index_add_(0, cols, contrib)
        out[pc] = out[pc] + y if pc in out else y
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
            s = pattern.lookup(p, p, rng, rng)
            if (s < 0).any():
                raise KeyError(f"bucket ({p}, {p}) lacks a diagonal block")
            out[p] = s.astype(np.int32)
    return out


def extract_diagonal(A: BlockSparseMatrix) -> dict:
    """p -> [n_p, br, br] diagonal blocks (``br`` includes the
    components of vector-valued blocks)."""
    out = {}
    for p, slots in diag_slots(A.pattern).items():
        vals = A.values[(p, p)]
        out[p] = vals[torch.as_tensor(slots, dtype=torch.int64,
                                      device=vals.device)]
    return out


def to_dense(A: BlockSparseMatrix, basis_row, basis_col=None) -> np.ndarray:
    """Flat dense matrix in element order (host numpy, float64); dof
    ``ncomp * offset + i`` of an element, as ``blockvector.to_flat``."""
    basis_col = basis_col or basis_row
    cr, cc = A.block_shape
    M = np.zeros((basis_row.ndof * cr, basis_col.ndof * cc))
    for (pr, pc), (rows, cols) in A.pattern.entries.items():
        vals = A.values[(pr, pc)].detach().cpu().numpy()
        ro = basis_row.offsets[basis_row.bucket_elems[pr][rows]] * cr
        co = basis_col.offsets[basis_col.bucket_elems[pc][cols]] * cc
        br, bc = vals.shape[1], vals.shape[2]
        for k in range(len(rows)):
            M[ro[k]:ro[k] + br, co[k]:co[k] + bc] += vals[k]
    return M


def add_scaled(A: BlockSparseMatrix, B: BlockSparseMatrix, beta
               ) -> BlockSparseMatrix:
    """A + beta * B for matrices with structurally identical patterns
    (same plan, or the same cached Galerkin construction)."""
    vals = {k: A.values[k] + beta * B.values[k] for k in A.values}
    return BlockSparseMatrix(A.pattern, A.dim, vals, A.block_shape)
