"""K2: the block-sparse matrix-vector product as a CUDA kernel.

``y[r] (+)= sum_{s in row r} vals[s] @ x[cols[s]]`` for one ``(pr, pc)``
bucket of a :class:`hpdg_tpu_torch.linalg.blockmatrix.BlockSparseMatrix`.
It replaces no TPU kernel: the reference computes the product in XLA
(``einsum`` and ``segment_sum``), the port's plain version
(:func:`plain`) as a gather, a batched ``bmm``, a zero fill and an
``index_add_``.  The kernel (``csrc/block_spmv.cu``) reads each block
once, in the pattern's slot order, through a row-sorted table that the
host builds once per pattern (:func:`row_table`), and keeps each output
row's sum in registers: no atomics, and repeated applies are bitwise
equal.

It is built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`hpdg_tpu_torch.ops.nvcc`) and bound with ctypes.  :func:`launch`
takes CUDA tensors only and raises on anything the kernel does not
take; CPU tensors go to :func:`plain`, there is no fallback between the
two.  ``launches`` counts eager launches, ``captured`` launches recorded
into a CUDA graph under capture (they run on every replay).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hpdg_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "block_spmv.cu"
MAX_BLOCK = 375  # 3 (p+1)^3 at p = 4: the largest block the port builds
DTYPES = {torch.float32: 0, torch.float64: 1}

launches = 0
captured = 0
_lib = None  # the loaded shared library (one per process)


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source content), load it and load
    every instantiation, so that none loads first under a CUDA graph
    capture."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.load(SOURCE)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.hpdg_block_spmv.argtypes = [cint] + [ptr] * 6 + [cint] * 5 + [ptr]
    lib.hpdg_block_spmv.restype = cint
    lib.hpdg_block_spmv_prepare.argtypes = []
    lib.hpdg_block_spmv_prepare.restype = cint
    rc = lib.hpdg_block_spmv_prepare()
    if rc != 0:
        raise RuntimeError(f"block SpMV kernel: loading its instantiations "
                           f"failed: CUDA error {rc}")
    _lib = lib
    return lib


def check(dtype: torch.dtype, br: int, bc: int):
    """Raises where the kernel does not take the dtype or block shape."""
    if dtype not in DTYPES:
        raise TypeError(f"block SpMV kernel takes float32 or float64, "
                        f"got {dtype}")
    if not (1 <= br <= MAX_BLOCK and 1 <= bc <= MAX_BLOCK):
        raise ValueError(f"block SpMV kernel takes blocks of 1 to "
                         f"{MAX_BLOCK} rows and columns, got {br} x {bc}")


def row_table(rows: np.ndarray, n_rows: int) -> tuple:
    """``(row_ptr [n_rows + 1], slot [nnz])`` int32: the bucket's slots in
    stable order by block row, so that block row r's blocks are
    ``slot[row_ptr[r]:row_ptr[r + 1]]``, in increasing slot order."""
    rows = np.asarray(rows, dtype=np.int64)
    slot = np.argsort(rows, kind="stable").astype(np.int32)
    counts = np.bincount(rows, minlength=n_rows)
    if len(counts) > n_rows:
        raise ValueError("a block's row lies outside the row bucket")
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return row_ptr, slot


def plain(vals: torch.Tensor, x: torch.Tensor, rows: torch.Tensor,
          cols: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The plain version, ``A x`` of one bucket on any device: gather,
    batched GEMV, zero fill and ``index_add_`` (the reference's
    ``segment_sum``: several blocks of a row land on one output row)."""
    contrib = torch.bmm(vals, x[cols].unsqueeze(-1)).squeeze(-1)
    y = torch.zeros((n_rows, vals.shape[1]), dtype=vals.dtype,
                    device=vals.device)
    return y.index_add_(0, rows, contrib)


def launch(vals: torch.Tensor, x: torch.Tensor, table: dict,
           y: torch.Tensor | None = None) -> torch.Tensor:
    """Run the kernel on CUDA tensors: ``vals [nnz, br, bc]`` (contiguous),
    ``x [n_cols, bc]`` of the same dtype and device, ``table`` a
    :func:`row_table` on that device (``row_ptr``, ``slot``, ``col`` =
    cols[slot] int32 tensors and the host int ``max_row_nnz``).  Returns
    a new ``y [n_rows, br]``, or adds into the given ``y``."""
    global launches, captured
    if vals.device.type != "cuda":
        raise ValueError(f"block SpMV kernel: tensor on {vals.device}, "
                         f"not on a CUDA device")
    nnz, br, bc = vals.shape
    check(vals.dtype, br, bc)
    n_rows = table["row_ptr"].shape[0] - 1
    if (x.dtype != vals.dtype or x.device != vals.device
            or table["slot"].device != vals.device):
        raise ValueError("block SpMV kernel: values, x and the row table "
                         "must share dtype and device")
    if x.dim() != 2 or x.shape[1] != bc or table["slot"].shape[0] != nnz:
        raise ValueError(f"block SpMV kernel: x {tuple(x.shape)} and "
                         f"{table['slot'].shape[0]} table slots do not fit "
                         f"values {tuple(vals.shape)}")
    if not vals.is_contiguous():
        raise ValueError("block SpMV kernel takes contiguous values")
    x = x.contiguous()
    if y is None:
        y, accumulate = torch.empty((n_rows, br), dtype=vals.dtype,
                                    device=vals.device), 0
    else:
        if (tuple(y.shape) != (n_rows, br) or y.dtype != vals.dtype
                or not y.is_contiguous()):
            raise ValueError("block SpMV kernel: y does not fit the bucket")
        accumulate = 1
    if n_rows == 0:
        return y
    lib = build()
    with torch.cuda.device(vals.device):
        rc = lib.hpdg_block_spmv(
            DTYPES[vals.dtype], vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            table["row_ptr"].data_ptr(), table["slot"].data_ptr(),
            table["col"].data_ptr(), n_rows, br, bc, table["max_row_nnz"],
            accumulate, torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block SpMV kernel launch failed: CUDA error "
                           f"{rc} ({br} x {bc}, {vals.dtype})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return y
