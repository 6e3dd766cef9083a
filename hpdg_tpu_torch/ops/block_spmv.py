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
equal.  Rows of at most 64 bytes take its narrow kernel (one lane group
of 1 to 16 lanes per matrix row, x read from L2), wider rows its wide
kernel (x staged in shared memory; a block row split over several
thread blocks where the bucket has few of them).  :func:`layout` mirrors
the launch geometry and :func:`coverage` checks that it sums every row
once; :func:`emulate` repeats the kernel's summation order in numpy,
which its f32 output equals bit for bit.

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
# the widest block the kernel takes: one block's x (48 KB of f64) fits
# its shared memory; rows wider than a lane group's loads are summed over
# column tiles (3D elasticity at p = 5 builds 648, at p = 7 1536)
MAX_BLOCK = 6144
DTYPES = {torch.float32: 0, torch.float64: 1}

# the kernel's launch constants (csrc/block_spmv.cu)
SMEM_BYTES = 48 * 1024
CTA_THREADS = 256
NARROW_THREADS = 128
NARROW_BYTES = 64
CTAS_PER_SM = 2
# the wide kernel's (GW, CPL, TILED) instantiations, in the source's order
SHAPES = ((8, 1, 0), (16, 1, 0), (32, 1, 0), (32, 2, 0), (32, 3, 0),
          (32, 4, 0), (32, 8, 0), (32, 12, 0), (32, 12, 1))
# hpdg_block_spmv_layout's fields, in order
LAYOUT_FIELDS = ("narrow", "vec", "gw", "shape", "nwr", "rows_per_cta",
                 "threads", "chunk", "smem", "passes", "pp", "slices",
                 "grid")

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
    lib.hpdg_block_spmv.argtypes = [cint] + [ptr] * 6 + [cint] * 6 + [ptr]
    lib.hpdg_block_spmv.restype = cint
    lib.hpdg_block_spmv_layout.argtypes = [cint] * 7 + [ptr]
    lib.hpdg_block_spmv_layout.restype = cint
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


def rows_per_group(cpl: int) -> int:
    """Rows a wide-kernel lane group carries per pass."""
    return 1 if cpl >= 8 else 2 if cpl >= 4 else 4


def layout(dtype: torch.dtype, br: int, bc: int, aligned: bool,
           n_rows: int, max_row_nnz: int, sms: int) -> dict:
    """The kernel's launch geometry for one bucket (``make_layout`` in
    ``csrc/block_spmv.cu``, field by field: :data:`LAYOUT_FIELDS`), on a
    card of ``sms`` SMs; ``aligned``: the values are 16-byte aligned.

    Rows of at most :data:`NARROW_BYTES` take the narrow kernel: a group
    of ``gw`` lanes (the row's load units rounded up to a power of two)
    per (block row, matrix row), ``grid`` thread blocks of
    :data:`NARROW_THREADS`.  Wider rows take the wide kernel's
    instantiation ``shape``: ``nwr`` warps per block row,
    ``rows_per_cta`` block rows per thread block, ``passes`` passes of
    its groups over a block row's matrix rows, ``pp`` of them in each of
    ``slices`` thread blocks per block row (one slice unless the bucket
    has fewer thread blocks than :data:`CTAS_PER_SM` per SM)."""
    check(dtype, br, bc)
    size = 4 if dtype == torch.float32 else 8
    wide = 16 // size
    vec = int(bool(aligned) and bc % wide == 0)
    units = -(-bc // wide) if vec else bc
    L = dict.fromkeys(LAYOUT_FIELDS, 0)
    L.update(vec=vec, slices=1)
    if bc * size <= NARROW_BYTES:
        gw = 1
        while gw < units:
            gw *= 2
        L.update(narrow=1, gw=gw, shape=-1, threads=NARROW_THREADS,
                 grid=-(-n_rows * br * gw // NARROW_THREADS))
        return L
    gw = 8 if units <= 8 else 16 if units <= 16 else 32
    need = -(-units // gw)
    shape = next((s for s, (g, c, t) in enumerate(SHAPES[:-1])
                  if g == gw and c >= need), len(SHAPES) - 1)
    rpg = rows_per_group(SHAPES[shape][1])
    per_warp = (32 // gw) * rpg
    nwr = min(CTA_THREADS // 32, max(1, -(-br // per_warp)))
    rows_per_cta = CTA_THREADS // 32 if nwr == 1 else 1
    fit = SMEM_BYTES // (rows_per_cta * bc * size)
    chunk = max(1, min(max(1, max_row_nnz), fit))
    groups = nwr * (32 // gw)
    passes = -(-(-(-br // groups)) // rpg)
    pp, slices = passes, 1
    ctas = -(-n_rows // rows_per_cta)
    if rows_per_cta == 1 and 0 < ctas < CTAS_PER_SM * sms:
        want = min(passes, -(-CTAS_PER_SM * sms // ctas))
        pp = max(1, passes // want)
        slices = -(-passes // pp)
    L.update(gw=gw, shape=shape, nwr=nwr, rows_per_cta=rows_per_cta,
             threads=32 * nwr * rows_per_cta, chunk=chunk,
             smem=rows_per_cta * chunk * bc * size, passes=passes, pp=pp,
             slices=slices, grid=ctas * slices)
    return L


def coverage(L: dict, n_rows: int, br: int) -> np.ndarray:
    """How many times the launch of geometry ``L`` writes each output row:
    ``[n_rows, br]`` counts (every entry 1 for a sound geometry), from
    the thread indices as the kernel maps them."""
    count = np.zeros(n_rows * br, dtype=np.int64)
    t = np.arange(L["grid"] * L["threads"], dtype=np.int64)
    cta, tid = t // L["threads"], t % L["threads"]
    gw = L["gw"]
    if L["narrow"]:
        gid = t // gw
        keep = (tid % gw == 0) & (gid // br < n_rows)
        count += np.bincount(gid[keep], minlength=n_rows * br)
        return count.reshape(n_rows, br)
    nwr, slices = L["nwr"], L["slices"]
    warp, lane = tid // 32, tid % 32
    rb, wr = warp // nwr, warp % nwr
    row = (cta // slices) * (L["threads"] // (32 * nwr)) + rb
    slice_ = cta % slices
    groups = nwr * (32 // gw)
    g, gl = wr * (32 // gw) + lane // gw, lane % gw
    rpg = rows_per_group(SHAPES[L["shape"]][1])
    for k in range(L["pp"]):
        p = slice_ * L["pp"] + k
        for q in range(rpg):
            i = g + groups * (p * rpg + q)
            keep = ((row < n_rows) & (gl == 0) & (i < br)
                    & (p < L["passes"]))
            count += np.bincount(row[keep] * br + i[keep],
                                 minlength=n_rows * br)
    return count.reshape(n_rows, br)


def lanes(dtype: torch.dtype, bc: int, aligned: bool) -> tuple:
    """``(W, GW, CPL, TILE)`` of a row of ``bc`` columns: lane ``l`` of
    its group adds the columns ``t0 + W (l + GW c) + w`` (tiles ``t0`` of
    ``TILE`` columns, then ``c < CPL``, then ``w < W``); ``GW`` is the
    kernel's group width (narrow or wide), ``TILE`` is ``bc`` where the
    row is one tile."""
    L = layout(dtype, 1, bc, aligned, 1, 1, 1)
    W = 16 // (4 if dtype == torch.float32 else 8) if L["vec"] else 1
    if L["narrow"]:
        return W, L["gw"], 1, bc
    gw, cpl, tiled = SHAPES[L["shape"]]
    return W, gw, cpl, W * gw * cpl if tiled else bc


def emulate(vals: np.ndarray, x: np.ndarray, row_ptr: np.ndarray,
            slot: np.ndarray, col: np.ndarray, aligned: bool,
            y: np.ndarray | None = None, gw: int | None = None,
            rounded: bool = True) -> np.ndarray:
    """The kernel's sums of one bucket in numpy: each lane's f64 sum of
    its columns' products (blocks in slot order, then tiles, ``c`` and
    ``w``: :func:`lanes`), the group's XOR shuffle tree, then ``y +``
    (with ``y``, the kernel's ``accumulate``) and the rounding to the
    values' type (unless not ``rounded``: the f64 sums).  For f32 values
    each product is exact in f64, as in the kernel's FMAs, so its output
    equals this bit for bit; for f64 the kernel fuses each product into
    its sum and this rounds it first.  ``gw`` replaces the group width
    with a wider power of two (lanes past the row add zeros)."""
    _, br, bc = vals.shape
    n_rows = len(row_ptr) - 1
    dtype = torch.float32 if vals.dtype == np.float32 else torch.float64
    W, GW, CPL, TILE = lanes(dtype, bc, aligned)
    GW = gw or GW
    acc = np.zeros((n_rows, br, GW))
    counts = np.diff(row_ptr)
    for k in range(int(counts.max(initial=0))):
        live = np.flatnonzero(counts > k)
        at = row_ptr[live] + k
        A = vals[slot[at]].astype(np.float64)
        X = x[col[at]].astype(np.float64)
        sub = acc[live]
        for t0 in range(0, bc, TILE):
            for c in range(CPL):
                for w in range(W):
                    J = t0 + W * (np.arange(GW) + GW * c) + w
                    on = np.flatnonzero(J < bc)
                    if len(on):
                        sub[:, :, on] += A[:, :, J[on]] * X[:, None, J[on]]
        acc[live] = sub
    off = GW // 2
    while off:
        acc = acc + acc[:, :, np.arange(GW) ^ off]
        off //= 2
    out = acc[:, :, 0]
    if y is not None:
        out = np.asarray(y, dtype=np.float64) + out
    return out.astype(vals.dtype) if rounded else out


def emulate_matvec(A, x: dict, rounded: bool = True) -> dict:
    """:func:`emulate` over the buckets of ``A`` (a ``BlockSparseMatrix``)
    in ``matvec``'s order, later buckets of a row bucket adding into its
    y; host numpy arrays.  The alignment of each bucket is its values'
    own, so ``A`` and ``x`` are those the kernel is (or would be) given,
    on any device."""
    out = {}
    for key in A.pattern.entries:
        pr, pc = key
        v = A.values[key]
        t = A.spmv_table(key, torch.device("cpu"))
        out[pr] = emulate(v.detach().cpu().numpy(),
                          x[pc].detach().cpu().numpy(), t["row_ptr"].numpy(),
                          t["slot"].numpy(), t["col"].numpy(),
                          v.data_ptr() % 16 == 0, out.get(pr),
                          rounded=rounded)
    return out


def card_layout(dtype: torch.dtype, br: int, bc: int, aligned: bool,
                n_rows: int, max_row_nnz: int, sms: int) -> dict:
    """The geometry the built kernel reports (``hpdg_block_spmv_layout``);
    builds it, so needs ``nvcc``."""
    check(dtype, br, bc)
    out = (ctypes.c_int * len(LAYOUT_FIELDS))()
    rc = build().hpdg_block_spmv_layout(DTYPES[dtype], br, bc, int(aligned),
                                        n_rows, max_row_nnz, sms, out)
    if rc != 0:
        raise ValueError(f"block SpMV kernel: no layout for {br} x {bc}")
    return dict(zip(LAYOUT_FIELDS, out))


_sms = {}  # device index -> SM count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (the launch geometry splits wide
    block rows by it)."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


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
            accumulate, sm_count(vals.device),
            torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block SpMV kernel launch failed: CUDA error "
                           f"{rc} ({br} x {bc}, {vals.dtype})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return y
