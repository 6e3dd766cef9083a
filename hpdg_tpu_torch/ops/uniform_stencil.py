"""K1: the fused uniform-lattice SIPG stencil apply as a CUDA kernel.

Replaces ``hpdg_tpu.ops.pallas_uniform.pallas_uniform_sipg_operator``.
The kernel (``csrc/uniform_stencil.cu``) computes what the plain twin
``matrixfree.uniform.uniform_sipg_operator`` computes, from the same
host-built f64 matrices cast to f32:

    y[e] = Tdiag[vid[e]] u[e] + sum_ax ( has_p M12_ax u[e+s_ax] + has_m M21_ax u[e-s_ax] )

A tile of elements of one diagonal variant is one GEMM whose K stacks
the variant's products (:func:`kernel_plan` builds the tiles and the
product lists on the host).  The block size picks the instantiation
(:func:`kernel_layout`): a register-tiled GEMM for bs = 125 and for every
other bs <= 128, a one-thread-per-element kernel for bs = 27 and 8.

It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``hpdg_tpu_torch/_build/`` (keyed by the source's hash) and bound with
ctypes.  :class:`UniformStencilOperator` runs the plain twin for CPU
tensors and the kernel for CUDA tensors; there is no fallback between
the two.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.matrixfree.uniform import (StencilTables, _lattice_shape,
                                               stencil_tables,
                                               uniform_sipg_operator)
from hpdg_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "uniform_stencil.cu"

# mirror the CUDA source (checked against it at load)
INSTANTIATIONS = ("gemm125", "small27", "small8", "generic")
MAX_PRODUCTS = 7  # 1 + 2 dim
_GEMM_TILE, _GEMM_KC, _GEMM_N = 128, 32, 128
_SMALL_TILE = 128

_lib = None  # the loaded shared library (one per process)


def kernel_layout(bs: int) -> tuple:
    """``(instantiation, tile elements, K, N)`` for block size ``bs``:
    each stored matrix is ``[K, N]``, zero-padded from ``[bs, bs]``.
    Raises ValueError where the kernel does not take ``bs``."""
    if not 1 <= bs <= _GEMM_N:
        raise ValueError(f"uniform stencil kernel: block size {bs} is not "
                         f"in 1..{_GEMM_N}")
    if bs in (27, 8):
        return f"small{bs}", _SMALL_TILE, bs, -(-bs // 4) * 4
    return ("gemm125" if bs == 125 else "generic", _GEMM_TILE,
            -(-bs // _GEMM_KC) * _GEMM_KC, _GEMM_N)


def tile_order(products: int, count: int) -> tuple:
    """Launch-order key of a tile of ``count`` elements.

    The GEMM instantiations' persistent grid of G resident blocks takes
    tiles round-robin (block b: b, b + G, ...).  A short tile (one warp
    row, 32 elements or fewer) ends soon whatever its products, so short
    tiles go first, and the tiles past the first round land on the
    blocks that drew them; the rest run in falling order of cost,
    products x 32-element warp rows.
    """
    return count > 32, -products * -(-count // 32)


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source content) and load it
    (:func:`hpdg_tpu_torch.ops.nvcc.load`)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.load(SOURCE)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.hpdg_uniform_stencil_f32.argtypes = [ptr] * 8 + [cint] * 5 + [ptr]
    lib.hpdg_uniform_stencil_f32.restype = cint
    lib.hpdg_uniform_stencil_layout.argtypes = [cint,
                                                ctypes.POINTER(cint)]
    lib.hpdg_uniform_stencil_layout.restype = cint
    lib.hpdg_uniform_stencil_occupancy.argtypes = [cint]
    lib.hpdg_uniform_stencil_occupancy.restype = cint
    out = (cint * 4)()
    for bs in (125, 27, 8, 64, 25, 1, 128):
        kind, tile, k, n = kernel_layout(bs)
        if (lib.hpdg_uniform_stencil_layout(bs, out) != 0
                or tuple(out) != (INSTANTIATIONS.index(kind), tile, k, n)):
            raise RuntimeError("kernel layout of the CUDA source and of "
                               "ops.uniform_stencil disagree")
    _lib = lib
    return lib


def occupancy(bs: int) -> int:
    """Resident blocks per SM of the instantiation that takes block size
    ``bs``, on the current CUDA device."""
    blocks = build().hpdg_uniform_stencil_occupancy(bs)
    if blocks < 1:
        raise RuntimeError(f"uniform stencil kernel: no occupancy for "
                           f"block size {bs}")
    return blocks


@dataclass(frozen=True)
class KernelPlan:
    """Host-side launch tables of the kernel (numpy)."""

    instantiation: str  # one of INSTANTIATIONS
    tile: int  # elements per tile
    k: int  # rows of each stored matrix (bs padded)
    n: int  # columns of each stored matrix (bs padded)
    strides: tuple  # element stride of each lattice axis
    prod_mat: np.ndarray  # (nvar, 7) int32: stored matrix of each product
    prod_shift: np.ndarray  # (nvar, 7) int32: element shift of its rows
    prod_count: np.ndarray  # (nvar,) int32: products of each variant
    elems: np.ndarray  # (n,) int32 element ids grouped by variant
    tiles: np.ndarray  # (ntiles, 3) int32 (variant, start, count)


def kernel_plan(basis: DGBasis, st: StencilTables) -> KernelPlan:
    """Tiles and per-variant product lists; raises ValueError where the
    kernel's addressing (C-lattice order, neighbours at +-stride) or its
    block sizes do not hold.

    Stored matrix ``k < nvar`` is variant k's Tdiag, ``nvar + 2 ax`` is
    M12_ax and ``nvar + 2 ax + 1`` is M21_ax.  A variant's products are its
    Tdiag (shift 0), then per axis the +ax (shift +s_ax) and -ax (shift
    -s_ax) couplings that exist.  Launch order (:func:`tile_order`): the
    short tiles first, then the others in falling order of cost.
    """
    if st.dim not in (2, 3):
        raise ValueError("uniform stencil kernel: 2D/3D only")
    kind, tile, k, n = kernel_layout(st.bs)
    cells = _lattice_shape(basis.mesh)  # raises unless C-lattice order
    dim = st.dim
    strides = tuple(int(np.prod(cells[a + 1:])) for a in range(dim))
    ar = np.arange(basis.mesh.n_elements)
    for ax in range(dim):
        hp, hm = st.has_p[ax], st.has_m[ax]
        if not (np.array_equal(st.nbr_p[ax][hp], ar[hp] + strides[ax])
                and np.array_equal(st.nbr_m[ax][hm], ar[hm] - strides[ax])):
            raise ValueError("uniform stencil kernel: neighbours are not "
                             "at the lattice strides")
    nvar = len(st.variants)
    prod_mat = np.zeros((nvar, MAX_PRODUCTS), np.int32)
    prod_shift = np.zeros((nvar, MAX_PRODUCTS), np.int32)
    prod_count = np.zeros(nvar, np.int32)
    for v, code in enumerate(st.variants):
        prods = [(v, 0)]
        for ax in range(dim):  # code: per axis, slowest first, 2 has_p + has_m
            bits = (int(code) >> (2 * (dim - 1 - ax))) & 3
            if bits & 2:
                prods.append((nvar + 2 * ax, strides[ax]))
            if bits & 1:
                prods.append((nvar + 2 * ax + 1, -strides[ax]))
        prod_count[v] = len(prods)
        prod_mat[v, :len(prods)], prod_shift[v, :len(prods)] = zip(*prods)
    elems = np.argsort(st.vid, kind="stable").astype(np.int32)
    counts = np.bincount(st.vid, minlength=nvar)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tiles = [(v, int(starts[v]) + off, min(tile, int(counts[v]) - off))
             for v in range(nvar) for off in range(0, int(counts[v]), tile)]
    tiles.sort(key=lambda t: tile_order(int(prod_count[t[0]]), t[2]))
    return KernelPlan(instantiation=kind, tile=tile, k=k, n=n,
                      strides=strides, prod_mat=prod_mat,
                      prod_shift=prod_shift, prod_count=prod_count,
                      elems=elems,
                      tiles=np.asarray(tiles, np.int32).reshape(-1, 3))


def stored_matrices(st: StencilTables, kp: KernelPlan) -> np.ndarray:
    """``[nvar + 2 dim, K, N]`` f64: the stencil's matrices transposed
    (``y[e] = u[e] @ Mt``), zero-padded to the kernel's layout."""
    mats = [*st.Tdiag] + [m for ax in range(st.dim)
                          for m in (st.M12[ax], st.M21[ax])]
    out = np.zeros((len(mats), kp.k, kp.n))
    for i, m in enumerate(mats):
        out[i, :st.bs, :st.bs] = m.T
    return out


class UniformStencilOperator:
    """``apply(x) -> A x`` for bucket dicts on one full uniform lattice.

    CPU tensors run the plain twin (``uniform_sipg_operator``) in their
    own dtype.  CUDA tensors run the kernel: f32, contiguous, 16-byte
    aligned, shape ``[n, bs]`` with n bs < 2^31, on the device the
    operator was built for; anything else raises.  ``launches`` counts
    kernel launches; ``captured`` counts launches recorded into a CUDA
    graph under capture, which run on every replay of that graph.
    """

    def __init__(self, basis: DGBasis, penalty: float = 2.0,
                 dirichlet: bool = True, penalty_scaling: str = "measure",
                 device=None):
        self.basis = basis
        self.device = dev.resolve(device)
        self.tables = stencil_tables(basis, penalty, dirichlet,
                                     penalty_scaling)
        self.p = self.tables.p
        self.launches = 0
        self.captured = 0
        self._plain = {}  # dtype -> plain twin on the CPU
        self._k = None
        if self.device.type == "cuda":
            self._k = self._device_tables()
            # build and load the library and, for the GEMM
            # instantiations, set the kernel's shared-memory attributes
            # now: neither may happen while a CUDA graph is captured
            with torch.cuda.device(self.device):
                occupancy(self.tables.bs)
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")

    def _device_tables(self) -> dict:
        st = self.tables
        kp = kernel_plan(self.basis, st)
        i32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=torch.int32, device=self.device)
        return dict(mats=torch.as_tensor(stored_matrices(st, kp),
                                         dtype=torch.float32,
                                         device=self.device),
                    tiles=i32(kp.tiles), elems=i32(kp.elems),
                    prod_mat=i32(kp.prod_mat), prod_shift=i32(kp.prod_shift),
                    prod_count=i32(kp.prod_count), nvar=len(st.variants),
                    nnbr=2 * st.dim)

    def __call__(self, x: dict) -> dict:
        u = x[self.p]
        if u.device.type == "cpu":
            if u.dtype not in self._plain:
                self._plain[u.dtype] = uniform_sipg_operator(
                    self.basis, dtype=u.dtype, device="cpu",
                    tables=self.tables)
            return self._plain[u.dtype](x)
        return {self.p: self.launch(u)}

    def launch(self, u: torch.Tensor) -> torch.Tensor:
        """Run the kernel on a CUDA tensor ``u [n, bs]`` f32."""
        if self._k is None or u.device != self.device:
            raise ValueError(f"tensor on {u.device}; the kernel tables "
                             f"live on {self.device}")
        st = self.tables
        n = self.basis.mesh.n_elements
        if u.dtype != torch.float32:
            raise TypeError(f"uniform stencil kernel takes float32, "
                            f"got {u.dtype}")
        if tuple(u.shape) != (n, st.bs) or not u.is_contiguous():
            raise ValueError(f"uniform stencil kernel takes a contiguous "
                             f"[{n}, {st.bs}] tensor, got {tuple(u.shape)}")
        if u.data_ptr() % 16:
            raise ValueError("uniform stencil kernel takes a 16-byte "
                             "aligned tensor")
        if u.numel() >= 2 ** 31:
            raise ValueError("uniform stencil kernel takes fewer than 2^31 "
                             "values (32-bit offsets)")
        lib = build()
        k = self._k
        y = torch.empty_like(u)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = lib.hpdg_uniform_stencil_f32(
            u.data_ptr(), y.data_ptr(), k["mats"].data_ptr(),
            k["tiles"].data_ptr(), k["elems"].data_ptr(),
            k["prod_mat"].data_ptr(), k["prod_shift"].data_ptr(),
            k["prod_count"].data_ptr(), k["tiles"].shape[0], n, st.bs,
            k["nvar"], k["nnbr"], stream)
        if rc != 0:
            raise RuntimeError(f"uniform stencil kernel launch failed: "
                               f"CUDA error {rc}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return y


def uniform_stencil_operator(basis: DGBasis, penalty: float = 2.0,
                             dirichlet: bool = True,
                             penalty_scaling: str = "measure",
                             device=None) -> UniformStencilOperator:
    """The level operator of the multigrid: K1 on the card, its plain
    twin on the CPU (``device="cpu"``)."""
    return UniformStencilOperator(basis, penalty, dirichlet,
                                  penalty_scaling, device)
