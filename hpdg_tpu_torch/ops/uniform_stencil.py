"""K1: the fused uniform-lattice SIPG stencil apply as a CUDA kernel.

Replaces ``hpdg_tpu.ops.pallas_uniform.pallas_uniform_sipg_operator``.
The kernel (``csrc/uniform_stencil.cu``) computes what the plain twin
``matrixfree.uniform.uniform_sipg_operator`` computes, from the same
host-built f64 matrices cast to f32:

    y[e] = Tdiag[vid[e]] u[e] + sum_ax ( has_p M12_ax u[e+s_ax] + has_m M21_ax u[e-s_ax] )

It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``hpdg_tpu_torch/_build/`` (keyed by the source's hash) and bound with
ctypes.  :class:`UniformStencilOperator` runs the plain twin for CPU
tensors and the kernel for CUDA tensors; there is no fallback between
the two.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.matrixfree.uniform import (StencilTables, _lattice_shape,
                                               stencil_tables,
                                               uniform_sipg_operator)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "uniform_stencil.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# mirrors tile_elems() in the CUDA source (checked against it at load)
_THREADS, _ROWS_PER_THREAD, _COLS_PER_THREAD = 256, 4, 4

_lib = None  # the loaded shared library (one per process)


def tile_elems(bs: int) -> int:
    """Elements per kernel tile for block size ``bs``."""
    col_groups = -(-bs // _COLS_PER_THREAD)
    return (_THREADS // col_groups) * _ROWS_PER_THREAD


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernel cannot "
                           "be built")
    return path


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libuniform_stencil_{tag}.so"


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source content) and load it.

    The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) is kept beside the library as ``<lib>.log``.
    """
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        Path(f"{so}.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.hpdg_uniform_stencil_f32.argtypes = [ptr] * 8 + [cint] * 6 + [ptr]
    lib.hpdg_uniform_stencil_f32.restype = cint
    lib.hpdg_uniform_stencil_tile_elems.argtypes = [cint]
    lib.hpdg_uniform_stencil_tile_elems.restype = cint
    for bs in (8, 27, 125):
        if lib.hpdg_uniform_stencil_tile_elems(bs) != tile_elems(bs):
            raise RuntimeError("tile size of the CUDA source and of "
                               "ops.uniform_stencil disagree")
    _lib = lib
    return lib


@dataclass(frozen=True)
class KernelPlan:
    """Host-side launch tables of the kernel (numpy)."""

    strides: tuple  # element stride of each lattice axis
    var_mask: np.ndarray  # (nvar,) int32: bit 2ax = +ax nbr, 2ax+1 = -ax
    elems: np.ndarray  # (n,) int32 element ids grouped by variant
    tiles: np.ndarray  # (ntiles, 3) int32 (variant, start, count)


def kernel_plan(basis: DGBasis, st: StencilTables) -> KernelPlan:
    """Strides, variant masks and tiles; raises ValueError where the
    kernel's addressing (C-lattice order, neighbours at +-stride) does
    not hold."""
    if st.dim not in (2, 3):
        raise ValueError("uniform stencil kernel: 2D/3D only")
    if st.bs > 128:
        raise ValueError(f"uniform stencil kernel: block size {st.bs} > 128")
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
    var_mask = np.zeros(len(st.variants), np.int32)
    for k, code in enumerate(st.variants):
        cc = int(code)
        for ax in range(dim - 1, -1, -1):
            var_mask[k] |= (((cc >> 1) & 1) << (2 * ax)) | ((cc & 1) << (2 * ax + 1))
            cc >>= 2
    elems = np.argsort(st.vid, kind="stable").astype(np.int32)
    counts = np.bincount(st.vid, minlength=len(st.variants))
    te = tile_elems(st.bs)
    tiles, start = [], 0
    for k, c in enumerate(counts):
        for off in range(0, int(c), te):
            tiles.append((k, start + off, min(te, int(c) - off)))
        start += int(c)
    return KernelPlan(strides=strides, var_mask=var_mask, elems=elems,
                      tiles=np.asarray(tiles, np.int32).reshape(-1, 3))


class UniformStencilOperator:
    """``apply(x) -> A x`` for bucket dicts on one full uniform lattice.

    CPU tensors run the plain twin (``uniform_sipg_operator``) in their
    own dtype.  CUDA tensors run the kernel: f32, contiguous, shape
    ``[n, bs]``, on the device the operator was built for; anything else
    raises.  ``launches`` counts kernel launches.
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
        self._plain = {}  # dtype -> plain twin on the CPU
        self._k = None
        if self.device.type == "cuda":
            self._k = self._device_tables()
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")

    def _device_tables(self) -> dict:
        st = self.tables
        kp = kernel_plan(self.basis, st)
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=torch.float32, device=self.device)
        i32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=torch.int32, device=self.device)
        # stored transposed (Mt[j][i] = M[i][j]): y[e] = u[e] @ Mt
        return dict(tdiag=f32(st.Tdiag.transpose(0, 2, 1)),
                    mplus=f32(st.M12.transpose(0, 2, 1)),
                    mminus=f32(st.M21.transpose(0, 2, 1)),
                    tiles=i32(kp.tiles), elems=i32(kp.elems),
                    var_mask=i32(kp.var_mask),
                    strides=tuple(kp.strides) + (0,) * (3 - st.dim))

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
        lib = build()
        k = self._k
        y = torch.empty_like(u)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = lib.hpdg_uniform_stencil_f32(
            u.data_ptr(), y.data_ptr(), k["tdiag"].data_ptr(),
            k["mplus"].data_ptr(), k["mminus"].data_ptr(),
            k["tiles"].data_ptr(), k["elems"].data_ptr(),
            k["var_mask"].data_ptr(), k["tiles"].shape[0], st.bs, st.dim,
            *k["strides"], stream)
        if rc != 0:
            raise RuntimeError(f"uniform stencil kernel launch failed: "
                               f"CUDA error {rc}")
        self.launches += 1
        return y


def uniform_stencil_operator(basis: DGBasis, penalty: float = 2.0,
                             dirichlet: bool = True,
                             penalty_scaling: str = "measure",
                             device=None) -> UniformStencilOperator:
    """The level operator of the multigrid: K1 on the card, its plain
    twin on the CPU."""
    return UniformStencilOperator(basis, penalty, dirichlet,
                                  penalty_scaling, device)
