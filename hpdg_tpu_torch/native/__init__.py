"""Native (C++) host kernels, bound through ctypes.

Port of ``hpdg_tpu.native``: the host-side runtime around the device
path has a C++ implementation, ``cpp/meshkit.cc``, shared with the
reference package:

* ``hpdg_build_faces``: the face matcher of box meshes (the numpy one
  in ``mesh.structured`` is its readable twin);
* ``hpdg_sipg_fact_apply3``: the f64 factorized uniform-lattice SIPG
  apply in 3D (OpenMP), the host residual of verified solves;
* ``hpdg_frame_cells``: the BFS frame assignment and face matching of
  general hex/quad imports (``mesh.geometry.from_cell_vertices``).

The library is compiled at first use with ``g++`` into the package's
``_build/`` directory, named by the hash of the source and the flags,
and written atomically (compiled to a per-process temporary name, then
renamed), so concurrent processes never map a half-written file.
Without ``g++`` on the PATH :func:`available` is False and the callers
take their Python routes; a compile or load failure raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "cpp" / "meshkit.cc"
BUILD_DIR = _PKG / "_build"
BASE_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
# threaded kernels where OpenMP is available, else the serial build
FLAG_SETS = (("-fopenmp",) + BASE_FLAGS, BASE_FLAGS)

_libs = {}


def available() -> bool:
    """True when a C++ compiler (``g++``) is on the PATH."""
    return shutil.which("g++") is not None


def library_path(flags=FLAG_SETS[0], build_dir=None) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    return Path(build_dir or BUILD_DIR) / f"libmeshkit_{h.hexdigest()[:16]}.so"


def _compile(so: Path, flags) -> subprocess.CompletedProcess:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *flags, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode == 0:
        os.replace(tmp, so)
    elif tmp.exists():
        tmp.unlink()
    return res


def build(build_dir=None) -> ctypes.CDLL:
    """Compile ``cpp/meshkit.cc`` (once per source and flags) into
    ``build_dir`` (default the package's ``_build/``) and load it."""
    key = str(build_dir or BUILD_DIR)
    if key in _libs:
        return _libs[key]
    if not available():
        raise RuntimeError("g++ not found on the PATH: the native host "
                           "kernels cannot be built")
    errors = []
    for flags in FLAG_SETS:
        so = library_path(flags, build_dir)
        if not so.exists():
            res = _compile(so, flags)
            if res.returncode != 0:
                errors.append(f"g++ {' '.join(flags)} failed "
                              f"({res.returncode}):\n{res.stderr[-4000:]}")
                continue
        lib = _bind(ctypes.CDLL(str(so)))
        _libs[key] = lib
        return lib
    raise RuntimeError("\n".join(errors))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f64 = np.ctypeslib.ndpointer(np.float64)
    i32 = np.ctypeslib.ndpointer(np.int32)
    i64 = np.ctypeslib.ndpointer(np.int64)
    lib.hpdg_build_faces.restype = ctypes.c_int
    lib.hpdg_build_faces.argtypes = [
        ctypes.c_int64, ctypes.c_int32, f64, f64, ctypes.c_double,
        i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_int64, ctypes.c_int64, i64, i64]
    lib.hpdg_sipg_fact_apply3.restype = ctypes.c_int
    lib.hpdg_sipg_fact_apply3.argtypes = (
        [ctypes.c_int64] * 3 + [ctypes.c_int32] + [f64] * 11)
    lib.hpdg_frame_cells.restype = ctypes.c_int
    lib.hpdg_frame_cells.argtypes = [
        ctypes.c_int64, ctypes.c_int32, i64, i64, i32, i32, i32,
        ctypes.c_int64, i32, i32, i32, ctypes.c_int64, i64, i64]
    return lib


def build_faces(lower: np.ndarray, extent: np.ndarray, tol: float):
    """Native face matcher -> ``(inside, outside, axis, nc_code, b_elem,
    b_axis, b_side)`` int32 arrays (the numpy matcher's fields, possibly
    in another order)."""
    lower = np.ascontiguousarray(lower, dtype=np.float64)
    extent = np.ascontiguousarray(extent, dtype=np.float64)
    if lower.ndim != 2 or extent.shape != lower.shape:
        raise ValueError(f"lower {lower.shape} and extent {extent.shape} "
                         "must both be (n, dim)")
    n, dim = lower.shape
    lib = build()
    # provable bound: every face (interior or boundary) consumes at least
    # one unique (element, axis, half) slot, of which there are 2 dim n;
    # hanging-node meshes exceed the naive dim n interior-face count
    cap_f = cap_b = 2 * dim * n
    f_in, f_out, f_ax, f_nc = (np.empty(cap_f, np.int32) for _ in range(4))
    b_el, b_ax, b_sd = (np.empty(cap_b, np.int32) for _ in range(3))
    nf = np.zeros(1, np.int64)
    nbf = np.zeros(1, np.int64)
    rc = lib.hpdg_build_faces(n, dim, lower, extent, tol, f_in, f_out, f_ax,
                              f_nc, b_el, b_ax, b_sd, cap_f, cap_b, nf, nbf)
    if rc != 0:
        raise RuntimeError(f"hpdg_build_faces failed (rc {rc}: "
                           f"{'face capacity' if rc == 1 else 'dimension'})")
    k, m = int(nf[0]), int(nbf[0])
    return (f_in[:k].copy(), f_out[:k].copy(), f_ax[:k].copy(),
            f_nc[:k].copy(), b_el[:m].copy(), b_ax[:m].copy(),
            b_sd[:m].copy())


class SipgFactApply3:
    """Reusable f64 factorized uniform-lattice SIPG apply (3D) on the
    host: the 1D factor blocks and scratch buffers; ``__call__`` maps a
    flat ``(n_elements, nb^3)`` f64 array to the operator image.  The
    math twin of ``matrixfree.uniform.uniform_sipg_factorized``; built
    by ``matrixfree.uniform.uniform_sipg_factorized_host``."""

    def __init__(self, cells, nb, Mm, Dint, Dlo, Dhi, F12, F21):
        if len(cells) != 3:
            raise ValueError("native factorized apply is 3D-only")
        self.cells = tuple(int(c) for c in cells)
        self.nb = int(nb)
        c = lambda a: np.ascontiguousarray(a, np.float64)  # noqa: E731
        self.Mm = c(Mm)
        self.Dint, self.Dlo, self.Dhi = c(Dint), c(Dlo), c(Dhi)
        self.F12, self.F21 = c(F12), c(F21)
        nb2 = (self.nb, self.nb)
        if self.Mm.shape != nb2 or any(
                a.shape != (3,) + nb2 for a in (self.Dint, self.Dlo,
                                                self.Dhi, self.F12,
                                                self.F21)):
            raise ValueError(f"factor blocks must be ({self.nb}, {self.nb}) "
                             f"and (3, {self.nb}, {self.nb})")
        self.n = int(np.prod(self.cells)) * self.nb ** 3
        self._s1, self._s2, self._s3 = (np.empty(self.n, np.float64)
                                        for _ in range(3))
        self._lib = build()

    def __call__(self, u: np.ndarray, out: np.ndarray | None = None
                 ) -> np.ndarray:
        u = np.ascontiguousarray(u, np.float64).reshape(-1)
        if u.shape[0] != self.n:
            raise ValueError(f"size mismatch: {u.shape[0]} values for "
                             f"{self.n} dofs")
        if out is not None and (out.dtype != np.float64 or out.size != self.n
                                or not out.flags.c_contiguous):
            raise ValueError(f"out must be a contiguous float64 array of "
                             f"{self.n} values")
        y = out.reshape(-1) if out is not None else np.empty(self.n)
        rc = self._lib.hpdg_sipg_fact_apply3(
            self.cells[0], self.cells[1], self.cells[2], self.nb,
            self.Mm, self.Dint, self.Dlo, self.Dhi, self.F12, self.F21,
            u, y, self._s1, self._s2, self._s3)
        if rc != 0:
            raise RuntimeError(f"native factorized apply failed (rc {rc})")
        return y.reshape(int(np.prod(self.cells)), self.nb ** 3)


def frame_cells(cells_bit: np.ndarray, dim: int):
    """Native BFS parametric-frame assignment and face matching for
    arbitrary hex/quad connectivity (the non-lattice import of
    ``mesh.geometry.from_cell_vertices``).

    Returns ``(order, (inside, outside, axis), (b_elem, b_axis,
    b_side))``, or None when the mesh needs per-face twist codes (rc 2:
    no identity-aligned frame assignment exists; the Python path assigns
    them); raises ValueError for the topology errors the Python path
    also reports (a face shared by more than two cells, disconnected
    components, a degenerate cell)."""
    cells_bit = np.ascontiguousarray(cells_bit, np.int64)
    if cells_bit.ndim != 2:
        raise ValueError(f"cells_bit {cells_bit.shape} must be (n, 2^dim)")
    n, nc = cells_bit.shape
    lib = build()
    order = np.empty((n, nc), np.int64)
    cap_f = dim * n + 1
    cap_b = 2 * dim * n + 1
    f_in, f_out, f_ax = (np.empty(cap_f, np.int32) for _ in range(3))
    b_el, b_ax, b_sd = (np.empty(cap_b, np.int32) for _ in range(3))
    nf = np.zeros(1, np.int64)
    nbf = np.zeros(1, np.int64)
    rc = lib.hpdg_frame_cells(n, dim, cells_bit, order, f_in, f_out, f_ax,
                              cap_f, b_el, b_ax, b_sd, cap_b, nf, nbf)
    if rc == 1:
        raise ValueError("a face is shared by more than two cells")
    if rc == 2:
        return None
    if rc == 3:
        raise ValueError("hex mesh has disconnected components")
    if rc == 4:
        raise ValueError("degenerate cell (bad vertex connectivity)")
    if rc != 0:
        raise RuntimeError(f"hpdg_frame_cells failed (rc {rc})")
    k, m = int(nf[0]), int(nbf[0])
    return (order, (f_in[:k].copy(), f_out[:k].copy(), f_ax[:k].copy()),
            (b_el[:m].copy(), b_ax[:m].copy(), b_sd[:m].copy()))
