"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source has a plain C interface.  It is compiled with ``nvcc`` for
``sm_90a`` at first use into ``hpdg_tpu_torch/_build/`` (git-ignored),
under a name keyed by the source's hash, and loaded with ctypes.  The
compiler's output (``-Xptxas=-v``: registers, shared memory, spills) is
kept beside the library as ``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernel cannot "
                           "be built")
    return path


def library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def load(source: Path) -> ctypes.CDLL:
    """Compile ``source`` unless its library exists, then load it."""
    so = library_path(source)
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        Path(f"{so}.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
