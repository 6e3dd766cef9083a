"""The port's package contract: no JAX at import, TF32 pinned off."""

import subprocess
import sys

import torch

import hpdg_tpu_torch


def test_import_leaves_jax_out():
    # only modules the import adds count: an interpreter hook may have
    # loaded others before it
    code = ("import sys; before = set(sys.modules); "
            "import hpdg_tpu_torch, hpdg_tpu_torch.solvers, "
            "hpdg_tpu_torch.ops.uniform_stencil, hpdg_tpu_torch.convert, "
            "hpdg_tpu_torch.matrixfree, hpdg_tpu_torch.mesh.adaptive; "
            "bad = [m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'hpdg_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_tf32_is_off_after_import():
    assert hpdg_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
