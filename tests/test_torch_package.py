"""The port's package contract: no JAX at import, TF32 pinned off, the
card by default."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import hpdg_tpu_torch
from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.ops.uniform_stencil import uniform_stencil_operator


def test_import_leaves_jax_out():
    # only modules the import adds count: an interpreter hook may have
    # loaded others before it
    code = ("import sys; before = set(sys.modules); "
            "import hpdg_tpu_torch, hpdg_tpu_torch.solvers, "
            "hpdg_tpu_torch.ops.uniform_stencil, hpdg_tpu_torch.convert, "
            "hpdg_tpu_torch.matrixfree, hpdg_tpu_torch.mesh.adaptive, "
            "hpdg_tpu_torch.blocks, hpdg_tpu_torch.estimators, "
            "hpdg_tpu_torch.examples.adaptive_lshape; "
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


def _cardless():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")


def test_resolve_none_refuses_without_card():
    _cardless()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dev.resolve(None)


def test_resolve_cpu_is_the_cpu():
    assert dev.resolve("cpu") == torch.device("cpu")
    assert dev.resolve(torch.device("cpu")) == torch.device("cpu")


def test_entry_point_without_device_refuses_without_card():
    _cardless()
    m = tmesh.structured((2, 2, 2))
    basis = DGBasis(m, np.full(m.n_elements, 1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        uniform_stencil_operator(basis)
    assert uniform_stencil_operator(basis, device="cpu").device.type == "cpu"
