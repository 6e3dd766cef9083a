"""Bucketed block vectors: ``{degree: Tensor[n_elements_of_degree, ncomp (p+1)^dim]}``.

Port of ``hpdg_tpu.linalg.blockvector``.  A block vector is a plain dict
of tensors; ``ncomp > 1`` makes it vector-valued, component-major per
element.  Conversion to and from the flat (element-ordered) layout goes
through the host-side metadata of
:class:`~hpdg_tpu_torch.basis.dgbasis.DGBasis`.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis.dgbasis import DGBasis


def zeros(basis: DGBasis, dtype=torch.float64, device=None,
          ncomp: int = 1) -> dict:
    device = dev.resolve(device)
    return {p: torch.zeros((basis.bucket_size(p), ncomp * basis.n_local(p)),
                           dtype=dtype, device=device)
            for p in basis.bucket_degrees}


def flat_index(basis: DGBasis, p: int, ncomp: int = 1) -> np.ndarray:
    """Flat dof indices ``[n_p, ncomp (p+1)^dim]`` of bucket ``p``."""
    elems = basis.bucket_elems[p]
    return (ncomp * basis.offsets[elems][:, None]
            + np.arange(ncomp * basis.n_local(p))[None, :])


def from_flat(basis: DGBasis, flat, dtype=None, device=None,
              ncomp: int = 1) -> dict:
    flat = np.asarray(flat)
    device = dev.resolve(device)
    out = {}
    for p in basis.bucket_degrees:
        t = torch.from_numpy(np.ascontiguousarray(
            flat[flat_index(basis, p, ncomp)]))
        out[p] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def to_flat(basis: DGBasis, x: dict, ncomp: int = 1) -> np.ndarray:
    """Host numpy flat vector in element order."""
    first = x[basis.bucket_degrees[0]]
    flat = np.zeros(ncomp * basis.ndof,
                    dtype=first.detach().cpu().numpy().dtype)
    for p in basis.bucket_degrees:
        flat[flat_index(basis, p, ncomp)] = x[p].detach().cpu().numpy()
    return flat


# ---- vector space ops -----------------------------------------------------

def dot(x: dict, y: dict) -> torch.Tensor:
    parts = [torch.vdot(x[p].reshape(-1), y[p].reshape(-1)) for p in x]
    return sum(parts[1:], parts[0])


def norm(x: dict) -> torch.Tensor:
    return torch.sqrt(dot(x, x))


def axpy(a, x: dict, y: dict) -> dict:
    return {p: a * x[p] + y[p] for p in x}


def add(x: dict, y: dict) -> dict:
    return {p: x[p] + y[p] for p in x}


def sub(x: dict, y: dict) -> dict:
    return {p: x[p] - y[p] for p in x}


def scale(a, x: dict) -> dict:
    return {p: a * x[p] for p in x}


def zeros_like(x: dict) -> dict:
    return {p: torch.zeros_like(v) for p, v in x.items()}


def random(basis: DGBasis, seed: int = 1887, dtype=torch.float64,
           device=None, ncomp: int = 1) -> dict:
    """Deterministic pseudo-random vector: numpy's ``default_rng(seed)``
    draws the same numbers as ``hpdg_tpu.linalg.blockvector.random``
    (fixed seed 1887, the reference's test fixture)."""
    device = dev.resolve(device)
    rng = np.random.default_rng(seed)
    return {p: torch.as_tensor(
        rng.standard_normal((basis.bucket_size(p), ncomp * basis.n_local(p))),
        dtype=dtype, device=device) for p in basis.bucket_degrees}
