"""Legendre-decay hp smoothness indicator.

Port of ``hpdg_tpu.estimators.smoothness`` (SmoothnessIndicator of the
reference, after Houston & Süli): expand each element's local solution
in the L2-orthonormal Legendre modal basis, fit the slope m of
``|log|c_k||`` against ``|k|_1`` by least squares over all indices, and
return ``e^{-m}``; a NaN slope (zero coefficients) counts as smooth and
gives 0.  Small values mean fast modal decay (raise p), large values
mean refine h.

The modal projection is one ``[n, bs] @ [bs, bs]`` product per degree
bucket on the device of ``x``, in f64; the log, the slope and the NaN
rule run on the host in f64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hpdg_tpu_torch import quadrature
from hpdg_tpu_torch.basis import lagrange, legendre, tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis


@functools.lru_cache(maxsize=None)
def modal_matrix(p: int, dim: int, family: str) -> np.ndarray:
    """``C[k, i]``: modal coefficient k of nodal basis function i, the
    tensor product of the 1D projections ``int P~_k phi_i`` (exact)."""
    qn, qw = quadrature.gauss_legendre(p + 1)
    V1 = lagrange.lagrange_values(lagrange.nodes_1d(p, family), qn)
    C1 = (legendre.legendre_values(p, qn) * qw[None, :]) @ V1.T
    C = C1
    for _ in range(dim - 1):
        C = np.kron(C, C1)
    return C


def smoothness_indicator(basis: DGBasis, x: dict) -> np.ndarray:
    """Per-element indicator e^{-m} (flat element order), host numpy f64."""
    dim = basis.dim
    out = np.zeros(basis.mesh.n_elements)
    for p in basis.bucket_degrees:
        C = torch.as_tensor(modal_matrix(p, dim, basis.family),
                            dtype=torch.float64, device=x[p].device)
        coeffs = (x[p].double() @ C.T).cpu().numpy()
        deg = tensor.multiindices(p, dim).sum(axis=1).astype(np.float64)
        with np.errstate(divide="ignore"):
            y = np.abs(np.log(np.abs(coeffs)))
        dbar = deg.mean()
        denom = ((deg - dbar) ** 2).sum()
        with np.errstate(invalid="ignore"):
            slope = ((y - y.mean(axis=1, keepdims=True)) @ (deg - dbar)
                     / denom)
            ind = np.exp(-slope)
        out[basis.bucket_elems[p]] = np.where(np.isnan(slope), 0.0, ind)
    return out
