"""Shifted Legendre modal basis on [0,1] (L2-orthonormal).

Analog of the reference's DGLegendreLocalBasis
(localfunctions/qkdglegendre.hh), used for the hp smoothness indicator
(estimators/smoothnessindicator.hh:19-71): interpolate a local function
into the modal basis and inspect the decay of its coefficients.
"""

from __future__ import annotations

import functools

import numpy as np

from hpdg_tpu_torch import quadrature


def legendre_values(p: int, x: np.ndarray) -> np.ndarray:
    """Values of the orthonormal shifted Legendre basis: shape (p+1, len(x)).

    P~_k(x) = sqrt(2k+1) * P_k(2x - 1), so that ∫_0^1 P~_j P~_k = δ_jk.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    t = 2.0 * x - 1.0
    out = np.zeros((p + 1, len(x)))
    out[0] = 1.0
    if p >= 1:
        out[1] = t
    for k in range(1, p):
        out[k + 1] = ((2 * k + 1) * t * out[k] - k * out[k - 1]) / (k + 1)
    scale = np.sqrt(2.0 * np.arange(p + 1) + 1.0)
    return out * scale[:, None]


@functools.lru_cache(maxsize=None)
def modal_projection_matrix(p: int, nq: int | None = None):
    """Matrix M with shape (p+1, nq) and quad nodes such that the modal
    coefficients of a function f sampled at the nodes are ``M @ f(nodes)``.

    Uses Gauss-Legendre quadrature exact for degree 2p.
    """
    nq = nq or (p + 1)
    qn, qw = quadrature.gauss_legendre(max(nq, p + 1))
    V = legendre_values(p, qn)  # (p+1, nq)
    return V * qw[None, :], qn
