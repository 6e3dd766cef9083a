"""1D Lagrange nodal bases at Gauss-type node families.

Analog of dune-hpdg's Qk local bases
(localfunctions/lagrange/qkgausslobatto/qkgllocalbasis.hh:37-239 for
Gauss-Lobatto nodes, localfunctions/lagrange/qkgausslegendre.hh for
Gauss-Legendre nodes, qkgausskronrod.hh for Gauss-Kronrod nodes).
Instead of per-element virtual finite elements, we precompute dense
``(p+1) x nq`` value/derivative tables per polynomial degree — the exact
analog of ``GaussLobatto::ValuesAndDerivatives``
(matrix-free/localoperators/gausslobattomatrices.hh:28-90), which is the
core data of sum factorization.  Tables are numpy float64 on the host;
operators receive them as torch constants.

Evaluation uses the barycentric formula (numerically stable for the
clustered Gauss node distributions up to high p).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from hpdg_tpu_torch import quadrature

#: supported 1D node families, keyed like the reference's basis variants
NODE_FAMILIES = ("lobatto", "legendre", "kronrod")


@functools.lru_cache(maxsize=None)
def nodes_1d(p: int, family: str = "lobatto") -> np.ndarray:
    """The p+1 interpolation nodes on [0,1] for degree p, sorted ascending."""
    if p < 0:
        raise ValueError("degree must be >= 0")
    if family == "lobatto":
        if p == 0:
            return np.array([0.5])
        return quadrature.gauss_lobatto(p + 1)[0]
    if family == "legendre":
        return quadrature.gauss_legendre(p + 1)[0]
    if family == "kronrod":
        # Gauss-Kronrod(2n+1) has odd point counts; pick the GK extension
        # whose point count is p+1 when possible, else fall back to the
        # Gauss-Legendre nodes (mirrors the reference's use of GK nodes
        # only for odd p+1).
        if p % 2 == 0 and p >= 2:
            return quadrature.gauss_kronrod(p // 2)[0]
        return quadrature.gauss_legendre(p + 1)[0]
    raise ValueError(f"unknown node family {family!r}")


def barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def lagrange_values(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Values of the Lagrange basis at ``x``: shape ``(len(nodes), len(x))``.

    Stable barycentric form with exact handling of x coinciding with a node.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    w = barycentric_weights(nodes)
    d = x[None, :] - nodes[:, None]  # (n, q)
    exact = np.isclose(d, 0.0, atol=1e-14, rtol=0.0)
    is_node = exact.any(axis=0)
    dsafe = np.where(exact, 1.0, d)
    terms = np.where(exact, 0.0, w[:, None] / dsafe)
    denom = np.sum(terms, axis=0, keepdims=True)
    denom = np.where(denom == 0.0, 1.0, denom)  # columns hit a node exactly
    vals = terms / denom
    # overwrite columns where x hits a node exactly
    vals = np.where(is_node[None, :], exact.astype(np.float64), vals)
    return vals


def lagrange_derivatives(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Derivatives of the Lagrange basis at ``x``: shape ``(n, q)``.

    Uses D = differentiation-matrix route: l_i'(x) expressed via the
    values and the barycentric identity; exact at nodes through the
    standard differentiation matrix.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = len(nodes)
    w = barycentric_weights(nodes)
    vals = lagrange_values(nodes, x)
    out = np.zeros((n, len(x)))
    d = x[None, :] - nodes[:, None]
    exact = np.isclose(d, 0.0, atol=1e-14, rtol=0.0)
    is_node = exact.any(axis=0)

    # generic points: l_i'(x) = l_i(x) * (sum_j 1/(x-x_j) - 1/(x-x_i))
    # more stable: l_i'(x) = (w_i/(x-x_i)) * (S1 - l_i(x)*S2)/S0 ... use
    # direct formula via quotient rule on the second barycentric form.
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
    inv = np.where(exact, 0.0, inv)
    s = np.sum(inv, axis=0)  # sum_j 1/(x - x_j)
    generic = vals * (s[None, :] - inv)

    # node points: differentiation matrix D[i, k] = l_i'(x_k)
    D = _diff_matrix(nodes, w)
    # for each x column that is (numerically) a node, pick that column of D
    node_idx = np.argmax(exact, axis=0)
    node_cols = D[:, node_idx]
    out = np.where(is_node[None, :], node_cols, generic)
    return out


@functools.lru_cache(maxsize=None)
def _diff_matrix_cached(key):
    nodes = np.array(key)
    return _diff_matrix(nodes, barycentric_weights(nodes))


def _diff_matrix(nodes: np.ndarray, w: np.ndarray) -> np.ndarray:
    """D[i,k] = l_i'(nodes[k]) (standard barycentric differentiation matrix)."""
    n = len(nodes)
    D = np.zeros((n, n))
    for k in range(n):
        for i in range(n):
            if i != k:
                D[i, k] = (w[i] / w[k]) / (nodes[k] - nodes[i])
        D[k, k] = 0.0
    # diagonal via negative row-sum property (sum_i l_i' == 0)
    for k in range(n):
        D[k, k] = -np.sum(D[:, k]) + D[k, k]
    return D


@dataclass(frozen=True)
class ValuesAndDerivatives:
    """Per-degree 1D basis tables at a fixed quadrature rule.

    ``values[i, q]`` / ``derivatives[i, q]``: i-th basis function at
    quad point q.  ``at0 / at1`` and ``dat0 / dat1``: traces and
    derivative traces at the interval endpoints (used for face terms).
    Mirrors GaussLobatto::ValuesAndDerivatives
    (matrix-free/localoperators/gausslobattomatrices.hh:110-121) plus the
    endpoint columns the face assemblers extract implicitly.
    """

    degree: int
    family: str
    qnodes: np.ndarray  # (nq,)
    qweights: np.ndarray  # (nq,)
    values: np.ndarray  # (p+1, nq)
    derivatives: np.ndarray  # (p+1, nq)
    at0: np.ndarray  # (p+1,)
    at1: np.ndarray  # (p+1,)
    dat0: np.ndarray  # (p+1,)
    dat1: np.ndarray  # (p+1,)


@functools.lru_cache(maxsize=None)
def tables(p: int, nq: int, family: str = "lobatto",
           quad_family: str = "lobatto") -> ValuesAndDerivatives:
    """Build the 1D tables for degree ``p`` at an ``nq``-point rule."""
    nodes = nodes_1d(p, family)
    if quad_family == "lobatto":
        qn, qw = quadrature.gauss_lobatto(max(nq, 2))
    elif quad_family == "legendre":
        qn, qw = quadrature.gauss_legendre(nq)
    else:
        raise ValueError(quad_family)
    ends = np.array([0.0, 1.0])
    V = lagrange_values(nodes, qn)
    D = lagrange_derivatives(nodes, qn)
    Ve = lagrange_values(nodes, ends)
    De = lagrange_derivatives(nodes, ends)
    return ValuesAndDerivatives(
        degree=p, family=family, qnodes=qn, qweights=qw,
        values=V, derivatives=D,
        at0=Ve[:, 0], at1=Ve[:, 1], dat0=De[:, 0], dat1=De[:, 1],
    )


def tables_for_dune_order(p: int, order: int, family: str = "lobatto") -> ValuesAndDerivatives:
    """Tables at the Gauss-Lobatto rule of DUNE exactness ``order``.

    Matches the reference's ``getRule(degree)`` with order = 2*degree
    (gausslobattoipdgassembler.hh:95-101): m-point GL is exact to 2m-3,
    so m = ceil((order+3)/2).
    """
    m = max(2, -(-(order + 3) // 2))
    return tables(p, m, family=family, quad_family="lobatto")
