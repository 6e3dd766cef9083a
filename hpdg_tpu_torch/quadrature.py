"""1D quadrature rules on the reference interval [0, 1].

Host-side (numpy, float64) computation of Gauss-Legendre, Gauss-Lobatto
and Gauss-Kronrod rules.  These are the analogs of the rules dune-hpdg
pulls from dune-geometry (``Dune::QuadratureRules``) plus its own
hard-coded Gauss-Kronrod tables
(reference: geometry/quadraturerules/gausskronrod.hh:14-37 and
gausskronrod_table.hh).  Everything here runs once at setup time on the
host; device code only ever sees the resulting static tables.

Order semantics follow DUNE: ``*_for_order(order)`` returns the smallest
rule exact for all polynomials of degree <= ``order``:

* Gauss-Legendre with m points is exact to degree 2m-1.
* Gauss-Lobatto with m points is exact to degree 2m-3.

Nodes are always returned sorted ascending (dune-hpdg sorts its GL rules
the same way, localfunctions/lagrange/qkgausslobatto/qkgllocalbasis.hh:231-235).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0,1]: (nodes, weights)."""
    if n < 1:
        raise ValueError("need at least one point")
    x, w = np.polynomial.legendre.leggauss(n)
    # map [-1,1] -> [0,1]
    nodes = 0.5 * (x + 1.0)
    weights = 0.5 * w
    order = np.argsort(nodes)
    return nodes[order], weights[order]


@functools.lru_cache(maxsize=None)
def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto rule on [0,1] (endpoints included).

    Interior nodes are the roots of P'_{n-1}; weights
    w_i = 2 / (n (n-1) P_{n-1}(x_i)^2) on [-1,1], halved for [0,1].
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 points")
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        # roots of derivative of Legendre polynomial P_{n-1}
        c = np.zeros(n)
        c[-1] = 1.0
        dc = np.polynomial.legendre.legder(c)
        x = np.polynomial.legendre.legroots(dc)
        # Newton-polish the roots for full float64 accuracy.
        for _ in range(3):
            d1 = np.polynomial.legendre.legval(x, np.polynomial.legendre.legder(c))
            d2 = np.polynomial.legendre.legval(
                x, np.polynomial.legendre.legder(c, 2)
            )
            x = x - d1 / d2
        x = np.concatenate([[-1.0], x, [1.0]])
    pnm1 = np.polynomial.legendre.legval(x, np.eye(n)[n - 1])
    w = 2.0 / (n * (n - 1) * pnm1**2)
    nodes = 0.5 * (x + 1.0)
    weights = 0.5 * w
    order = np.argsort(nodes)
    return nodes[order], weights[order]


@functools.lru_cache(maxsize=None)
def gauss_kronrod(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Kronrod extension of the n-point Gauss rule: 2n+1 points on [0,1].

    Computed from scratch (replacing the reference's hard-coded tables,
    geometry/quadraturerules/gausskronrod_table.hh): the n+1 added nodes
    are the roots of the Stieltjes polynomial E_{n+1}, the degree-(n+1)
    polynomial orthogonal to all lower degrees w.r.t. the signed weight
    P_n(x) dx.  We expand E in the Legendre basis, solve the (small,
    parity-sparse) orthogonality system, root-find via the Legendre
    colleague matrix, and recover weights from a Legendre-Vandermonde
    system (exactness through degree 2n fixes the 2n+1 weights; actual
    exactness, >= 3n+1, is asserted in the tests).
    """
    if n < 1:
        raise ValueError("need at least one point")
    # quadrature for the moment integrals (integrands up to degree 3n+2)
    xg, wg = np.polynomial.legendre.leggauss(2 * n + 4)

    def P(j, x):
        c = np.zeros(j + 1)
        c[j] = 1.0
        return np.polynomial.legendre.legval(x, c)

    Pn = P(n, xg)
    # E = P_{n+1} + sum_{j in J} a_j P_j,  J = {n-1, n-3, ...} >= 0
    J = list(range(n - 1, -1, -2))
    # conditions: ∫ E(x) P_n(x) x^k dx = 0, k = 0..n
    K = np.arange(n + 1)
    xk = xg[None, :] ** K[:, None]  # (n+1, nq)
    M = np.zeros((n + 1, len(J)))
    for c, j in enumerate(J):
        M[:, c] = xk @ (wg * Pn * P(j, xg))
    rhs = -(xk @ (wg * Pn * P(n + 1, xg)))
    a, *_ = np.linalg.lstsq(M, rhs, rcond=None)
    ecoef = np.zeros(n + 2)
    ecoef[n + 1] = 1.0
    for c, j in enumerate(J):
        ecoef[j] = a[c]
    new_nodes = np.polynomial.legendre.legroots(ecoef)
    gauss_nodes = np.polynomial.legendre.leggauss(n)[0]
    x = np.sort(np.concatenate([gauss_nodes, np.real(new_nodes)]))
    # weights: Legendre-Vandermonde system, ∫ P_i = 2 δ_{i0}
    V = np.zeros((2 * n + 1, 2 * n + 1))
    for i in range(2 * n + 1):
        V[i] = P(i, x)
    b = np.zeros(2 * n + 1)
    b[0] = 2.0
    w = np.linalg.solve(V, b)
    nodes = 0.5 * (x + 1.0)
    weights = 0.5 * w
    order = np.argsort(nodes)
    return nodes[order], weights[order]


def gauss_legendre_for_order(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Smallest Gauss-Legendre rule exact to polynomial degree ``order``."""
    m = max(1, (order + 2) // 2)  # 2m-1 >= order
    return gauss_legendre(m)


def gauss_lobatto_for_order(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Smallest Gauss-Lobatto rule exact to polynomial degree ``order``.

    dune-hpdg requests DUNE-order ``2p`` for degree-p SIPG assembly
    (assemblers/localassemblers/gausslobattoipdgassembler.hh:95-101),
    which with the 2m-3 exactness of an m-point rule yields m = p + 2.
    """
    m = max(2, -(-(order + 3) // 2))  # 2m-3 >= order
    return gauss_lobatto(m)


def tensor_rule(nodes1d: np.ndarray, weights1d: np.ndarray, dim: int):
    """Tensor-product rule on [0,1]^dim.

    Returns ``(points [nq, dim], weights [nq])`` with the *last* axis
    fastest (C order over ``dim`` nested loops, axis 0 slowest) — the
    multiindex convention used throughout (see basis.tensor).
    """
    q = len(nodes1d)
    grids = np.meshgrid(*([nodes1d] * dim), indexing="ij")
    pts = np.stack([g.reshape(-1) for g in grids], axis=-1)
    wgrids = np.meshgrid(*([weights1d] * dim), indexing="ij")
    w = np.ones(q**dim)
    for g in wgrids:
        w = w * g.reshape(-1)
    return pts, w
