"""Tensor-product basis utilities: multiindices, volume and trace tables.

Convention (used everywhere in hpdg_tpu and this port): a degree-p local basis on the
d-cube has (p+1)^d functions; the flat local index i corresponds to the
multiindex (i_0, ..., i_{d-1}) in C order — **the last dimension is
fastest**.  Local coefficient arrays may equivalently be viewed with
shape ``(p+1,)*d`` where array axis a is spatial dimension a.  Quadrature
points from :func:`hpdg_tpu_torch.quadrature.tensor_rule` follow the same
order.  (The reference uses the DUNE convention i_0 fastest,
qkgllocalbasis.hh:69-78; only the internal dof *ordering* differs, the
spanned space and all assembled spectra are identical.)

All tables here are host-side numpy float64.
"""

from __future__ import annotations

import functools

import numpy as np

from hpdg_tpu_torch import quadrature
from hpdg_tpu_torch.basis import lagrange


def n_local(p: int, dim: int) -> int:
    return (p + 1) ** dim


def multiindices(p: int, dim: int) -> np.ndarray:
    """(n_local, dim) int array of multiindices in C order (last fastest)."""
    grids = np.meshgrid(*([np.arange(p + 1)] * dim), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def _outer_flatten(mats: list[np.ndarray]) -> np.ndarray:
    """Kron of per-axis (n_a, q_a) tables into ((prod n_a), (prod q_a)).

    C-order consistent: axis 0 table slowest.
    """
    out = mats[0]
    for m in mats[1:]:
        out = np.einsum("iq,jr->ijqr", out, m).reshape(
            out.shape[0] * m.shape[0], out.shape[1] * m.shape[1]
        )
    return out


@functools.lru_cache(maxsize=None)
def volume_tables(p: int, dim: int, nq1: int, family: str = "lobatto",
                  quad_family: str = "lobatto"):
    """Volume basis tables on [0,1]^dim at the tensor quadrature rule.

    Returns dict with:
      ``points``  (nq, dim), ``weights`` (nq,),
      ``V``       (n_local, nq)          basis values,
      ``G``       (dim, n_local, nq)     reference gradients.
    """
    t = lagrange.tables(p, nq1, family=family, quad_family=quad_family)
    pts, w = quadrature.tensor_rule(t.qnodes, t.qweights, dim)
    Vs = [t.values] * dim
    V = _outer_flatten(Vs)
    G = np.zeros((dim, n_local(p, dim), len(w)))
    for a in range(dim):
        mats = [t.derivatives if b == a else t.values for b in range(dim)]
        G[a] = _outer_flatten(mats)
    return {"points": pts, "weights": w, "V": V, "G": G, "t1d": t}


@functools.lru_cache(maxsize=None)
def face_tables(p: int, dim: int, axis: int, side: int, nq1: int,
                family: str = "lobatto", quad_family: str = "lobatto",
                tang_map: tuple | None = None):
    """Trace tables on the face {x_axis = side} of [0,1]^dim.

    The face is parametrized by the remaining dims in their natural
    order (C order, last fastest), each on [0,1].  Returns dict with:
      ``points``   (nqf, dim-1)  tangential quad points,
      ``weights``  (nqf,)        tangential quad weights,
      ``V``        (n_local, nqf)  value trace,
      ``Dn``       (n_local, nqf)  *reference* normal-axis derivative trace
                   (d/dx_axis, unsigned; multiply by ±1/h_axis for the
                   physical outward-normal derivative),
      ``Dall``     (dim, n_local, nqf)  reference derivative traces along
                   EVERY axis (needed for traction terms in elasticity).

    ``tang_map``: optional per-tangential-axis (offset, scale) pairs; the
    tables are then evaluated at the mapped points offset + scale * t —
    the sub-face re-evaluation for non-conforming (hanging-node) faces
    (the reference's nonConformingMatrices,
    gausslobattoipdgassembler.hh:444-462).  Quadrature weights stay those
    of the (fine) face the quadrature lives on.
    """
    t = lagrange.tables(p, nq1, family=family, quad_family=quad_family)
    tang = [a for a in range(dim) if a != axis]
    if tang:
        pts, w = quadrature.tensor_rule(t.qnodes, t.qweights, len(tang))
    else:
        pts, w = np.zeros((1, 0)), np.ones(1)
    nodes = lagrange.nodes_1d(p, family)
    tang_tabs = []
    for ti in range(len(tang)):
        if tang_map is None:
            tang_tabs.append((t.values, t.derivatives))
        else:
            off, sc = tang_map[ti]
            xq = off + sc * t.qnodes
            tang_tabs.append((lagrange.lagrange_values(nodes, xq),
                              lagrange.lagrange_derivatives(nodes, xq)))
    end_v = t.at1 if side == 1 else t.at0
    end_d = t.dat1 if side == 1 else t.dat0
    v_mats, d_mats = [], []
    ti = 0
    for a in range(dim):
        if a == axis:
            v_mats.append(end_v[:, None])
            d_mats.append(end_d[:, None])
        else:
            v_mats.append(tang_tabs[ti][0])
            d_mats.append(tang_tabs[ti][0])
            ti += 1
    V = _outer_flatten(v_mats)
    Dn = _outer_flatten(d_mats)
    Dall = np.zeros((dim,) + V.shape)
    for b in range(dim):
        mats = []
        ti = 0
        for a in range(dim):
            if a == axis:
                mats.append((end_d if a == b else end_v)[:, None])
            else:
                mats.append(tang_tabs[ti][1] if a == b else tang_tabs[ti][0])
                ti += 1
        Dall[b] = _outer_flatten(mats)
    return {"points": pts, "weights": w, "V": V, "Dn": Dn, "Dall": Dall,
            "t1d": t}


@functools.lru_cache(maxsize=None)
def interpolation_matrix(p_from: int, p_to: int, dim: int,
                         family: str = "lobatto") -> np.ndarray:
    """Nodal interpolation of a degree-``p_from`` function into the
    degree-``p_to`` nodal basis: shape (n_to, n_from); exact if
    p_from <= p_to.  This is the p-transfer block
    (transferoperators/ordertransfer.hh:45-92 analog).
    """
    nodes_to = lagrange.nodes_1d(p_to, family)
    nodes_from = lagrange.nodes_1d(p_from, family)
    M1 = lagrange.lagrange_values(nodes_from, nodes_to).T  # (p_to+1, p_from+1)
    out = M1
    for _ in range(dim - 1):
        out = np.kron(out, M1)
    return out
