"""Sharded heat / parabolic operators: M + dt*A over a shard group.

Port of ``hpdg_tpu.parallel.heat``.  DG mass blocks are element-local,
so the sharded mass apply is one batched GEMM per degree with no
communication; the implicit-Euler operator M + dt*A communicates only
through A's halo exchange.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import mesh as hmesh
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.parallel.hp import HPSharded


def hp_mass_apply(prob: HPSharded, weight=None, dtype=torch.float64):
    """Sharded (w u, v) mass apply on the HPSharded layout: per-degree
    batched dense GEMM times per-element detJ.  ``weight``: optional
    w(x), evaluated once per quadrature point at build."""
    gmesh = prob.gmesh if prob.gmesh is not None \
        else hmesh.structured(prob.cells)
    dim = prob.ndim
    g = prob.group
    J = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                  device=g.device)
    prep = {}
    for p in prob.degree_set:
        vt = tensor.volume_tables(p, dim, p + 2, family="lobatto")
        m = prob.m_own[p]
        buf = np.zeros(g.L * m)
        wbuf = None
        if weight is not None:
            wbuf = np.zeros((g.L * m, len(vt["weights"])))
        for s in g.shards:
            ids = prob.owned_slots[(s, p)]
            off = (s - g.shards.start) * m
            if len(ids):
                buf[off:off + len(ids)] = np.prod(gmesh.extent[ids], axis=1)
                if weight is not None:
                    x = (gmesh.lower[ids][:, None, :]
                         + vt["points"][None, :, :]
                         * gmesh.extent[ids][:, None, :])
                    wbuf[off:off + len(ids)] = weight(
                        torch.as_tensor(x)).detach().cpu().numpy()
        if weight is None:
            M0 = np.einsum("iq,q,jq->ij", vt["V"], vt["weights"], vt["V"])
            prep[p] = (J(M0), J(buf)[:, None])
        else:
            prep[p] = (J(wbuf), J(vt["V"]), J(vt["weights"]), J(buf)[:, None])

    def apply(x):
        out = {}
        for p, t in prep.items():
            xp = x[p]
            if weight is None:
                M0, det = t
                out[p] = (xp @ M0.to(xp.dtype)) * det.to(xp.dtype)
            else:
                wb, V, w, det = (a.to(xp.dtype) for a in t)
                out[p] = ((xp @ V) * wb * w[None]) @ V.T * det
        return out

    return apply


def hp_heat_apply(prob: HPSharded, dt: float, weight=None,
                  dtype=torch.float64):
    """Implicit-Euler heat operator x -> (M + dt A) x on sharded bucket
    dicts."""
    mass = hp_mass_apply(prob, weight=weight, dtype=dtype)

    def apply(x):
        ax = prob.apply(x)
        mx = mass(x)
        return {p: mx[p] + dt * ax[p] for p in x}

    return apply
