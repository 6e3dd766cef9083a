"""Host-grid / sub-grid cross evaluation (the dune-subgrid analog).

Port of ``hpdg_tpu.blocks.subgrid``.  The reference couples a SubGrid (a
subset of host-grid elements, possibly further refined) to its host grid
in two places: the L2 functional of a HOST discrete function assembled
on the SUB basis, and a sub-grid discrete function evaluated through the
host grid.

A "sub mesh" is any box mesh whose elements each lie in exactly one host
element (masked structured meshes, refinements of such, ``from_boxes``
subsets).  The coupling is a plain index map built by geometric
containment on the host; evaluation is batched per (sub-degree,
host-degree) class in host numpy, and the results land on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis import lagrange, tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis


@dataclass(frozen=True)
class SubGridMap:
    """sub element -> containing host element, plus the inverse where the
    containment is 1:1 (host_to_sub[e] = -1 if e has no sub element)."""

    sub_to_host: np.ndarray   # (n_sub,) int
    host_to_sub: np.ndarray   # (n_host,) int, -1 where uncovered


def subgrid_map(host_mesh, sub_mesh) -> SubGridMap:
    """Containment map: every sub element must lie inside one host
    element (its own box within the host box, up to roundoff)."""
    eps = float(host_mesh.extent.min()) * 1e-9
    centers = sub_mesh.lower + 0.5 * sub_mesh.extent
    lo = host_mesh.lower
    hi = host_mesh.lower + host_mesh.extent
    s2h = np.full(sub_mesh.n_elements, -1, dtype=np.int64)
    for s in range(0, len(centers), 4096):
        C = centers[s:s + 4096]
        inside = np.all((C[:, None, :] >= lo[None] - eps)
                        & (C[:, None, :] <= hi[None] + eps), axis=2)
        hit = inside.argmax(axis=1)
        ok = inside[np.arange(len(C)), hit]
        s2h[s:s + 4096] = np.where(ok, hit, -1)
    if (s2h < 0).any():
        raise ValueError("sub elements outside the host mesh")
    # full containment (not just centers)
    if not np.all(
        (sub_mesh.lower >= host_mesh.lower[s2h] - eps).all(axis=1)
        & ((sub_mesh.lower + sub_mesh.extent)
           <= (host_mesh.lower + host_mesh.extent)[s2h] + eps).all(axis=1)):
        raise ValueError("a sub element spans multiple host elements")
    h2s = np.full(host_mesh.n_elements, -1, dtype=np.int64)
    # inverse only where the sub element IS the host element (same box)
    same = (np.abs(sub_mesh.lower - host_mesh.lower[s2h]).max(axis=1) < eps) \
        & (np.abs(sub_mesh.extent - host_mesh.extent[s2h]).max(axis=1) < eps)
    h2s[s2h[same]] = np.where(same)[0]
    return SubGridMap(sub_to_host=s2h, host_to_sub=h2s)


def _host_numpy(x: dict) -> dict:
    return {p: v.detach().cpu().double().numpy() for p, v in x.items()}


def _host_eval_batched(host_basis: DGBasis, x_host: dict, host_elems,
                       ref_pts):
    """Evaluate the host DG field (numpy buckets) on per-element
    reference points: ``host_elems`` (m,) host element ids, ``ref_pts``
    (m, q, dim) points in each host element's reference cell.  Returns
    (m, q), per host degree one numpy einsum over the shared q axis."""
    dim = host_basis.mesh.dim
    m, q = ref_pts.shape[:2]
    out = np.zeros((m, q))
    deg = host_basis.degrees[host_elems]
    for p in host_basis.bucket_degrees:
        sel = np.where(deg == p)[0]
        if not len(sel):
            continue
        nodes = lagrange.nodes_1d(p, host_basis.family)
        mi = tensor.multiindices(p, dim)  # (bs, dim)
        pts = ref_pts[sel]  # (k, q, dim)
        phi = np.ones((len(sel), q, len(mi)))
        for a in range(dim):
            va = lagrange.lagrange_values(
                nodes, pts[..., a].reshape(-1)).T.reshape(
                    len(sel), q, p + 1)  # (k, q, p+1)
            phi *= va[:, :, mi[:, a]]
        pos = host_basis.elem_bucket_pos[host_elems[sel]]
        out[sel] = np.einsum("kqb,kb->kq", phi, x_host[p][pos])
    return out


def host_function_on_sub_quad(host_basis: DGBasis, x_host: dict,
                              sub_basis: DGBasis, smap: SubGridMap,
                              nq1=None):
    """Host discrete function evaluated at the sub mesh's volume
    quadrature points.  Returns ({p_sub: (n_p, nq)} host numpy, the
    quadrature weights per degree)."""
    sub_mesh = sub_basis.mesh
    host_mesh = host_basis.mesh
    dim = sub_mesh.dim
    xh = _host_numpy(x_host)
    vals = {}
    wq = {}
    for p in sub_basis.bucket_degrees:
        elems = sub_basis.bucket_elems[p]
        vt = tensor.volume_tables(p, dim, nq1 or p + 2,
                                  family=sub_basis.family)
        pts = vt["points"]  # (nq, dim) in the SUB reference cell
        he = smap.sub_to_host[elems]
        # map sub reference points into the host reference cell
        scale = sub_mesh.extent[elems] / host_mesh.extent[he]
        shift = (sub_mesh.lower[elems] - host_mesh.lower[he]) \
            / host_mesh.extent[he]
        ref = shift[:, None, :] + pts[None, :, :] * scale[:, None, :]
        vals[p] = _host_eval_batched(host_basis, xh, he, ref)
        wq[p] = vt["weights"]
    return vals, wq


def l2_functional_from_host(sub_basis: DGBasis, host_basis: DGBasis,
                            x_host: dict, smap: SubGridMap | None = None,
                            dtype=torch.float64, device=None) -> dict:
    """Assemble b_i = ∫_sub g φ_i with g the HOST-grid discrete function
    (the reference's sub-grid L2 functional assembler), on ``device``."""
    device = dev.resolve(device)
    smap = smap or subgrid_map(host_basis.mesh, sub_basis.mesh)
    gq, _ = host_function_on_sub_quad(host_basis, x_host, sub_basis, smap)
    sub_mesh = sub_basis.mesh
    dim = sub_mesh.dim
    J = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    out = {}
    for p in sub_basis.bucket_degrees:
        elems = sub_basis.bucket_elems[p]
        vt = tensor.volume_tables(p, dim, p + 2, family=sub_basis.family)
        detJ = J(np.prod(sub_mesh.extent[elems], axis=1))
        out[p] = (J(gq[p]) * J(vt["weights"])[None]) @ J(vt["V"]).T \
            * detJ[:, None]
    return out


def sub_function_on_host(sub_basis: DGBasis, x_sub: dict,
                         host_basis: DGBasis, smap: SubGridMap | None = None,
                         fill: float = 0.0, dtype=torch.float64,
                         device=None) -> dict:
    """Interpolate a SUB discrete function into the HOST basis: host
    elements covered 1:1 by a sub element get the nodal interpolant;
    uncovered host elements get ``fill``.  Requires the 1:1 part of the
    map (refined sub elements inside one host element are not collapsed
    here)."""
    device = dev.resolve(device)
    smap = smap or subgrid_map(host_basis.mesh, sub_basis.mesh)
    dim = host_basis.mesh.dim
    xs = _host_numpy(x_sub)
    out = {p: np.full((host_basis.bucket_size(p), (p + 1) ** dim), fill)
           for p in host_basis.bucket_degrees}
    covered = np.where(smap.host_to_sub >= 0)[0]
    for ph in host_basis.bucket_degrees:
        selh = covered[host_basis.degrees[covered] == ph]
        if not len(selh):
            continue
        ssel = smap.host_to_sub[selh]
        for ps in sub_basis.bucket_degrees:
            m = ssel[sub_basis.degrees[ssel] == ps]
            hm = selh[sub_basis.degrees[ssel] == ps]
            if not len(m):
                continue
            T = tensor.interpolation_matrix(ps, ph, dim)  # (bs_h, bs_s)
            coef = xs[ps][sub_basis.elem_bucket_pos[m]]
            out[ph][host_basis.elem_bucket_pos[hm]] = coef @ np.asarray(T).T
    return {p: torch.as_tensor(v, dtype=dtype, device=device)
            for p, v in out.items()}
