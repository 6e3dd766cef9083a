"""Element-to-element transfer operators (p- and h-transfer).

Port of ``hpdg_tpu.transfer.element`` without the Galerkin product
(ROADMAP queue 1, item 12).  Each fine element has exactly ONE coarse
partner: the same element at a lower degree (p-transfer, nodal
interpolation) or its parent (h-transfer, parent basis at the child's
nodes).  Fine elements are grouped by (fine degree, coarse degree,
variant) — variant = child position for h-transfer — so each group
shares one interpolation matrix and prolong/restrict are one batched
GEMM per group.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpdg_tpu_torch.basis import lagrange, tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis


@dataclass(frozen=True)
class TGroup:
    pf: int  # fine degree
    pc: int  # coarse degree
    fine_pos: np.ndarray  # positions in fine bucket pf
    coarse_pos: np.ndarray  # positions in coarse bucket pc
    T: np.ndarray  # (bs_f, bs_c) interpolation block (prolongation)


@dataclass(frozen=True)
class ElementTransfer:
    fine: DGBasis
    coarse: DGBasis
    groups: tuple  # of TGroup
    # (dtype, device) -> per group (fine_pos, coarse_pos, T) tensors
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def _tensors(self, dtype, device):
        key = (dtype, device)
        if key not in self._dev:
            ix = lambda a: torch.as_tensor(  # noqa: E731
                a, dtype=torch.int64, device=device)
            self._dev[key] = [
                (ix(g.fine_pos), ix(g.coarse_pos),
                 torch.as_tensor(g.T, dtype=dtype, device=device))
                for g in self.groups]
        return self._dev[key]

    # ------------------------------------------------------------------
    def prolong(self, xc: dict, dtype=torch.float64) -> dict:
        device = next(iter(xc.values())).device
        xf = {p: torch.zeros((self.fine.bucket_size(p), self.fine.n_local(p)),
                             dtype=dtype, device=device)
              for p in self.fine.bucket_degrees}
        for g, (fpos, cpos, T) in zip(self.groups, self._tensors(dtype, device)):
            # every fine element belongs to one group: rows are set once
            xf[g.pf][fpos] = xc[g.pc][cpos] @ T.T
        return xf

    def restrict(self, rf: dict, dtype=torch.float64) -> dict:
        device = next(iter(rf.values())).device
        rc = {p: torch.zeros((self.coarse.bucket_size(p),
                              self.coarse.n_local(p)),
                             dtype=dtype, device=device)
              for p in self.coarse.bucket_degrees}
        for g, (fpos, cpos, T) in zip(self.groups, self._tensors(dtype, device)):
            # h-transfer: 2^dim children add into one parent row, one per
            # group, so coarse_pos is unique within a group and index_add_
            # never collides inside a call
            rc[g.pc].index_add_(0, cpos, rf[g.pf][fpos] @ T)
        return rc


# ---------------------------------------------------------------------------
def p_coarse_degrees(degrees: np.ndarray, max_order: int) -> np.ndarray:
    """Coarse degree map: min(k_e, max_order)."""
    return np.minimum(degrees, max_order).astype(np.int32)


def _build_groups(fine: DGBasis, coarse: DGBasis, coarse_elem: np.ndarray,
                  variant: np.ndarray, Tfun):
    """Group fine elements by (pf, pc, variant); Tfun(pf, pc, var) -> T."""
    keys = np.stack([fine.degrees, coarse.degrees[coarse_elem], variant],
                    axis=-1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    groups = []
    for gi, (pf, pc, var) in enumerate(uniq):
        pf, pc, var = int(pf), int(pc), int(var)
        fels = np.where(inv == gi)[0]
        groups.append(TGroup(
            pf=pf, pc=pc,
            fine_pos=fine.elem_bucket_pos[fels],
            coarse_pos=coarse.elem_bucket_pos[coarse_elem[fels]],
            T=Tfun(pf, pc, var),
        ))
    return tuple(groups)


def p_transfer(fine: DGBasis, max_order: int) -> ElementTransfer:
    """p-coarsening transfer: coarse basis on the same mesh with degrees
    min(k_e, max_order); block = nodal interpolation (exact embedding)."""
    coarse = fine.with_degrees(p_coarse_degrees(fine.degrees, max_order))
    n = fine.mesh.n_elements
    coarse_elem = np.arange(n, dtype=np.int32)
    variant = np.zeros(n, dtype=np.int32)

    def Tfun(pf, pc, var):
        return tensor.interpolation_matrix(pc, pf, fine.dim,
                                           family=fine.family)

    groups = _build_groups(fine, coarse, coarse_elem, variant, Tfun)
    return ElementTransfer(fine=fine, coarse=coarse, groups=groups)


def h_transfer(fine: DGBasis, coarse: DGBasis) -> ElementTransfer:
    """Grid transfer fine mesh -> parent mesh: block = coarse basis
    evaluated at the child's node positions mapped into the parent
    reference cell (offset and per-axis scale of the child's box)."""
    mesh = fine.mesh
    if mesh.parent is None:
        raise ValueError("fine mesh has no refinement hierarchy links")
    coarse_elem = mesh.parent.astype(np.int32)
    variant = mesh.child_pos.astype(np.int32)
    dim = mesh.dim

    # representative fine element per (pf, pc, var) group for the map
    keys = np.stack([fine.degrees, coarse.degrees[coarse_elem], variant],
                    axis=-1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    rep = {tuple(int(v) for v in uniq[g]): int(np.where(inv == g)[0][0])
           for g in range(len(uniq))}

    def Tfun(pf, pc, var):
        e = rep[(pf, pc, var)]
        pe = coarse_elem[e]
        off = ((mesh.lower[e] - coarse.mesh.lower[pe])
               / coarse.mesh.extent[pe])
        scl = mesh.extent[e] / coarse.mesh.extent[pe]
        nodes_f = lagrange.nodes_1d(pf, fine.family)
        mi = tensor.multiindices(pf, dim)
        xp = off[None, :] + nodes_f[mi] * scl[None, :]  # (nl_f, dim)
        nodes_c = lagrange.nodes_1d(pc, coarse.family)
        per_axis = [lagrange.lagrange_values(nodes_c, xp[:, a])
                    for a in range(dim)]  # each (pc+1, nl_f)
        mic = tensor.multiindices(pc, dim)
        T = np.ones((len(mi), len(mic)))
        for a in range(dim):
            T = T * per_axis[a][mic[:, a], :].T
        return T

    groups = _build_groups(fine, coarse, coarse_elem, variant, Tfun)
    return ElementTransfer(fine=fine, coarse=coarse, groups=groups)
