"""Element-to-element transfer operators and Galerkin coarse matrices.

Port of ``hpdg_tpu.transfer.element``.  Each fine element has exactly
ONE coarse partner: the same element at a lower degree (p-transfer,
nodal interpolation) or its parent (h-transfer, parent basis at the
child's nodes).  Fine elements are grouped by (fine degree, coarse
degree, variant) — variant = child position for h-transfer — so each
group shares one interpolation matrix and prolong/restrict are one
batched GEMM per group.  Vector-valued (component-major) coefficients
take the same matrix on the node index of every component.

The Galerkin product RtAR has a symbolic phase on the host (the coarse
pattern, diagonal-first, in the reference's entry order, and per work
item the fine entries and coarse slots; cached per fine pattern) and a
numeric phase on the device: one batched ``T_r^T A T_c`` einsum per
work item and one ``index_add_`` into the coarse slots.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpdg_tpu_torch.basis import lagrange, tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg.blockmatrix import (BlockPattern,
                                               BlockSparseMatrix,
                                               zeros_values)


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
    coarse_elem: np.ndarray  # (n_fine,) coarse partner of each fine element
    groups: tuple  # of TGroup
    group_of_fine: np.ndarray  # (n_fine,) group index
    # (dtype, device) -> per group (fine_pos, coarse_pos, T) tensors
    _dev: dict = field(default_factory=dict, repr=False, compare=False)
    # (fine pattern, block_shape) -> (coarse pattern, host work items);
    # (that key, device) -> the work items' index tensors
    _gcache: dict = field(default_factory=dict, repr=False, compare=False)

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
    def prolong(self, xc: dict, dtype=torch.float64, ncomp: int = 1) -> dict:
        device = next(iter(xc.values())).device
        xf = {p: torch.zeros((self.fine.bucket_size(p),
                              ncomp * self.fine.n_local(p)),
                             dtype=dtype, device=device)
              for p in self.fine.bucket_degrees}
        for g, (fpos, cpos, T) in zip(self.groups, self._tensors(dtype, device)):
            xloc = xc[g.pc][cpos].reshape(len(cpos), ncomp, -1)
            # every fine element belongs to one group: rows are set once
            xf[g.pf][fpos] = (xloc @ T.T).reshape(len(fpos), -1)
        return xf

    def restrict(self, rf: dict, dtype=torch.float64, ncomp: int = 1) -> dict:
        device = next(iter(rf.values())).device
        rc = {p: torch.zeros((self.coarse.bucket_size(p),
                              ncomp * self.coarse.n_local(p)),
                             dtype=dtype, device=device)
              for p in self.coarse.bucket_degrees}
        for g, (fpos, cpos, T) in zip(self.groups, self._tensors(dtype, device)):
            rloc = rf[g.pf][fpos].reshape(len(fpos), ncomp, -1)
            # h-transfer: 2^dim children add into one parent row, one per
            # group, so coarse_pos is unique within a group and index_add_
            # never collides inside a call
            rc[g.pc].index_add_(0, cpos, (rloc @ T).reshape(len(cpos), -1))
        return rc

    # ------------------------------------------------------------------
    def _galerkin_plan(self, A: BlockSparseMatrix):
        """Symbolic phase of the Galerkin product, cached per fine
        pattern object: the coarse pattern plus per work item the fine
        key, the fine entries ``sel``, the two groups, the coarse key and
        the coarse ``slots``.  Repeated products with the same sparsity
        run the numeric phase only and return the SAME coarse pattern
        object."""
        ckey = (A.pattern, A.block_shape)
        if ckey in self._gcache:
            return self._gcache[ckey]
        fine, coarse = self.fine, self.coarse
        ngroups = len(self.groups)
        per_key = {}  # (prc, pcc) -> list of code arrays
        work = []  # (fine key, sel, gri, gci, coarse key, codes)
        for (pr, pc), (rows, cols) in A.pattern.entries.items():
            relems = fine.bucket_elems[pr][rows]
            celems = fine.bucket_elems[pc][cols]
            gr = self.group_of_fine[relems]
            gc = self.group_of_fine[celems]
            gcodes = gr.astype(np.int64) * ngroups + gc
            for gcode in np.unique(gcodes):
                sel = np.where(gcodes == gcode)[0]
                gri, gci = int(gcode) // ngroups, int(gcode) % ngroups
                Gr, Gc = self.groups[gri], self.groups[gci]
                key = (Gr.pc, Gc.pc)
                crow = coarse.elem_bucket_pos[self.coarse_elem[relems[sel]]]
                ccol = coarse.elem_bucket_pos[self.coarse_elem[celems[sel]]]
                ncol = coarse.bucket_size(key[1])
                codes = crow.astype(np.int64) * ncol + ccol
                per_key.setdefault(key, []).append(codes)
                work.append(((pr, pc), sel, gri, gci, key, codes))

        # dedup coarse entries per key (np.unique: sorted codes), then the
        # diagonal first in row order — the reference's entry order
        entries = {}
        slotmaps = {}  # key -> (sorted entry codes, slot of each)
        for key, code_lists in per_key.items():
            nrow = coarse.bucket_size(key[0])
            ncol = coarse.bucket_size(key[1])
            codes = np.concatenate(code_lists)
            if key[0] == key[1]:
                diag = np.arange(nrow, dtype=np.int64) * ncol + np.arange(nrow)
                uniq = np.unique(np.concatenate([diag, codes]))
                ordered = np.concatenate([diag, uniq[~np.isin(uniq, diag)]])
            else:
                ordered = np.unique(codes)
            entries[key] = ((ordered // ncol).astype(np.int32),
                            (ordered % ncol).astype(np.int32))
            order = np.argsort(ordered, kind="stable")
            slotmaps[key] = (ordered[order], order)

        row_sizes = {p: coarse.bucket_size(p) for p in coarse.bucket_degrees}
        pattern = BlockPattern(row_sizes, dict(row_sizes), entries,
                               diag_first=True)
        plan = []
        for (fkey, sel, gri, gci, key, codes) in work:
            sorted_codes, order = slotmaps[key]
            slots = order[np.searchsorted(sorted_codes, codes)]
            full = len(sel) == A.pattern.nnz(*fkey)  # sel == arange(nnz)
            plan.append((fkey, None if full else sel, gri, gci, key, slots))
        self._gcache[ckey] = (pattern, plan)
        return pattern, plan

    def galerkin(self, A: BlockSparseMatrix, dtype=torch.float64
                 ) -> BlockSparseMatrix:
        """Coarse matrix RtAR in ``dtype`` on the device of ``A``."""
        pattern, plan = self._galerkin_plan(A)
        device = next(iter(A.values.values())).device
        dkey = ((A.pattern, A.block_shape), device)
        if dkey not in self._gcache:
            ix = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
                a, dtype=torch.int64, device=device)
            self._gcache[dkey] = [(ix(sel), ix(slots))
                                  for (_, sel, _, _, _, slots) in plan]
        vals = zeros_values(pattern, self.fine.dim,
                            block_shape=A.block_shape, dtype=dtype,
                            device=device)
        cr, cc = A.block_shape
        Ts = {}
        for (fkey, _, gri, gci, key, _), (sel, slots) in zip(
                plan, self._gcache[dkey]):
            for gi in (gri, gci):
                if gi not in Ts:
                    Ts[gi] = torch.as_tensor(self.groups[gi].T, dtype=dtype,
                                             device=device)
            Tr, Tc = Ts[gri], Ts[gci]
            blocks = A.values[fkey] if sel is None else A.values[fkey][sel]
            nb = blocks.shape[0]
            blocks = blocks.to(dtype).reshape(nb, cr, Tr.shape[0], cc,
                                              Tc.shape[0])
            tr = torch.einsum("naibj,ik,jl->nakbl", blocks, Tr, Tc)
            vals[key].index_add_(0, slots, tr.reshape(
                nb, cr * Tr.shape[1], cc * Tc.shape[1]))
        return BlockSparseMatrix(pattern, self.fine.dim, vals,
                                 block_shape=A.block_shape)


# ---------------------------------------------------------------------------
def p_coarse_degrees(degrees: np.ndarray, max_order: int) -> np.ndarray:
    """Coarse degree map: min(k_e, max_order)."""
    return np.minimum(degrees, max_order).astype(np.int32)


def _build_groups(fine: DGBasis, coarse: DGBasis, coarse_elem: np.ndarray,
                  variant: np.ndarray, Tfun):
    """Group fine elements by (pf, pc, variant); Tfun(pf, pc, var) -> T.
    Returns (groups, group_of_fine)."""
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
    return tuple(groups), inv.astype(np.int32)


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

    groups, gof = _build_groups(fine, coarse, coarse_elem, variant, Tfun)
    return ElementTransfer(fine=fine, coarse=coarse, coarse_elem=coarse_elem,
                           groups=groups, group_of_fine=gof)


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

    groups, gof = _build_groups(fine, coarse, coarse_elem, variant, Tfun)
    return ElementTransfer(fine=fine, coarse=coarse, coarse_elem=coarse_elem,
                           groups=groups, group_of_fine=gof)
