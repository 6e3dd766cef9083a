"""Colored vertex-patch (Schwarz) smoothing on uniform box lattices.

Port of the matrix-free path of ``hpdg_tpu.solvers.patches``.  A patch
is the set of 2^dim elements sharing an interior lattice vertex; the
patch solve inverts the SIPG operator restricted to their dofs.  Patches
are colored by vertex parity, so same-color patches are element-disjoint
and one color is one batched ``[n, K] @ [K, K]`` product plus a
collision-free scatter.

On a uniform lattice with constant coefficients a patch operator only
depends on which patch faces touch the domain boundary, so the (at most
3^dim) distinct inverses come from a tiny probe lattice, assembled and
inverted on the host in f64 and held on the device in the working dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.linalg.blockmatrix import BlockSparseMatrix


def lattice_coords(mesh) -> tuple[np.ndarray, tuple]:
    """Integer lattice coordinates of each element (host).

    Requires a uniform lattice: every element the same extent.  Raises
    ValueError otherwise.
    """
    ext = mesh.extent
    if not np.allclose(ext, ext[0], rtol=1e-12, atol=0.0):
        raise ValueError("vertex patches need a uniform element lattice")
    lo = mesh.lower.min(axis=0)
    coords = (mesh.lower - lo) / ext[0]
    icoords = np.rint(coords).astype(np.int64)
    if not np.allclose(coords, icoords, atol=1e-9):
        raise ValueError("elements do not sit on a uniform lattice")
    return icoords.astype(np.int32), tuple(icoords.max(axis=0) + 1)


def patch_inverses(A: BlockSparseMatrix, basis, colors: list[np.ndarray],
                   dtype=torch.float64, device=None) -> list:
    """Per color: the dense inverse of every patch operator.

    Patch operator = A restricted to the patch's element dofs (the
    vertex-diagonal element pairs share no face, so their coupling is
    structurally zero).  Absent elements (-1) get an identity lane.
    Inverted on the host in f64; returns ``[n_patches_c, K, K]`` tensors.
    """
    device = dev.resolve(device)
    (p,) = basis.bucket_degrees  # uniform degree only
    vals = A.values[(p, p)].detach().cpu().numpy()
    bs = vals.shape[1]
    slot_ix = A.pattern._slot_index((p, p))
    pos = basis.elem_bucket_pos
    out = []
    for els in colors:
        npat, k = els.shape
        K = k * bs
        M = np.zeros((npat, K, K), dtype=vals.dtype)
        for a in range(k):
            for b in range(k):
                ea, eb = els[:, a], els[:, b]
                valid = (ea >= 0) & (eb >= 0)
                slots = np.full(npat, -1, dtype=np.int64)
                for i in np.nonzero(valid)[0]:
                    s = slot_ix.get((int(pos[ea[i]]), int(pos[eb[i]])))
                    if s is not None:
                        slots[i] = s
                got = slots >= 0
                if got.any():
                    M[got, a * bs:(a + 1) * bs, b * bs:(b + 1) * bs] = \
                        vals[slots[got]]
            missing = els[:, a] < 0
            if missing.any():
                rng = np.arange(a * bs, (a + 1) * bs)
                M[np.ix_(np.nonzero(missing)[0], rng, rng)] = np.eye(bs)
        out.append(torch.as_tensor(np.linalg.inv(M), dtype=dtype,
                                   device=device))
    return out


class UniformPatchSmoother:
    """Vertex-patch sweeps for a MATRIX-FREE operator on a full uniform
    box lattice: :meth:`forward` and :meth:`backward` are
    ``step(x, b) -> x`` with the colors in parity order and reversed.

    ``op`` is any dict -> dict apply; the level operator is never
    assembled.  The class inverses are built once and shared by both
    directions.
    """

    def __init__(self, op, basis, penalty: float, dirichlet: bool = True,
                 penalty_scaling: str = "measure", dtype=torch.float64,
                 device=None):
        from hpdg_tpu_torch.mesh import structured
        from hpdg_tpu_torch.assemble.sipg import assemble_laplace
        from hpdg_tpu_torch.basis.dgbasis import DGBasis

        device = dev.resolve(device)
        mesh = basis.mesh
        dim = mesh.dim
        (p,) = basis.bucket_degrees
        _, cells = lattice_coords(mesh)
        if mesh.n_elements != int(np.prod(cells)):
            raise ValueError("uniform patch smoother needs a full box "
                             "lattice")
        if any(c < 2 for c in cells):
            raise ValueError("vertex patches need >= 2 cells per axis")
        h = mesh.extent[0]

        # probe lattice: smallest box exhibiting every boundary class of
        # the real lattice along each axis (4 cells give low/interior/
        # high; 3 give low/high-only; 2 the degenerate low==high vertex)
        pcells = tuple(min(int(c), 4) for c in cells)
        pmesh = structured(pcells, upper=tuple(c * hh
                                               for c, hh in zip(pcells, h)))
        pbasis = DGBasis(pmesh, np.full(pmesh.n_elements, p, dtype=np.int32))
        Ap = assemble_laplace(pbasis, penalty=penalty, dirichlet=dirichlet,
                              penalty_scaling=penalty_scaling,
                              dtype=torch.float64, device="cpu")

        k = 1 << dim
        # corner offsets in refine()'s child_pos convention: bit
        # (dim-1-a) of c gives the high/low side along axis a
        offs = np.array([[(c >> (dim - 1 - a)) & 1 for a in range(dim)]
                         for c in range(k)], dtype=np.int64)
        strides = np.array([int(np.prod(cells[a + 1:])) for a in range(dim)],
                           dtype=np.int64)
        pstrides = np.array([int(np.prod(pcells[a + 1:]))
                             for a in range(dim)], dtype=np.int64)

        inv_cache = {}

        def class_inv(key):
            # representative probe vertex for a class: low -> 0, high ->
            # pcells-2, interior -> 1 (exists iff the real axis has one)
            if key not in inv_cache:
                pv = np.array([0 if lo else (pcells[a] - 2 if hi else 1)
                               for a, (lo, hi) in enumerate(key)])
                els = ((pv[None, :] + offs) @ pstrides).astype(np.int32)
                inv = patch_inverses(Ap, pbasis, [els[None, :]],
                                     dtype=dtype, device=device)[0][0]
                inv_cache[key] = inv.T.contiguous()  # y = r @ inv.T
            return inv_cache[key]

        verts = np.stack(np.meshgrid(*[np.arange(c - 1) for c in cells],
                                     indexing="ij"), axis=-1).reshape(-1, dim)
        lo = verts == 0
        hi = verts == np.asarray(cells) - 2
        place = 2 ** np.arange(dim - 1, -1, -1)
        # parity color in sorted tuple order; boundary class (lo, hi) per axis
        color = (verts % 2) @ place
        klass = (lo * 2 + hi) @ (place * place)
        els_all = (verts[:, None, :] + offs[None, :, :]) @ strides  # [nv, k]
        self.color_groups = []  # per color: list of (els [n, k], inv.T)
        for c in np.unique(color):
            groups = []
            for kc in np.unique(klass[color == c]):
                sel = np.flatnonzero((color == c) & (klass == kc))
                key = tuple((bool(lo[sel[0], a]), bool(hi[sel[0], a]))
                            for a in range(dim))
                groups.append((torch.as_tensor(els_all[sel], dtype=torch.int64,
                                               device=device),
                               class_inv(key)))
            self.color_groups.append(groups)
        self.op = op
        self.p = p
        self.bs = basis.n_local(p)
        self.K = k * self.bs

    def _sweep(self, color_groups, x: dict, b: dict) -> dict:
        p, bs, K = self.p, self.bs, self.K
        xp = x[p].clone()  # updated in place below; the caller's x stays
        for groups in color_groups:
            r = bv.sub(b, self.op({p: xp}))
            for els, invT in groups:
                n = els.shape[0]
                y = r[p][els].reshape(n, K) @ invT
                # same-color patches are element-disjoint: no index
                # repeats, so the in-place add is collision-free
                xp.index_add_(0, els.reshape(-1), y.reshape(-1, bs))
        return {p: xp}

    def forward(self, x: dict, b: dict) -> dict:
        return self._sweep(self.color_groups, x, b)

    def backward(self, x: dict, b: dict) -> dict:
        return self._sweep(self.color_groups[::-1], x, b)


def uniform_patch_smoother(op, basis, penalty: float,
                           dirichlet: bool = True,
                           penalty_scaling: str = "measure",
                           reverse: bool = False, dtype=torch.float64,
                           device=None):
    """One vertex-patch sweep ``step(x, b) -> x`` (colors reversed when
    ``reverse``); see :class:`UniformPatchSmoother`."""
    sm = UniformPatchSmoother(op, basis, penalty, dirichlet=dirichlet,
                              penalty_scaling=penalty_scaling, dtype=dtype,
                              device=device)
    return sm.backward if reverse else sm.forward
