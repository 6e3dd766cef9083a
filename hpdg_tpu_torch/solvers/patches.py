"""Colored overlapping vertex-patch (Schwarz) smoothers.

Port of ``hpdg_tpu.solvers.patches``.  A patch is the set of (up to)
2^dim elements sharing an interior lattice vertex; the patch solve
inverts the operator restricted to their dofs.  Patches are colored by
vertex parity, so same-color patches are element-disjoint and one color
is one batched ``[n, K] @ [K, K]`` product plus a collision-free
scatter.

* :class:`UniformPatchSmoother`: matrix-free operators on full uniform
  lattices; the (at most 3^dim) class inverses come from a tiny probe
  lattice assembled on the host.
* :class:`ClassPatchSmoother`: assembled matrices on full uniform
  lattices with class-deduplicated inverses.  Every member of a class
  is checked against the class representative on the device (the
  reference checks only the first and the last member).
* :func:`patch_smoother_step`: one inverse per patch (masked lattices).
* :func:`general_patch_smoother_step`: hanging nodes and mixed degrees.

Inverses are computed in f64 and held in the working dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.linalg.blockmatrix import BlockSparseMatrix, matvec

#: largest per-patch matrix store (bytes, f64) a smoother may build; above
#: it ``multigrid_solver`` falls back to colored block GS (one inverse per
#: patch at 24^3 elasticity would take ~41 GB)
PATCH_MEMORY_BUDGET = 2 << 30
#: relative tolerance of the class check, of the representative's
#: largest entry
CLASS_RTOL = 1e-10
#: bytes of patch matrices the class check gathers at a time
CHECK_CHUNK_BYTES = 1 << 29


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


def _corner_offsets(dim: int) -> np.ndarray:
    """Corner offsets in refine()'s child_pos convention: bit (dim-1-a)
    of c gives the high/low side along axis a."""
    k = 1 << dim
    return np.array([[(c >> (dim - 1 - a)) & 1 for a in range(dim)]
                     for c in range(k)], dtype=np.int64)


def _lattice_vertices(cells) -> np.ndarray:
    """Interior lattice vertices in C order, ``[nv, dim]``."""
    return np.stack(np.meshgrid(*[np.arange(c - 1) for c in cells],
                                indexing="ij"), axis=-1).reshape(-1, len(cells))


def build_vertex_patches(mesh) -> list[np.ndarray]:
    """Vertex patches grouped by parity color.

    Returns a list of 2^dim int32 arrays ``[n_patches_c, 2^dim]`` of
    element ids, entry -1 where the lattice cell is absent (masked
    domains).  Every element is covered by at least one patch; colors
    are ordered by parity tuple (C order), patches by vertex (C order);
    elements no vertex patch covers get singleton patches at the end of
    color 0.
    """
    dim = mesh.dim
    coords, cells = lattice_coords(mesh)
    if any(c < 2 for c in cells):
        raise ValueError("vertex patches need >= 2 cells per axis")
    grid = np.full(cells, -1, dtype=np.int64)
    grid[tuple(coords.T)] = np.arange(mesh.n_elements)
    verts = _lattice_vertices(cells)
    offs = _corner_offsets(dim)
    els = grid[tuple((verts[:, None, :] + offs[None, :, :]).transpose(2, 0, 1))]
    keep = (els >= 0).any(axis=1)
    verts, els = verts[keep], els[keep].astype(np.int32)
    covered = np.zeros(mesh.n_elements, dtype=bool)
    covered[els[els >= 0]] = True
    color = (verts % 2) @ (2 ** np.arange(dim - 1, -1, -1))
    by_color = {int(c): [els[color == c]] for c in np.unique(color)}
    stranded = np.flatnonzero(~covered)
    if len(stranded):
        single = np.full((len(stranded), 1 << dim), -1, dtype=np.int32)
        single[:, 0] = stranded
        by_color.setdefault(0, []).append(single)
    return [np.concatenate(by_color[c]) for c in sorted(by_color)]


def gather_patch_matrices(A: BlockSparseMatrix, basis, els: np.ndarray,
                          dtype=None) -> torch.Tensor:
    """Patch operators ``[n, K, K]`` of a uniform-degree matrix on its
    device: A restricted to the dofs of each row of ``els`` (element ids,
    -1 absent), K = k * block size.  Blocks the pattern lacks are zero
    (vertex-diagonal element pairs share no face); absent elements get
    an identity lane."""
    (p,) = basis.bucket_degrees
    vals = A.values[(p, p)]
    dtype = dtype or vals.dtype
    n, k = els.shape
    bs = vals.shape[1]
    pos = basis.elem_bucket_pos
    ea = np.broadcast_to(els[:, :, None], (n, k, k))
    eb = np.broadcast_to(els[:, None, :], (n, k, k))
    valid = (ea >= 0) & (eb >= 0)
    slots = np.full((n, k, k), -1, dtype=np.int64)
    slots[valid] = A.pattern.lookup(p, p, pos[ea[valid]], pos[eb[valid]])
    s = torch.as_tensor(slots, device=vals.device)
    M = vals[s.clamp(min=0)].to(dtype) * (s >= 0)[..., None, None].to(dtype)
    M = M.permute(0, 1, 3, 2, 4).reshape(n, k * bs, k * bs)
    missing = np.argwhere(els < 0)
    if len(missing):
        eye = torch.eye(bs, dtype=dtype, device=vals.device)
        for i, a in missing:
            M[i, a * bs:(a + 1) * bs, a * bs:(a + 1) * bs] = eye
    return M


def patch_inverses(A: BlockSparseMatrix, basis, colors: list[np.ndarray],
                   dtype=torch.float64, device=None) -> list:
    """Per color: the dense inverse of every patch operator
    (:func:`gather_patch_matrices`), inverted in f64; returns
    ``[n_patches_c, K, K]`` tensors in ``dtype`` on ``device``."""
    device = dev.resolve(device)
    return [torch.linalg.inv(gather_patch_matrices(
        A, basis, els, dtype=torch.float64)).to(device=device, dtype=dtype)
        for els in colors]


def patch_store_bytes(A: BlockSparseMatrix, basis, colors) -> int:
    """f64 bytes of one inverse per patch (for ``PATCH_MEMORY_BUDGET``)."""
    (p,) = basis.bucket_degrees
    K = colors[0].shape[1] * A.br(p)
    return sum(len(els) for els in colors) * K * K * 8


def patch_smoother_step(A: BlockSparseMatrix, basis,
                        colors: list[np.ndarray] | None = None,
                        invs: list | None = None,
                        damping: float = 1.0, reverse: bool = False,
                        dtype=torch.float64):
    """Multiplicative colored vertex-patch sweep with one inverse per
    patch: ``step(x, b) -> x``.  Per color: fresh residual, batched patch
    solve, collision-free scatter-add (same-color patches are
    element-disjoint); ``reverse`` runs the colors backward."""
    if colors is None:
        colors = build_vertex_patches(basis.mesh)
    device = next(iter(A.values.values())).device
    if invs is None:
        invs = patch_inverses(A, basis, colors, dtype=dtype, device=device)
    (p,) = basis.bucket_degrees
    pos = basis.elem_bucket_pos
    prepared = []
    for els, inv in zip(colors, invs):
        bpos = np.where(els >= 0, pos[np.maximum(els, 0)], 0)
        valid = torch.as_tensor(els >= 0, device=device)[..., None]
        prepared.append((torch.as_tensor(bpos, dtype=torch.int64,
                                         device=device), valid, inv))
    if reverse:
        prepared = prepared[::-1]

    def step(x: dict, b: dict) -> dict:
        for bpos, valid, inv in prepared:
            r = bv.sub(b, matvec(A, x))
            npat, k = bpos.shape
            bs = r[p].shape[1]
            rg = (r[p][bpos] * valid).reshape(npat, k * bs, 1)
            y = torch.bmm(inv, rg).reshape(npat, k, bs) * valid
            x = {p: x[p].index_add(0, bpos.reshape(-1),
                                   (damping * y).reshape(-1, bs))}
        return x

    return step


class ClassPatchSmoother:
    """Vertex-patch sweeps with CLASS-DEDUPLICATED inverses for an
    assembled matrix on a full uniform lattice: :meth:`forward` and
    :meth:`backward` are ``step(x, b) -> x`` with the colors in parity
    order and reversed, sharing one set of inverses.

    With translation-invariant assembly every patch operator depends
    only on which patch faces touch the domain boundary, so at most
    3^dim distinct [K, K] inverses exist however large the level is.
    Invariance is VERIFIED: every member's patch matrix is gathered on
    the device (in chunks) and compared with its class representative's
    (the first member in vertex order) to ``CLASS_RTOL`` of the
    representative's largest entry; a mismatch raises ValueError.
    The representatives are inverted in f64 and cast to ``dtype``.
    """

    def __init__(self, A: BlockSparseMatrix, basis, damping: float = 1.0,
                 dtype=torch.float64):
        mesh = basis.mesh
        dim = mesh.dim
        coords, cells = lattice_coords(mesh)
        if mesh.n_elements != int(np.prod(cells)):
            raise ValueError("class-dedup patches need a full box lattice")
        if any(c < 2 for c in cells):
            raise ValueError("vertex patches need >= 2 cells per axis")
        (p,) = basis.bucket_degrees
        vals = A.values[(p, p)]
        device = vals.device
        grid = np.empty(cells, dtype=np.int64)
        grid[tuple(coords.T)] = np.arange(mesh.n_elements)
        verts = _lattice_vertices(cells)
        offs = _corner_offsets(dim)
        els_all = grid[tuple((verts[:, None, :] + offs[None, :, :])
                             .transpose(2, 0, 1))]
        lo = verts == 0
        hi = verts == np.asarray(cells) - 2
        place = 2 ** np.arange(dim - 1, -1, -1)
        # parity color and boundary class, both in the reference's sorted
        # tuple order
        color = (verts % 2) @ place
        klass = (lo * 2 + hi) @ (place * place)

        k = 1 << dim
        bs = A.br(p)
        K = k * bs
        per_chunk = max(1, CHECK_CHUNK_BYTES // (K * K * vals.element_size()))
        inv_of, bad = {}, torch.zeros((), dtype=torch.bool, device=device)
        for kc in np.unique(klass):
            members = els_all[klass == kc]
            rep = gather_patch_matrices(A, basis, members[:1])[0]
            tol = CLASS_RTOL * rep.abs().max()
            for c0 in range(1, len(members), per_chunk):
                Mc = gather_patch_matrices(A, basis,
                                           members[c0:c0 + per_chunk])
                bad |= ((Mc - rep).abs().amax() > tol)
            inv = torch.linalg.inv(rep.double())
            inv_of[int(kc)] = inv.T.to(dtype).contiguous()  # y = r @ inv.T
        if bool(bad):  # the check's one device -> host sync
            raise ValueError("patch operators are not translation-"
                             "invariant; use per-patch inverses")
        pos = basis.elem_bucket_pos
        self.color_groups = []  # per color: list of (bucket pos [n, k], inv.T)
        for c in np.unique(color):
            self.color_groups.append([
                (torch.as_tensor(pos[els_all[(color == c) & (klass == kc)]],
                                 dtype=torch.int64, device=device),
                 inv_of[int(kc)])
                for kc in np.unique(klass[color == c])])
        self.A, self.p, self.bs, self.K = A, p, bs, K
        self.damping = damping

    def _sweep(self, color_groups, x: dict, b: dict) -> dict:
        p, bs, K = self.p, self.bs, self.K
        xp = x[p].clone()  # updated in place below; the caller's x stays
        for groups in color_groups:
            r = bv.sub(b, matvec(self.A, {p: xp}))
            for bpos, invT in groups:
                n = bpos.shape[0]
                y = r[p][bpos].reshape(n, K) @ invT
                # same-color patches are element-disjoint: collision-free
                xp.index_add_(0, bpos.reshape(-1), y.reshape(-1, bs),
                              alpha=self.damping)
        return {p: xp}

    def forward(self, x: dict, b: dict) -> dict:
        return self._sweep(self.color_groups, x, b)

    def backward(self, x: dict, b: dict) -> dict:
        return self._sweep(self.color_groups[::-1], x, b)


def class_patch_smoother_step(A: BlockSparseMatrix, basis,
                              damping: float = 1.0, reverse: bool = False,
                              dtype=torch.float64):
    """One class-deduplicated vertex-patch sweep ``step(x, b) -> x``
    (colors reversed when ``reverse``); see :class:`ClassPatchSmoother`."""
    sm = ClassPatchSmoother(A, basis, damping=damping, dtype=dtype)
    return sm.backward if reverse else sm.forward


# ---------------------------------------------------------------------------
def general_vertex_patches(mesh) -> list[list[np.ndarray]]:
    """Vertex patches on ARBITRARY box meshes, hanging nodes and mixed
    element sizes included.

    Anchors are all distinct element corners.  A patch holds the
    elements sharing the corner and every face-neighbor of those whose
    shared face contains the corner (at a hanging vertex: the coarse
    element the fine corners sit on).  Patches of fewer than 2 elements
    are dropped, then stranded elements get singleton patches.  Colors
    come from a greedy coloring of the patch-overlap graph (same-color
    patches share no element).  Returns colors as lists of
    variable-length element arrays.
    """
    n = mesh.n_elements
    dim = mesh.dim
    lo, ext = mesh.lower, mesh.extent
    eps = 1e-6 * ext.min()
    # per-axis quantum = half the smallest extent along that axis: under
    # 2:1 refinement every corner coordinate is an integer multiple of it
    quant = 0.5 * ext.min(axis=0)

    def qkey(pt):
        return tuple(np.rint(pt / quant).astype(np.int64))

    corners_of, anchor_pt = {}, {}
    k = 1 << dim
    offs = _corner_offsets(dim).astype(np.float64)
    pts = lo[:, None, :] + offs[None, :, :] * ext[:, None, :]  # [n, k, dim]
    for e in range(n):
        for c in range(k):
            key = qkey(pts[e, c])
            corners_of.setdefault(key, set()).add(e)
            anchor_pt[key] = pts[e, c]
    efaces = [[] for _ in range(n)]
    fi, fo = mesh.faces.inside, mesh.faces.outside
    for i in range(len(mesh.faces)):
        efaces[int(fi[i])].append(i)
        efaces[int(fo[i])].append(i)

    def face_box(i):
        a, b = int(fi[i]), int(fo[i])
        return (np.maximum(lo[a], lo[b]),
                np.minimum(lo[a] + ext[a], lo[b] + ext[b]))

    patches = []
    covered = np.zeros(n, dtype=bool)
    seen_sets = set()
    for key, els in corners_of.items():
        v = anchor_pt[key]
        grow = set(els)
        for e in list(els):
            for i in efaces[e]:
                blo, bhi = face_box(i)
                if np.all(v >= blo - eps) and np.all(v <= bhi + eps):
                    grow.add(int(fi[i]))
                    grow.add(int(fo[i]))
        if len(grow) < 2:
            continue
        sig = tuple(sorted(grow))
        if sig in seen_sets:
            continue
        seen_sets.add(sig)
        patches.append(np.asarray(sig, dtype=np.int32))
        covered[patches[-1]] = True
    for e in np.nonzero(~covered)[0]:
        patches.append(np.asarray([e], dtype=np.int32))
    owner = {}
    colors: list[list[np.ndarray]] = []
    for pa in patches:
        used = {c for e in pa for c in owner.get(int(e), ())}
        c = 0
        while c in used:
            c += 1
        while c >= len(colors):
            colors.append([])
        colors[c].append(pa)
        for e in pa:
            owner.setdefault(int(e), []).append(c)
    return colors


def general_store_bytes(A: BlockSparseMatrix, basis, colors) -> int:
    """f64 bytes of the per-patch inverses of the general sweep."""
    ncomp, dim = A.block_shape[0], basis.mesh.dim
    total = 0
    for color in colors:
        for pa in color:
            K = sum(ncomp * (int(basis.degrees[e]) + 1) ** dim for e in pa)
            total += K * K * 8
    return total


def general_patch_smoother_step(A: BlockSparseMatrix, basis,
                                colors: list[list[np.ndarray]] | None = None,
                                damping: float = 1.0,
                                reverse: bool = False, dtype=torch.float64):
    """Multiplicative colored vertex-patch sweep on GENERAL meshes
    (hanging nodes, mixed degrees): ``step(x, b) -> x``.

    Within a color, patches are grouped by their lane-degree signature,
    so every group is one batched solve; lanes gather from and scatter
    into their own degree buckets.  One inverse per patch, f64."""
    if colors is None:
        colors = general_vertex_patches(basis.mesh)
    device = next(iter(A.values.values())).device
    pos = basis.elem_bucket_pos
    degs = basis.degrees
    ix = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                   device=device)

    prepared = []  # per color: list of (inv, lanes)
    for color in colors:
        by_sig = {}
        for pa in color:
            by_sig.setdefault(tuple(int(degs[e]) for e in pa), []).append(pa)
        groups = []
        for sig, pas in sorted(by_sig.items()):
            E = np.stack(pas)  # [npat, k]
            npat, k = E.shape
            sizes = [A.br(q) for q in sig]
            offs = np.concatenate([[0], np.cumsum(sizes)])
            M = torch.zeros((npat, int(offs[-1]), int(offs[-1])),
                            dtype=torch.float64, device=device)
            for a in range(k):
                for b2 in range(k):
                    key = (sig[a], sig[b2])
                    if key not in A.pattern.entries:
                        continue
                    s = A.pattern.lookup(*key, pos[E[:, a]], pos[E[:, b2]])
                    got = np.flatnonzero(s >= 0)
                    if len(got):
                        M[ix(got), offs[a]:offs[a + 1],
                          offs[b2]:offs[b2 + 1]] = \
                            A.values[key][ix(s[got])].double()
            inv = torch.linalg.inv(M).to(dtype)
            lanes = [(sig[a], ix(pos[E[:, a]]), int(offs[a]), sizes[a])
                     for a in range(k)]
            groups.append((inv, lanes))
        prepared.append(groups)
    if reverse:
        prepared = prepared[::-1]

    def step(x: dict, b: dict) -> dict:
        for groups in prepared:
            r = bv.sub(b, matvec(A, x))
            xn = dict(x)
            for inv, lanes in groups:
                rg = torch.cat([r[q][idx] for (q, idx, o, s) in lanes], dim=1)
                y = torch.bmm(inv, rg.unsqueeze(-1)).squeeze(-1)
                for (q, idx, o, s) in lanes:
                    xn[q] = xn[q].index_add(0, idx, damping * y[:, o:o + s])
            x = xn
        return x

    return step


# ---------------------------------------------------------------------------
class UniformPatchSmoother:
    """Vertex-patch sweeps for a MATRIX-FREE operator on a full uniform
    box lattice: :meth:`forward` and :meth:`backward` are
    ``step(x, b) -> x`` with the colors in parity order and reversed.

    ``op`` is any dict -> dict apply; the level operator is never
    assembled.  The class inverses come from a probe lattice (at most 4
    cells per axis at the same h), assembled on the host in f64, and are
    shared by both directions.
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
        offs = _corner_offsets(dim)
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

        verts = _lattice_vertices(cells)
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
