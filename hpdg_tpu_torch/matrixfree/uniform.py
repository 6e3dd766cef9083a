"""Uniform-mesh SIPG apply: the dense stencil and the factorized form.

Port of ``hpdg_tpu.matrixfree.uniform``.  On a mesh with uniform degree
and uniform element extents every face's four block matrices are the
same, and the bulk block is one fixed matrix, so

    y[e] = Tdiag[vid[e]] u[e] + sum_ax ( M12_ax u[nbr+_ax(e)] + M21_ax u[nbr-_ax(e)] )

where ``vid[e]`` picks one of at most 3^dim diagonal variants (which
neighbours exist, and the Dirichlet terms where they do not).

* :func:`uniform_sipg_operator` applies that stencil in plain PyTorch.
  It is the twin of the CUDA kernel in ``ops.uniform_stencil`` (same
  host-built f64 matrices, :func:`stencil_tables`): the kernel's wrapper
  runs it for CPU tensors, and the tests and ``chip_smoke.py`` hold the
  kernel against it.
* :func:`uniform_sipg_factorized` is the exactly separable form
  ``A = sum_ax L_ax (x) Mm (x) ... (x) Mm`` — the same operator to f64
  roundoff by a different algorithm, with ~12x fewer FLOPs at p=4 in 3D.
  The refinement solve uses it in f64 as its residual anchor on the
  card and for the final verification on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis import lagrange, tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis


def _sym(M):
    return M + M.T


def _check_uniform(basis: DGBasis, what: str):
    mesh = basis.mesh
    if len(basis.bucket_degrees) != 1:
        raise ValueError(f"{what} needs a single degree")
    if not np.allclose(mesh.extent, mesh.extent[0]):
        raise ValueError(f"{what} needs uniform extents")
    if getattr(mesh, "jac", None) is not None \
            or getattr(mesh, "corners", None) is not None:
        raise ValueError(f"{what}: general geometry unsupported "
                         "(axis-aligned lattices only)")
    if len(mesh.faces.inside) and np.any(mesh.faces.nc_code != 0):
        raise ValueError(f"{what}: conforming meshes only")


@dataclass(frozen=True)
class StencilTables:
    """Host-side (numpy f64) data of the uniform SIPG stencil.

    ``Tdiag[k]`` is the diagonal block of variant k; ``M12[ax]`` /
    ``M21[ax]`` couple an element to its +ax / -ax neighbour;
    ``has_p``/``has_m`` ``[dim, n]`` say which neighbours exist and
    ``nbr_p``/``nbr_m`` name them (-1 where absent); ``variants`` holds
    each variant's code (per axis, slowest first: 2*has_p + has_m).
    """

    p: int
    dim: int
    Tdiag: np.ndarray  # (nvar, bs, bs)
    M12: np.ndarray  # (dim, bs, bs)
    M21: np.ndarray  # (dim, bs, bs)
    variants: np.ndarray  # (nvar,) int64 codes
    vid: np.ndarray  # (n,) variant of each element
    has_p: np.ndarray  # (dim, n) bool
    has_m: np.ndarray  # (dim, n) bool
    nbr_p: np.ndarray  # (dim, n) int32, -1 where no +ax neighbour
    nbr_m: np.ndarray  # (dim, n) int32

    @property
    def bs(self) -> int:
        return self.Tdiag.shape[1]


def stencil_tables(basis: DGBasis, penalty: float = 2.0,
                   dirichlet: bool = False,
                   penalty_scaling: str = "measure") -> StencilTables:
    """The fixed matrices of the uniform SIPG stencil, in f64 on the host
    (``hpdg_tpu.matrixfree.uniform.uniform_sipg_operator``'s
    construction, which ``pallas_uniform.py`` repeats)."""
    _check_uniform(basis, "uniform operator")
    mesh = basis.mesh
    dim = mesh.dim
    p = basis.bucket_degrees[0]
    h = mesh.extent[0]
    detJ = float(np.prod(h))
    n = mesh.n_elements
    bs = (p + 1) ** dim

    vt = tensor.volume_tables(p, dim, p + 2, family=basis.family)
    G, w = vt["G"], vt["weights"]
    T_bulk = np.einsum("q,a,aiq,ajq->ij", w, detJ / h**2, G, G)

    M11 = {}; M12 = {}; M22 = {}; MB = {}  # noqa: E702
    for ax in range(dim):
        fmeas = detJ / h[ax]
        if penalty_scaling == "measure":
            pen = penalty * p**2
        elif penalty_scaling == "normal":
            pen = penalty * p**2 * fmeas / h[ax]
        else:
            raise ValueError(penalty_scaling)
        fin = tensor.face_tables(p, dim, ax, 1, p + 2, family=basis.family)
        fout = tensor.face_tables(p, dim, ax, 0, p + 2, family=basis.family)
        wf = fin["weights"]
        c = -0.5 * fmeas / h[ax]
        AVDi = np.einsum("iq,q,jq->ij", fin["V"], wf, fin["Dn"])
        AVDo = np.einsum("iq,q,jq->ij", fout["V"], wf, fout["Dn"])
        BVVi = np.einsum("iq,q,jq->ij", fin["V"], wf, fin["V"])
        BVVo = np.einsum("iq,q,jq->ij", fout["V"], wf, fout["V"])
        X1 = np.einsum("iq,q,jq->ij", fin["V"], wf, fout["Dn"])
        X2 = np.einsum("iq,q,jq->ij", fin["Dn"], wf, fout["V"])
        X3 = np.einsum("iq,q,jq->ij", fin["V"], wf, fout["V"])
        M11[ax] = c * _sym(AVDi) + pen * BVVi
        M22[ax] = -c * _sym(AVDo) + pen * BVVo
        M12[ax] = c * X1 - c * X2 - pen * X3
        for side in (0, 1):
            ft = fout if side == 0 else fin
            sign = 1.0 if side == 1 else -1.0
            AVD = np.einsum("iq,q,jq->ij", ft["V"], wf, ft["Dn"])
            BVV = np.einsum("iq,q,jq->ij", ft["V"], wf, ft["V"])
            MB[(ax, side)] = (-sign * fmeas / h[ax]) * _sym(AVD) + pen * BVV

    nbr_p = np.full((dim, n), -1, dtype=np.int32)
    nbr_m = np.full((dim, n), -1, dtype=np.int32)
    f = mesh.faces
    nbr_p[f.axis, f.inside] = f.outside
    nbr_m[f.axis, f.outside] = f.inside
    has_p = nbr_p >= 0
    has_m = nbr_m >= 0
    code = np.zeros(n, dtype=np.int64)
    for ax in range(dim):
        code = code * 4 + has_p[ax] * 2 + has_m[ax]
    variants, vid = np.unique(code, return_inverse=True)
    Tdiag = np.zeros((len(variants), bs, bs))
    for k, cde in enumerate(variants):
        M = T_bulk.copy()
        cc = int(cde)
        for ax in range(dim - 1, -1, -1):
            hm = cc % 2
            hp = (cc // 2) % 2
            cc //= 4
            M += M11[ax] if hp else (MB[(ax, 1)] if dirichlet else 0.0)
            M += M22[ax] if hm else (MB[(ax, 0)] if dirichlet else 0.0)
        Tdiag[k] = M
    M12a = np.stack([M12[ax] for ax in range(dim)])
    return StencilTables(p=p, dim=dim, Tdiag=Tdiag, M12=M12a,
                         M21=np.ascontiguousarray(M12a.transpose(0, 2, 1)),
                         variants=variants, vid=vid.reshape(-1),
                         has_p=has_p, has_m=has_m, nbr_p=nbr_p, nbr_m=nbr_m)


def uniform_sipg_operator(basis: DGBasis, penalty: float = 2.0,
                          dirichlet: bool = False, dtype=torch.float64,
                          penalty_scaling: str = "measure", device=None,
                          tables: StencilTables | None = None):
    """Plain PyTorch stencil apply ``{p: [n, bs]} -> {p: [n, bs]}``.

    Requires uniform degree and uniform element extents.  ``tables``
    reuses an existing :func:`stencil_tables` result.
    """
    device = dev.resolve(device)
    st = tables or stencil_tables(basis, penalty, dirichlet, penalty_scaling)
    p, dim = st.p, st.dim
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    as_i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731

    # matrices stored transposed: y = u @ M.T
    var_sel = [as_i(np.flatnonzero(st.vid == k))
               for k in range(len(st.variants))]
    Tdiag_t = [as_t(st.Tdiag[k].T) for k in range(len(st.variants))]
    M12_t = [as_t(st.M12[ax].T) for ax in range(dim)]
    M21_t = [as_t(st.M21[ax].T) for ax in range(dim)]
    # gather-safe neighbour ids (self where none; masked after)
    ar = np.arange(st.vid.shape[0])
    gp = [as_i(np.where(st.has_p[ax], st.nbr_p[ax], ar)) for ax in range(dim)]
    gm = [as_i(np.where(st.has_m[ax], st.nbr_m[ax], ar)) for ax in range(dim)]
    mp = [as_t(st.has_p[ax])[:, None] for ax in range(dim)]
    mm = [as_t(st.has_m[ax])[:, None] for ax in range(dim)]

    def apply(x):
        u = x[p]
        y = torch.empty_like(u)
        # the variants partition the elements: every row is set once
        for sel, Td in zip(var_sel, Tdiag_t):
            y[sel] = u[sel] @ Td
        for ax in range(dim):
            y = y + mp[ax] * (u[gp[ax]] @ M12_t[ax])
            y = y + mm[ax] * (u[gm[ax]] @ M21_t[ax])
        return {p: y}

    return apply


def _lattice_shape(mesh):
    """Recover the (c0, ..., cd-1) lattice shape of a FULL structured
    box mesh in C element order; raises ValueError otherwise."""
    h = mesh.extent[0]
    lo = mesh.lower.min(axis=0)
    ic = np.rint((mesh.lower - lo) / h).astype(np.int64)
    if not np.allclose(mesh.lower, lo + ic * h, atol=1e-12 * h.max()):
        raise ValueError("factorized operator: not a regular lattice")
    cells = tuple(int(c) + 1 for c in ic.max(axis=0))
    if int(np.prod(cells)) != mesh.n_elements:
        raise ValueError("factorized operator: lattice has holes")
    if not np.array_equal(np.ravel_multi_index(ic.T, cells),
                          np.arange(mesh.n_elements)):
        raise ValueError("factorized operator: element order is not "
                         "C-lattice order")
    return cells


def sipg_factor_blocks(basis: DGBasis, penalty: float = 2.0,
                       dirichlet: bool = False,
                       penalty_scaling: str = "measure"):
    """1D factor blocks of the exactly-separable uniform-lattice SIPG
    operator A = sum_ax L_ax (x) Mm (x) ... (x) Mm (numpy f64).

    Returns ``(cells, nb, Mm, D_int, D_lo, D_hi, F12, F21)`` with the
    line matrices as dicts keyed by axis; shared by
    :func:`uniform_sipg_factorized` and the native host apply
    (:func:`uniform_sipg_factorized_host`).
    """
    mesh = basis.mesh
    dim = mesh.dim
    p = basis.bucket_degrees[0]
    cells = _lattice_shape(mesh)
    h = mesh.extent[0]
    detJ = float(np.prod(h))
    nb = p + 1

    t1 = lagrange.tables(p, p + 2, family=basis.family)
    w1 = t1.qweights
    Mm = np.einsum("iq,q,jq->ij", t1.values, w1, t1.values)
    S = np.einsum("iq,q,jq->ij", t1.derivatives, w1, t1.derivatives)
    v0, v1 = t1.at0, t1.at1
    d0, d1 = t1.dat0, t1.dat1

    D_int = {}; D_lo = {}; D_hi = {}; F12 = {}; F21 = {}  # noqa: E702
    for ax in range(dim):
        fmeas = detJ / h[ax]
        if penalty_scaling == "measure":
            pen = penalty * p**2
        else:
            pen = penalty * p**2 * fmeas / h[ax]
        c = -0.5 * fmeas / h[ax]
        N11 = c * _sym(np.outer(v1, d1)) + pen * np.outer(v1, v1)
        N22 = -c * _sym(np.outer(v0, d0)) + pen * np.outer(v0, v0)
        F12[ax] = (c * np.outer(v1, d0) - c * np.outer(d1, v0)
                   - pen * np.outer(v1, v0))
        F21[ax] = F12[ax].T
        MB0 = (fmeas / h[ax]) * _sym(np.outer(v0, d0)) + pen * np.outer(v0, v0)
        MB1 = (-fmeas / h[ax]) * _sym(np.outer(v1, d1)) + pen * np.outer(v1, v1)
        bulk = (detJ / h[ax] ** 2) * S
        D_int[ax] = bulk + N11 + N22
        D_lo[ax] = bulk + N11 + (MB0 if dirichlet else 0.0)   # line start
        D_hi[ax] = bulk + (MB1 if dirichlet else 0.0) + N22   # line end
        if cells[ax] == 1:  # degenerate single-element line
            D_lo[ax] = bulk + (MB1 + MB0 if dirichlet else 0.0)
    return cells, nb, Mm, D_int, D_lo, D_hi, F12, F21


def uniform_sipg_factorized_host(basis: DGBasis, penalty: float = 2.0,
                                 dirichlet: bool = False,
                                 penalty_scaling: str = "measure"):
    """The native (C++/OpenMP) f64 factorized apply on the HOST: numpy
    ``(n_elements, nb^3)`` -> same.  3D full uniform lattices only;
    raises where the lattice does not qualify or ``g++`` is missing.
    The same operator to f64 roundoff as :func:`uniform_sipg_factorized`,
    the host residual of verified solves."""
    from hpdg_tpu_torch import native
    if basis.mesh.dim != 3:
        raise ValueError("native factorized apply is 3D-only")
    _check_uniform(basis, "factorized operator")
    cells, nb, Mm, D_int, D_lo, D_hi, F12, F21 = sipg_factor_blocks(
        basis, penalty, dirichlet, penalty_scaling)
    pack = lambda D: np.stack([D[ax] for ax in range(3)])  # noqa: E731
    return native.SipgFactApply3(cells, nb, Mm, pack(D_int), pack(D_lo),
                                 pack(D_hi), pack(F12), pack(F21))


def uniform_sipg_factorized(basis: DGBasis, penalty: float = 2.0,
                            dirichlet: bool = False, dtype=torch.float64,
                            penalty_scaling: str = "measure", device=None):
    """FLOP-minimal SIPG apply on a full uniform lattice.

    Per axis: two transverse 1D mass contractions plus three nb x nb
    line contractions (interior, line ends, and the two neighbour
    couplings) — ~15 n nb^{d+1} MACs against (2 dim + 1) n nb^{2d} for
    the dense stencil.
    """
    _check_uniform(basis, "factorized operator")
    device = dev.resolve(device)
    mesh = basis.mesh
    dim = mesh.dim
    p = basis.bucket_degrees[0]
    cells, nb, Mm, D_int, D_lo, D_hi, F12, F21 = sipg_factor_blocks(
        basis, penalty, dirichlet, penalty_scaling)
    as_t = lambda M: torch.as_tensor(M, dtype=dtype, device=device)  # noqa: E731
    Mm_t = as_t(Mm)
    D_int_t = [as_t(D_int[ax]) for ax in range(dim)]
    D_lo_t = [as_t(D_lo[ax]) for ax in range(dim)]
    D_hi_t = [as_t(D_hi[ax]) for ax in range(dim)]
    F12_t = [as_t(F12[ax]) for ax in range(dim)]
    F21_t = [as_t(F21[ax]) for ax in range(dim)]
    shape = tuple(cells) + (nb,) * dim

    def contract(t, M, local_ax):
        # contract local axis `dim + local_ax` with M's second index
        out = torch.tensordot(t, M, dims=([dim + local_ax], [1]))
        return torch.movedim(out, -1, dim + local_ax)

    def apply(x):
        u = x[p].reshape(shape)
        y = torch.zeros_like(u)
        for ax in range(dim):
            t = u
            for tax in range(dim):
                if tax != ax:
                    t = contract(t, Mm_t, tax)
            nax = cells[ax]
            if nax > 1:
                ya = contract(t, D_int_t[ax], ax)
                sl_lo = (slice(None),) * ax + (slice(0, 1),)
                sl_hi = (slice(None),) * ax + (slice(nax - 1, nax),)
                ya[sl_lo] = contract(t[sl_lo], D_lo_t[ax], ax)
                ya[sl_hi] = contract(t[sl_hi], D_hi_t[ax], ax)
                sl_up = (slice(None),) * ax + (slice(1, None),)
                sl_dn = (slice(None),) * ax + (slice(0, -1),)
                ya[sl_dn] += contract(t[sl_up], F12_t[ax], ax)
                ya[sl_up] += contract(t[sl_dn], F21_t[ax], ax)
            else:
                ya = contract(t, D_lo_t[ax], ax)
            y = y + ya
        return {p: y.reshape(mesh.n_elements, nb ** dim)}

    return apply
