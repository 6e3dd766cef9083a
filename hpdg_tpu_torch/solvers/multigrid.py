"""hp-multigrid: levels, the cycle, the assembled hierarchy and the
matrix-free solver.

Port of ``hpdg_tpu.solvers.multigrid``.  A level is a bundle of
callables (apply, pre/post smoother, restrict, prolong) and the cycle a
recursion over them (the reference's LevelOperations and
multigrid_impl).  Two entry points:

* :func:`multigrid_solver`: the ASSEMBLED hierarchy.  p-levels halve the
  max degree down to 1, then h-levels follow the mesh hierarchy (or the
  reverse with ``h_first``); coarse matrices are Galerkin products
  (``transfer.element``); smoothers are colored or lexicographic block
  GS, block Jacobi or vertex patches; the coarse solve is a dense
  Cholesky or colored block GS.
* :func:`parametric_cycle`: the V-cycle as a function of the level
  matrices, for hierarchies renewed every outer iteration (TNNMG's
  truncated systems); colored block GS and a block-Jacobi PCG coarse
  solve of fixed length.
* :func:`matrixfree_multigrid_solver`: the SIPG Laplacian with the
  sum-factorized apply as every non-coarse level's operator, or, when
  asked with ``use_kernel``, the uniform stencil (``ops.uniform_stencil``:
  the CUDA kernel on the card, its plain twin on the CPU), smoothed by
  vertex patches or block-Jacobi Chebyshev.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.solvers import patches as pat
from hpdg_tpu_torch.solvers import smoothers as sm
from hpdg_tpu_torch.transfer import h_transfer, p_transfer

#: largest patch operator (dofs) a patch smoother inverts; larger levels
#: smooth otherwise (the reference's limit)
PATCH_MAX_BLOCK = 1024
#: largest coarse level (dofs) solved by the dense Cholesky under
#: ``coarse="auto"``; larger ones take colored block GS
DENSE_COARSE_MAX = 6000


@dataclass
class Level:
    """Operations of one multigrid level (LevelOperations analog)."""

    apply: Callable  # x -> A x
    pre_smooth: Callable | None  # (x, b) -> x, one step
    post_smooth: Callable | None
    restrict: Callable | None = None  # residual -> coarser level
    prolong: Callable | None = None  # coarser correction -> this level
    pre_steps: int = 3
    post_steps: int = 3


def vcycle(levels: list, coarse_solve: Callable, x: dict, b: dict,
           mu: int = 1) -> dict:
    """One multigrid cycle (V for ``mu=1``, W for 2) on the finest level.

    levels[0] is the coarsest (never smoothed); coarse_solve(b) -> x
    solves it.
    """

    def run(l: int, x, b):
        if l == 0:
            return coarse_solve(b)
        L = levels[l]
        for _ in range(L.pre_steps):
            x = L.pre_smooth(x, b)
        r = bv.sub(b, L.apply(x))
        rc = L.restrict(r)
        xc = bv.zeros_like(rc)
        for _ in range(mu):
            xc = run(l - 1, xc, rc)
        x = bv.add(x, L.prolong(xc))
        for _ in range(L.post_steps):
            x = L.post_smooth(x, b)
        return x

    return run(len(levels) - 1, x, b)


@dataclass
class MultigridData:
    """Matrices and transfers of the hierarchy, coarsest first;
    ``smoothers`` names what :func:`multigrid_solver` built on each
    level and ``coarse`` its coarse solve."""

    bases: list
    matrices: list  # BlockSparseMatrix per level
    transfers: list  # transfers[l] maps level l+1 -> level l
    smoothers: list = field(default_factory=list)
    coarse: str = ""

    def renew(self, A_fine: bm.BlockSparseMatrix, dtype=torch.float64):
        """Re-Galerkin-restrict all coarse matrices after the fine
        matrix changed (the symbolic plans are cached, so the coarse
        patterns are the same objects)."""
        self.matrices[-1] = A_fine
        cur = A_fine
        for l in range(len(self.transfers) - 1, -1, -1):
            cur = self.transfers[l].galerkin(cur, dtype=dtype)
            self.matrices[l] = cur
        return self


def setup_hierarchy(basis: DGBasis, A: bm.BlockSparseMatrix,
                    meshes: list | None = None,
                    coarse_bases: list | None = None, dtype=torch.float64,
                    h_first: bool = False) -> MultigridData:
    """Build the p+h hierarchy with Galerkin coarse matrices.

    p-levels: the max degree halves each level down to 1.  h-levels: if
    ``meshes`` (coarse-to-fine, ending with ``basis.mesh``) is given,
    grid transfers extend the hierarchy below p=1.  ``h_first=True``
    puts the h-levels at the top (at full degree) and the p-levels
    below, on the coarsest mesh (anisotropic semicoarsening chains).
    ``coarse_bases`` is accepted and not read, as in the reference, so
    that its positional calls build the same hierarchy here.
    """
    bases, matrices, transfers = [basis], [A], []
    cur, curA = basis, A

    def push(T, coarse_basis):
        nonlocal cur, curA
        curA = T.galerkin(curA, dtype=dtype)
        cur = coarse_basis
        bases.insert(0, cur)
        matrices.insert(0, curA)
        transfers.insert(0, T)

    def do_h():
        if meshes[-1] is not basis.mesh:
            raise ValueError("meshes must end with the basis' mesh")
        for coarse_mesh in reversed(list(meshes)[:-1]):
            cb = DGBasis(coarse_mesh,
                         np.full(coarse_mesh.n_elements, cur.max_degree(),
                                 dtype=np.int32), family=cur.family)
            push(h_transfer(cur, cb), cb)

    def do_p():
        order = cur.max_degree()
        while order > 1:
            order = max(1, order // 2)
            T = p_transfer(cur, order)
            push(T, T.coarse)

    if h_first and meshes is not None:
        do_h()
        do_p()
    else:
        do_p()
        if meshes is not None:
            do_h()
    return MultigridData(bases=bases, matrices=matrices, transfers=transfers)


def dense_coarse_solver(basis: DGBasis, A: bm.BlockSparseMatrix,
                        dtype=torch.float64, device=None):
    """Direct coarse solve: Cholesky factor computed once on the host in
    f64 (a dense inverse where the matrix is not SPD), the solves in
    ``dtype`` on ``device``."""
    device = dev.resolve(device)
    ncomp = A.block_shape[0]
    Ad = bm.to_dense(A, basis)
    Ad = torch.from_numpy(0.5 * (Ad + Ad.T))
    L, info = torch.linalg.cholesky_ex(Ad)
    if int(info) == 0:
        Lc = L.to(device=device, dtype=dtype)
        solve_dense = lambda f: torch.cholesky_solve(f[:, None], Lc)[:, 0]  # noqa: E731
    else:
        inv = torch.linalg.inv(Ad).to(device=device, dtype=dtype)
        solve_dense = lambda f: inv @ f  # noqa: E731

    idx = {p: torch.as_tensor(bv.flat_index(basis, p, ncomp), device=device)
           for p in basis.bucket_degrees}

    def solve(b: dict) -> dict:
        flat = torch.zeros(ncomp * basis.ndof, dtype=dtype, device=device)
        for p in basis.bucket_degrees:
            flat[idx[p]] = b[p].to(dtype)
        y = solve_dense(flat)
        return {p: y[idx[p]] for p in basis.bucket_degrees}

    return solve


def gs_coarse_solver(basis: DGBasis, A: bm.BlockSparseMatrix,
                     iterations: int = 40):
    """Coarse solve by ``iterations`` colored block-GS steps from zero
    (the reference's coarse Gauss-Seidel loop, colored)."""
    step = sm.colored_block_gs_step(A, basis)

    def solve(b: dict) -> dict:
        x = bv.zeros_like(b)
        for _ in range(iterations):
            x = step(x, b)
        return x

    return solve


def _patch_smoothers(M, bas, ncomp: int, dtype):
    """The ``patch`` branch's smoothers of one level: class-deduplicated
    inverses, else one inverse per patch, else the general-mesh patches,
    else colored block GS.  The per-patch paths are taken only while
    their f64 store stays within ``patches.PATCH_MEMORY_BUDGET``.
    Returns (pre, post, name)."""
    dim = bas.mesh.dim
    usable = len(bas.bucket_degrees) == 1
    if usable:
        (pd,) = bas.bucket_degrees
        usable = 2 ** dim * ncomp * (pd + 1) ** dim <= PATCH_MAX_BLOCK
    if usable:
        try:
            cps = pat.ClassPatchSmoother(M, bas, dtype=dtype)
            return cps.forward, cps.backward, f"class-patch K={cps.K}"
        except ValueError:
            pass
        try:
            cols = pat.build_vertex_patches(bas.mesh)
            if pat.patch_store_bytes(M, bas, cols) <= pat.PATCH_MEMORY_BUDGET:
                invs = pat.patch_inverses(
                    M, bas, cols, dtype=dtype,
                    device=next(iter(M.values.values())).device)
                return (pat.patch_smoother_step(M, bas, cols, invs,
                                                dtype=dtype),
                        pat.patch_smoother_step(M, bas, cols, invs,
                                                reverse=True, dtype=dtype),
                        "patch")
        except ValueError:
            pass
    try:
        gcols = pat.general_vertex_patches(bas.mesh)
        maxK = max(sum(ncomp * (int(bas.degrees[e]) + 1) ** dim for e in pa)
                   for color in gcols for pa in color)
        if maxK <= PATCH_MAX_BLOCK and pat.general_store_bytes(
                M, bas, gcols) <= pat.PATCH_MEMORY_BUDGET:
            return (pat.general_patch_smoother_step(M, bas, gcols,
                                                    dtype=dtype),
                    pat.general_patch_smoother_step(M, bas, gcols,
                                                    reverse=True,
                                                    dtype=dtype),
                    "general-patch")
    except ValueError:
        pass
    return (sm.colored_block_gs_step(M, bas),
            sm.colored_block_gs_step(M, bas, reverse=True), "gs")


def dgcg_coarse_solver(basis: DGBasis, A: bm.BlockSparseMatrix,
                       dtype=torch.float64):
    """The DG->CG conforming coarse path: one colored block-GS sweep
    from zero, the exact correction in the continuous space
    (``transfer.dgtocg.cg_coarse_solver``), two more GS sweeps."""
    from hpdg_tpu_torch.transfer.dgtocg import cg_coarse_solver
    cgc = cg_coarse_solver(basis, A, dtype=dtype)
    gs = sm.colored_block_gs_step(A, basis)

    def solve(b: dict) -> dict:
        x = gs(bv.zeros_like(b), b)
        x = bv.add(x, cgc(bv.sub(b, bm.matvec(A, x))))
        for _ in range(2):
            x = gs(x, b)
        return x

    return solve


def _line_smoothers(M, bas, omega: float, dtype):
    """The ``line`` branch's smoothers of one level: damped line-Jacobi
    along each axis whose mean extent is below 0.9 of the longest (the
    strong-coupling axes), else along the shortest; the pre-sweep takes
    the axes in order, the post-sweep reversed (ADI-style).  Returns
    (pre, post, name)."""
    from hpdg_tpu_torch.solvers.lines import line_solve, line_tridiag_factor
    ext = np.mean(bas.mesh.extent, axis=0)
    axes = [a for a in range(bas.mesh.dim)
            if ext[a] < 0.9 * ext.max()] or [int(np.argmin(ext))]
    device = next(iter(M.values.values())).device
    solves = [line_solve(line_tridiag_factor(M, bas, axis=a), dtype=dtype,
                         device=device) for a in axes]

    def sweeps(order):
        def step(x, b):
            for solve in order:
                r = bv.sub(b, bm.matvec(M, x))
                x = bv.add(x, bv.scale(omega, solve(r)))
            return x
        return step

    return sweeps(solves), sweeps(solves[::-1]), f"line axes={axes}"


def multigrid_solver(basis: DGBasis, A: bm.BlockSparseMatrix,
                     meshes: list | None = None, h_first: bool = False,
                     smoother: str = "gs", pre_steps: int = 3,
                     post_steps: int = 3, jacobi_damping: float = 0.6,
                     coarse: str = "auto", coarse_gs_iterations: int = 40,
                     operator_factory=None, penalty_matrix=None,
                     penalty_damping: float = 1.0, mu: int = 1,
                     dtype=torch.float64):
    """The assembled hp-multigrid cycle ``step(x, b) -> x``
    (MultigridSetup::multigridSolver analog) on the device of ``A``.
    Returns ``(step, data)``.

    ``smoother``: "gs" (colored block GS), "jacobi", "lex" (the
    reference-exact sequential sweep, forward pre / backward post),
    "patch" (vertex patches; see :func:`_patch_smoothers`) or "line"
    (damped line-Jacobi with exact block-Thomas solves along the short
    axes, ``solvers.lines``: one line solve per axis shorter than 0.9 of
    the longest mean extent, else along the shortest; the axes forward
    in the pre-sweep, reversed in the post-sweep).
    ``operator_factory(level_basis) -> matrix`` re-assembles the coarse
    operators instead of restricting them.  ``penalty_matrix`` with
    ``penalty_damping != 1`` splits A = A_cons + A_pen, restricts both
    and damps the penalty part by ``penalty_damping`` per level below
    the finest.  ``coarse``: "auto" (dense up to ``DENSE_COARSE_MAX``
    dofs, else "gs"), "dense", "gs" or "dgcg" (a GS sweep, the exact
    correction in the continuous space of ``transfer.dgtocg
    .cg_coarse_solver``, two GS sweeps).
    """
    if smoother not in ("gs", "jacobi", "lex", "patch", "line"):
        raise ValueError(smoother)
    device = next(iter(A.values.values())).device
    if penalty_matrix is not None and penalty_damping != 1.0:
        A_cons = bm.add_scaled(A, penalty_matrix, -1.0)
        data = setup_hierarchy(basis, A_cons, meshes=meshes, dtype=dtype,
                               h_first=h_first)
        datap = setup_hierarchy(basis, penalty_matrix, meshes=meshes,
                                dtype=dtype, h_first=h_first)
        top = len(data.matrices) - 1
        data.matrices = [
            bm.add_scaled(mc, mp, penalty_damping ** (top - l))
            for l, (mc, mp) in enumerate(zip(data.matrices, datap.matrices))]
    else:
        data = setup_hierarchy(basis, A, meshes=meshes, dtype=dtype,
                               h_first=h_first)
    if operator_factory is not None:
        data.matrices = [operator_factory(bas) for bas in data.bases[:-1]] \
            + [A]
    ncomp = A.block_shape[0]
    levels = []
    for l, (bas, M) in enumerate(zip(data.bases, data.matrices)):
        apply = (lambda MM: lambda x: bm.matvec(MM, x))(M)
        if l == 0:
            # the coarsest level is only solved, never smoothed
            levels.append(Level(apply=apply, pre_smooth=None,
                                post_smooth=None))
            continue
        if smoother == "gs":
            pre = sm.colored_block_gs_step(M, bas)
            post = sm.colored_block_gs_step(M, bas, reverse=True)
            name = "gs"
        elif smoother == "jacobi":
            pre = post = sm.block_jacobi_step(M, omega=jacobi_damping)
            name = "jacobi"
        elif smoother == "lex":
            lex = sm.LexicographicBlockGS(M, bas)
            pre, post, name = lex.forward, lex.backward, "lex"
        elif smoother == "line":
            pre, post, name = _line_smoothers(M, bas, jacobi_damping, dtype)
        else:
            pre, post, name = _patch_smoothers(M, bas, ncomp, dtype)
        data.smoothers.append(name)
        T = data.transfers[l - 1]
        levels.append(Level(
            apply=apply, pre_smooth=pre, post_smooth=post,
            restrict=(lambda TT: lambda r: TT.restrict(
                r, dtype=dtype, ncomp=ncomp))(T),
            prolong=(lambda TT: lambda c: TT.prolong(
                c, dtype=dtype, ncomp=ncomp))(T),
            pre_steps=pre_steps, post_steps=post_steps))

    cb, cA = data.bases[0], data.matrices[0]
    if coarse == "auto":
        coarse = "dense" if cb.ndof * ncomp <= DENSE_COARSE_MAX else "gs"
    if coarse == "dense":
        coarse_solve = dense_coarse_solver(cb, cA, dtype=dtype, device=device)
    elif coarse == "gs":
        coarse_solve = gs_coarse_solver(cb, cA,
                                        iterations=coarse_gs_iterations)
    elif coarse == "dgcg":
        coarse_solve = dgcg_coarse_solver(cb, cA, dtype=dtype)
    else:
        raise ValueError(coarse)
    data.coarse = coarse

    if len(levels) == 1:
        # one-level hierarchy: wrap the coarse solve in defect correction
        # so the step is a genuine iteration
        Af = data.matrices[-1]

        def step(x: dict, b: dict) -> dict:
            r = bv.sub(b, bm.matvec(Af, x))
            return bv.add(x, coarse_solve(r))
    else:
        def step(x: dict, b: dict) -> dict:
            return vcycle(levels, coarse_solve, x, b, mu=mu)

    return step, data


def parametric_cycle(data: MultigridData, pre_steps: int = 3,
                     post_steps: int = 3, coarse_cg_iters: int = 60,
                     dtype=torch.float64):
    """The V-cycle as a function of the level matrices.

    Returns ``cycle(mats, dinvs, x, b) -> x``: ``mats`` are the level
    matrices (coarsest first) and ``dinvs`` their inverse diagonal
    blocks.  Only the static structure (colorings, transfers) is built
    here, so a caller that renews the hierarchy every outer iteration
    (TNNMG's truncated systems, ``MultigridData.renew``) reuses one
    cycle.  Smoothing is colored block GS (a fresh residual per color,
    the colors reversed in the post-sweeps); the coarse solve is
    block-Jacobi PCG with a fixed ``coarse_cg_iters``, guarded so that
    exact convergence gives zero steps instead of 0/0 in any dtype.
    """
    transfers = data.transfers
    device = next(iter(data.matrices[-1].values.values())).device
    # per level, per color: {p: bucket positions of that color's elements}
    colorings = []
    for bas in data.bases:
        colors = sm.greedy_coloring(bas.mesh)
        per_color = []
        for c in range(int(colors.max()) + 1):
            per_p = {}
            for p in bas.bucket_degrees:
                pos = np.flatnonzero(colors[bas.bucket_elems[p]] == c)
                if len(pos):
                    per_p[p] = torch.as_tensor(pos, dtype=torch.int64,
                                               device=device)
            per_color.append(per_p)
        colorings.append(per_color)
    ncomp = data.matrices[0].block_shape[0]

    def gs(M, Dinv, lvl, x, b, reverse=False):
        order = colorings[lvl][::-1] if reverse else colorings[lvl]
        for per_p in order:
            r = bv.sub(b, bm.matvec(M, x))
            x = dict(x)
            for p, pos in per_p.items():
                upd = torch.bmm(Dinv[p][pos], r[p][pos].unsqueeze(-1))
                x[p] = x[p].index_add(0, pos, upd.squeeze(-1))
        return x

    def coarse_solve(M, Dinv, b):
        x = bv.zeros_like(b)
        r = b
        pdir = sm.apply_blockdiag(Dinv, r)
        rz = bv.dot(r, pdir)
        for _ in range(coarse_cg_iters):
            Ap = bm.matvec(M, pdir)
            den = bv.dot(pdir, Ap)
            alpha = torch.where(den > 0, rz / torch.where(den > 0, den, 1.0),
                                0.0)
            x = bv.axpy(alpha, pdir, x)
            r = bv.axpy(-alpha, Ap, r)
            z = sm.apply_blockdiag(Dinv, r)
            rz_new = bv.dot(r, z)
            beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                               0.0)
            pdir = bv.axpy(beta, pdir, z)
            rz = rz_new
        return x

    def cycle(mats, dinvs, x, b):
        def run(l, x, b):
            if l == 0:
                return coarse_solve(mats[0], dinvs[0], b)
            for _ in range(pre_steps):
                x = gs(mats[l], dinvs[l], l, x, b)
            r = bv.sub(b, bm.matvec(mats[l], x))
            T = transfers[l - 1]
            rc = T.restrict(r, dtype=dtype, ncomp=ncomp)
            xc = run(l - 1, bv.zeros_like(rc), rc)
            x = bv.add(x, T.prolong(xc, dtype=dtype, ncomp=ncomp))
            for _ in range(post_steps):
                x = gs(mats[l], dinvs[l], l, x, b, reverse=True)
            return x

        return run(len(data.bases) - 1, x, b)

    return cycle


def matrixfree_multigrid_solver(basis: DGBasis, penalty: float = 2.0,
                                dirichlet: bool = True,
                                cheby_degree: int = 3,
                                use_kernel: bool = False,
                                meshes: list | None = None,
                                penalty_scaling: str = "measure",
                                smoother: str = "cheb",
                                dtype=torch.float64, device=None):
    """Matrix-free hp-multigrid V-cycle (1+1 sweeps per level) for the
    SIPG Laplacian.

    Every non-coarse level applies the sum-factorized operator
    (``matrixfree.sumfact.sipg_operator``) in ``dtype``: any box mesh,
    mixed degrees and hanging faces included.  ``use_kernel=True`` makes
    every such level apply the uniform stencil (``ops.uniform_stencil``:
    K1 on the card, its plain twin on CPU tensors) instead; a level K1
    cannot take (not a full uniform lattice of one degree, or a ``dtype``
    other than float32 on the card) raises, with no fallback.

    ``smoother="cheb"``: block-Jacobi-preconditioned Chebyshev of
    ``cheby_degree``; ``"patch"``: vertex patches with probe-lattice
    class inverses on levels whose patch operator has at most
    ``PATCH_MAX_BLOCK`` dofs, Chebyshev on the others and where the
    patches cannot be built.  The coarse level is a dense Cholesky up to
    ``DENSE_COARSE_MAX`` dofs, else 40 colored block-GS steps.

    Returns ``(step, info)``: ``step(x, b) -> x`` is one V-cycle;
    ``info`` holds the bases, transfers, levels, and per non-coarse
    level its operator and smoother (``None`` for Chebyshev).
    """
    from hpdg_tpu_torch.assemble.plan import build_plan
    from hpdg_tpu_torch.assemble.sipg import assemble_laplace
    from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks
    from hpdg_tpu_torch.matrixfree.sumfact import sipg_operator
    from hpdg_tpu_torch.ops.uniform_stencil import uniform_stencil_operator

    if smoother not in ("cheb", "patch"):
        raise ValueError(smoother)
    device = dev.resolve(device)
    if use_kernel and device.type == "cuda" and dtype != torch.float32:
        raise TypeError(f"use_kernel: the stencil kernel takes float32, "
                        f"not {dtype}")
    bases, transfers = [basis], []
    while bases[0].max_degree() > 1:
        T = p_transfer(bases[0], max(1, bases[0].max_degree() // 2))
        bases.insert(0, T.coarse)
        transfers.insert(0, T)
    if meshes is not None:
        if meshes[-1] is not basis.mesh:
            raise ValueError("meshes must end with the basis' mesh")
        for coarse_mesh in reversed(list(meshes)[:-1]):
            cb = DGBasis(coarse_mesh,
                         np.full(coarse_mesh.n_elements,
                                 bases[0].max_degree(), dtype=np.int32),
                         family=basis.family)
            T = h_transfer(bases[0], cb)
            bases.insert(0, cb)
            transfers.insert(0, T)

    kw = dict(penalty=penalty, dirichlet=dirichlet,
              penalty_scaling=penalty_scaling)
    levels = [None]  # the coarsest level is only solved directly
    operators, smoothers = [], []
    for l in range(1, len(bases)):
        bas = bases[l]
        if use_kernel:
            planl = None  # built by the diagonal blocks where needed
            op = uniform_stencil_operator(bas, device=device, **kw)
        else:
            planl = build_plan(bas)
            op = sipg_operator(bas, plan=planl, dtype=dtype, device=device,
                               **kw)
        smo = None
        if smoother == "patch":
            (pd,) = bas.bucket_degrees
            if 2 ** bas.mesh.dim * (pd + 1) ** bas.mesh.dim <= PATCH_MAX_BLOCK:
                try:
                    smo = pat.UniformPatchSmoother(
                        op, bas, penalty, dirichlet=dirichlet,
                        penalty_scaling=penalty_scaling, dtype=dtype,
                        device=device)
                except ValueError:
                    pass  # not a full lattice: Chebyshev below
        if smo is not None:
            pre, post = smo.forward, smo.backward
        else:
            D = sipg_diagonal_blocks(bas, dtype=dtype, plan=planl,
                                     device=device, **kw)
            Dinv = sm.inverse_diagonal_blocks(D)
            pc = (lambda DD: lambda r: sm.apply_blockdiag(DD, r))(Dinv)
            rho = sm.estimate_rho(op, pc, bv.zeros(bas, dtype=dtype,
                                                   device=device))
            pre = post = sm.chebyshev_smoother(op, pc, lmax=1.05 * rho,
                                               degree=cheby_degree)
        T = transfers[l - 1]
        levels.append(Level(
            apply=op, pre_smooth=pre, post_smooth=post,
            restrict=(lambda TT: lambda r: TT.restrict(r, dtype=dtype))(T),
            prolong=(lambda TT: lambda c: TT.prolong(c, dtype=dtype))(T),
            pre_steps=1, post_steps=1))
        operators.append(op)
        smoothers.append(smo)

    cb = bases[0]
    if cb.ndof <= DENSE_COARSE_MAX:
        Ac = assemble_laplace(cb, dtype=dtype, device="cpu", **kw)
        coarse_solve = dense_coarse_solver(cb, Ac, dtype=dtype, device=device)
    else:
        Ac = assemble_laplace(cb, dtype=dtype, device=device, **kw)
        coarse_solve = gs_coarse_solver(cb, Ac)

    def step(x: dict, b: dict) -> dict:
        return vcycle(levels, coarse_solve, x, b)

    return step, {"bases": bases, "transfers": transfers, "levels": levels,
                  "operators": operators, "smoothers": smoothers}
