"""Sharded matrix-free linear elasticity (vector-valued SIPG).

Port of ``hpdg_tpu.parallel.elasticity``: the slab decomposition along
lattice axis 0 of ``parallel/sharded.py`` for the elasticity operator
(BASELINE config 4 over a shard group), uniform degree, global
``[N, bs]`` arrays with ``bs = dim (p+1)^dim``.

The serial operator is reused wholesale instead of re-deriving the
traction face terms:

* every shard applies ``matrixfree.elasticity.elasticity_operator`` to
  an EXTENDED template ``[ghost | own | ghost]`` and keeps the owned
  rows; the ghost layers arrive by ``ppermute``.  A rank's ``L`` shards
  are ``L`` detached copies of the template in one mesh, so one
  operator serves all of them at once;
* a shard without a neighbour receives ZEROS in the ghost slot.  An
  interface face against a zero ghost already gives the penalty term
  and HALF the consistency terms of the Dirichlet boundary face; the
  masked correction adds the missing half through a consistency-only
  boundary operator on a one-layer mesh (natural boundaries subtract
  the whole phantom contribution instead).

With first-class geometry (``gmesh=``) the template is no longer
translation invariant: each copy carries its shard's corners (edge
shards get Q1-extrapolated "mirror" ghost corners whose Jacobian on the
shared face equals the owned element's), so the operator's geometry
tables hold every shard's own rows, and the masked corrections carry
the exact per-face penalty difference between the true boundary face
and the phantom interface face.  Both equal the serial operator to
rounding, under either penalty scaling.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from hpdg_tpu_torch import mesh as hmesh
from hpdg_tpu_torch.assemble.plan import build_plan
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.matrixfree.elasticity import (elasticity_diagonal_blocks,
                                                  elasticity_geom_tables,
                                                  elasticity_operator)
from hpdg_tpu_torch.mesh import geometry as geo
from hpdg_tpu_torch.parallel.comm import (ShardGroup, Sharding,
                                          resolve_group, safe_div)
from hpdg_tpu_torch.parallel.sharded import detached_copies
from hpdg_tpu_torch.solvers.graphs import repeat


@dataclass
class ShardedElasticity:
    cells: tuple
    p: int
    ndev: int
    axis_name: str
    group: ShardGroup
    layer: int
    n_local: int
    bs: int                      # dim * (p+1)^dim
    apply: callable              # [L * n_local, bs] -> same (sharded)
    sharding: Sharding
    # general geometry: the extended bases of this rank's shards, for the
    # per-shard preconditioner blocks (None on the box path)
    shard_ebases: list | None = None

    @property
    def n_global(self) -> int:
        return self.n_local * self.ndev


def _masked_apply(group, L, layer, n_local, bs, p, dirichlet, op_ext,
                  cons, full):
    """The shard body: halo exchange, extended apply, masked edge
    corrections (``cons``/``full``: per side the one-layer operators)."""
    ndev = group.ndev
    n_ext = n_local + 2 * layer
    sid = np.asarray(list(group.shards))
    dev_ = group.device
    no_left = torch.as_tensor((sid == 0).astype(float),
                              device=dev_).reshape(L, 1, 1)
    no_right = torch.as_tensor((sid == ndev - 1).astype(float),
                               device=dev_).reshape(L, 1, 1)
    right_perm = [(i, i + 1) for i in range(ndev - 1)]
    left_perm = [(i + 1, i) for i in range(ndev - 1)]

    def apply(x):
        xs = x.reshape(L, n_local, bs)
        # edge shards receive ppermute zeros (no source): exactly the
        # zero-ghost convention the corrections rely on
        xl = group.ppermute(xs[:, -layer:].contiguous(), 0, right_perm)
        xr = group.ppermute(xs[:, :layer].contiguous(), 0, left_perm)
        xe = torch.cat([xl, xs, xr], 1).reshape(L * n_ext, bs)
        y = op_ext({p: xe})[p].reshape(L, n_ext, bs)[:, layer:-layer]
        u0 = xs[:, :layer].reshape(L * layer, bs)
        un = xs[:, -layer:].reshape(L * layer, bs)
        add_lo = 0.5 * cons[0]({p: u0})[p]
        add_hi = 0.5 * cons[1]({p: un})[p]
        if not dirichlet:
            add_lo = add_lo - full[0]({p: u0})[p]
            add_hi = add_hi - full[1]({p: un})[p]
        y[:, :layer] += no_left.to(x.dtype) * add_lo.reshape(L, layer, bs)
        y[:, -layer:] += no_right.to(x.dtype) * add_hi.reshape(L, layer, bs)
        return y.reshape(L * n_local, bs)

    return apply


def build_sharded_elasticity(cells, p: int, mu: float = 1.0,
                             lam: float = 1.0,
                             group: ShardGroup | None = None,
                             penalty: float = 8.0, dirichlet: bool = True,
                             axis_name: str = "x", dtype=torch.float64,
                             penalty_scaling: str = "measure",
                             gmesh=None) -> ShardedElasticity:
    """The sharded elasticity operator on the ``cells`` lattice of the
    unit box.  ``gmesh``: optional global mesh over the lattice (C
    element order, axis 0 slowest) carrying first-class geometry; the
    curved operator then takes per-shard geometry tables."""
    if gmesh is not None and geo.has_geometry(gmesh):
        return _build_sharded_elasticity_geom(
            gmesh, cells, p, mu=mu, lam=lam, group=group, penalty=penalty,
            dirichlet=dirichlet, axis_name=axis_name, dtype=dtype,
            penalty_scaling=penalty_scaling)
    cells = tuple(int(c) for c in cells)
    dim = len(cells)
    group = resolve_group(group)
    ndev, L, dev_ = group.ndev, group.L, group.device
    if cells[0] % ndev != 0:
        raise ValueError(f"cells[0]={cells[0]} not divisible by {ndev}")
    loc0 = cells[0] // ndev
    h = 1.0 / np.asarray(cells)
    layer = int(np.prod(cells[1:]))
    n_local = loc0 * layer
    bs = dim * (p + 1) ** dim
    kw = dict(mu=mu, lam=lam, dtype=dtype, penalty_scaling=penalty_scaling,
              device=dev_)

    # extended template [ghost layer | own | ghost layer]; y/z span the
    # full domain so the y/z Dirichlet faces are real on every shard
    ecells = (loc0 + 2,) + cells[1:]
    upper = (float((loc0 + 2) * h[0]),) + tuple(1.0 for _ in cells[1:])
    emesh = detached_copies(hmesh.structured(ecells, upper=upper), L,
                    (loc0 + 3) * h[0])
    ebasis = DGBasis(emesh, np.full(emesh.n_elements, p))
    eplan = build_plan(ebasis)
    # drop the template's x-boundary groups: those faces belong to the
    # ghost far ends, whose output rows are discarded
    eplan = replace(eplan, boundary_groups=tuple(
        bg for bg in eplan.boundary_groups if bg.axis != 0))
    op_ext = elasticity_operator(ebasis, penalty=penalty,
                                 dirichlet=dirichlet, plan=eplan, **kw)

    # edge-shard corrections on one-layer meshes.  A phantom interface
    # against a ZERO ghost contributes (full penalty + HALF consistency)
    # boundary-like terms: Dirichlet boundaries add 0.5 * consistency,
    # natural ones subtract the whole phantom contribution
    # (= full boundary op - 0.5 * consistency-only)
    lmesh = detached_copies(hmesh.structured(
        (1,) + cells[1:], upper=(float(h[0]),)
        + tuple(1.0 for _ in cells[1:])), L, 2 * h[0])
    lb = DGBasis(lmesh, np.full(L * layer, p))
    lplan = build_plan(lb)

    def corr_op(side, pen):
        lp = replace(lplan, face_groups=(), boundary_groups=tuple(
            bg for bg in lplan.boundary_groups
            if bg.axis == 0 and bg.side == side))
        return elasticity_operator(lb, penalty=pen, dirichlet=True, plan=lp,
                                   include_bulk=False, **kw)

    cons = (corr_op(0, 0.0), corr_op(1, 0.0))
    full = None if dirichlet else (corr_op(0, penalty), corr_op(1, penalty))
    apply = _masked_apply(group, L, layer, n_local, bs, p, dirichlet,
                          op_ext, cons, full)
    return ShardedElasticity(cells=cells, p=p, ndev=ndev,
                             axis_name=axis_name, group=group, layer=layer,
                             n_local=n_local, bs=bs, apply=apply,
                             sharding=Sharding(group, n_local))


def _global_corners(gmesh) -> np.ndarray:
    """(n, 2^d, d) physical corners of every element: native for
    trilinear meshes; for affine meshes the Q1 interpolation of the
    affine corner images reproduces the affine map exactly."""
    if geo.is_trilinear(gmesh):
        return np.asarray(gmesh.corners, np.float64)
    B = geo._bits(gmesh.dim)
    X = gmesh.lower[:, None, :] + B[None] * gmesh.extent[:, None, :]
    return gmesh.shift[:, None, :] + np.einsum("eab,ekb->eka", gmesh.jac, X)


def _build_sharded_elasticity_geom(gmesh, cells, p: int, mu, lam, group,
                                   penalty, dirichlet, axis_name, dtype,
                                   penalty_scaling) -> ShardedElasticity:
    """Curved-mesh sharded elasticity: per-shard geometry in the copies
    of the extended template (module docstring)."""
    cells = tuple(int(c) for c in cells)
    dim = len(cells)
    nc2 = 2 ** dim
    half = nc2 // 2  # corner index < half <=> low side along axis 0
    group = resolve_group(group)
    ndev, L, dev_ = group.ndev, group.L, group.device
    if cells[0] % ndev != 0:
        raise ValueError(f"cells[0]={cells[0]} not divisible by {ndev}")
    if int(np.prod(cells)) != gmesh.n_elements:
        raise ValueError("gmesh does not match the cells lattice")
    loc0 = cells[0] // ndev
    h = 1.0 / np.asarray(cells)
    layer = int(np.prod(cells[1:]))
    n_local = loc0 * layer
    n_ext = n_local + 2 * layer
    bs = dim * (p + 1) ** dim
    kw = dict(mu=mu, lam=lam, dtype=dtype, penalty_scaling=penalty_scaling,
              device=dev_)

    # global corners in x-major layer layout: (cells[0], layer, 2^d, d)
    C = _global_corners(gmesh).reshape(cells[0], layer, nc2, dim)

    def mirror_low(F):
        """Ghost layer left of first-layer corners F: the shared face
        coincides and the low half is the Q1 extrapolation, so the ghost
        Jacobian on the shared face equals F's there (a sheared
        translation, not a reflection)."""
        G = np.empty_like(F)
        G[:, half:] = F[:, :half]
        G[:, :half] = 2.0 * F[:, :half] - F[:, half:]
        return G

    def mirror_high(Lc):
        G = np.empty_like(Lc)
        G[:, :half] = Lc[:, half:]
        G[:, half:] = 2.0 * Lc[:, half:] - Lc[:, :half]
        return G

    # parametric extended template, and per local shard its corners
    ecells = (loc0 + 2,) + cells[1:]
    upper = (float((loc0 + 2) * h[0]),) + tuple(1.0 for _ in cells[1:])
    etmpl = hmesh.structured(ecells, upper=upper)
    degs_ext = np.full(n_ext, p)
    ecorns = []
    for s in group.shards:
        own = C[s * loc0:(s + 1) * loc0]
        gl = C[s * loc0 - 1] if s > 0 else mirror_low(C[0])
        gr = C[(s + 1) * loc0] if s < ndev - 1 else mirror_high(C[-1])
        ecorns.append(np.concatenate([gl[None], own, gr[None]]
                                     ).reshape(-1, nc2, dim))
    shard_ebases = [DGBasis(replace(etmpl, corners=ec), degs_ext)
                    for ec in ecorns]
    emesh = replace(detached_copies(etmpl, L, (loc0 + 3) * h[0]),
                    corners=np.concatenate(ecorns))
    ebasis = DGBasis(emesh, np.full(L * n_ext, p))
    eplan = build_plan(ebasis)
    # the template's x-boundary groups belong to the ghost far ends
    eplan = replace(eplan, boundary_groups=tuple(
        bg for bg in eplan.boundary_groups if bg.axis != 0))
    op_ext = elasticity_operator(ebasis, penalty=penalty,
                                 dirichlet=dirichlet, plan=eplan, **kw)

    # penalty of the phantom interface faces, per side, indexed by
    # (copy, position in the owned edge layer)
    pen_ph = {0: np.zeros(L * layer), 1: np.zeros(L * layer)}
    hi0 = (loc0 + 1) * layer
    for fg in eplan.face_groups:
        if fg.axis != 0:
            continue
        pen_all = geo.penalty_coef_mesh(emesh, fg, penalty, p,
                                        penalty_scaling)
        copy, lin = np.divmod(emesh.faces.inside[fg.face_ids], n_ext)
        lout = emesh.faces.outside[fg.face_ids] % n_ext
        lo = (lin < layer) | (lout < layer)
        own_lo = np.where(lin < layer, lout, lin) - layer
        pen_ph[0][copy[lo] * layer + own_lo[lo]] = pen_all[lo]
        hi = (lin >= hi0) | (lout >= hi0)
        own_hi = np.where(lin >= hi0, lout, lin) - loc0 * layer
        pen_ph[1][copy[hi] * layer + own_hi[hi]] = pen_all[hi]

    # one-layer correction meshes with the shard's true edge-layer
    # geometry; the consistency operator's penalty table carries the
    # exact difference between the true boundary coefficient and the
    # phantom face's (applied with weight 1/2, hence the factor 2)
    ltmpl = detached_copies(hmesh.structured(
        (1,) + cells[1:], upper=(float(h[0]),)
        + tuple(1.0 for _ in cells[1:])), L, 2 * h[0])
    cons, full = [], []
    for side in (0, 1):
        lay = [C[s * loc0] if side == 0 else C[(s + 1) * loc0 - 1]
               for s in group.shards]
        lmesh = replace(ltmpl, corners=np.concatenate(lay))
        lb = DGBasis(lmesh, np.full(L * layer, p))
        lplan = build_plan(lb)
        lplan = replace(lplan, face_groups=(), boundary_groups=tuple(
            bg for bg in lplan.boundary_groups
            if bg.axis == 0 and bg.side == side))
        gt = elasticity_geom_tables(lb, lplan, penalty=penalty,
                                    dirichlet=True,
                                    penalty_scaling=penalty_scaling)
        bnd = []
        for bg, (bH, bR, pen_bnd) in zip(lplan.boundary_groups, gt["bnd"]):
            q = lmesh.bfaces.elem[bg.face_ids]
            bnd.append((bH, bR, 2.0 * (pen_bnd - pen_ph[side][q])))
        opk = dict(penalty=penalty, dirichlet=True, plan=lplan,
                   include_bulk=False, **kw)
        cons.append(elasticity_operator(lb, tables=dict(gt, bnd=tuple(bnd)),
                                        **opk))
        if not dirichlet:
            full.append(elasticity_operator(lb, tables=gt, **opk))

    apply = _masked_apply(group, L, layer, n_local, bs, p, dirichlet,
                          op_ext, cons, full)
    return ShardedElasticity(cells=cells, p=p, ndev=ndev,
                             axis_name=axis_name, group=group, layer=layer,
                             n_local=n_local, bs=bs, apply=apply,
                             sharding=Sharding(group, n_local),
                             shard_ebases=shard_ebases)


def _dot(group, a, b):
    return group.psum(torch.vdot(a.reshape(-1), b.reshape(-1)))


def _norm(group, a):
    return torch.sqrt(_dot(group, a, a))


def elasticity_pcg_solve(prob: ShardedElasticity, b, iters: int = 200,
                         mu: float = 1.0, lam: float = 1.0,
                         penalty: float = 8.0, dirichlet: bool = True,
                         penalty_scaling: str = "measure",
                         dtype=torch.float64):
    """Block-Jacobi-preconditioned CG on the sharded elasticity system
    (psum dot products, ``iters`` iterations without a host read, one
    captured and replayed on a card: ``solvers.graphs.repeat``).

    The preconditioner blocks come from the extended template's interior
    rows: exact on interior shards; edge shards' boundary-layer blocks
    take the interface flavour instead of the Dirichlet one, which only
    perturbs the preconditioner, never the operator.  The blocks take
    the "measure" penalty scaling whatever ``penalty_scaling`` says, as
    in the reference.  Returns ``(x, ||r||)``."""
    dinv_mul = elasticity_dinv_mul(prob, mu=mu, lam=lam, penalty=penalty,
                                   dirichlet=dirichlet, dtype=dtype)
    start, body = _elasticity_pcg(prob, dinv_mul)
    x, r, *_ = repeat(body, start(b), iters)
    return x, _norm(prob.group, r)


def elasticity_dinv_mul(prob: ShardedElasticity, mu: float = 1.0,
                        lam: float = 1.0, penalty: float = 8.0,
                        dirichlet: bool = True, dtype=torch.float64):
    """Block-Jacobi preconditioner ``r -> D^-1 r`` on the sharded layout
    (see :func:`elasticity_pcg_solve` for the block flavour)."""
    p, layer = prob.p, prob.layer
    L, n_local, bs = prob.group.L, prob.n_local, prob.bs
    dev_ = prob.group.device
    kw = dict(mu=mu, lam=lam, penalty=penalty, dirichlet=dirichlet,
              dtype=torch.float64, device=dev_)
    if prob.shard_ebases is not None:
        # general geometry: per-shard blocks from each shard's extended
        # basis (interface flavour at the shard edges, as on boxes)
        D = torch.stack([elasticity_diagonal_blocks(eb, **kw)[p]
                         [layer:-layer] for eb in prob.shard_ebases])
        eq = "lnij,lnj->lni"
    else:
        loc0 = n_local // layer
        h = 1.0 / np.asarray(prob.cells)
        emesh = hmesh.structured((loc0 + 2,) + prob.cells[1:],
                                 upper=(float((loc0 + 2) * h[0]),)
                                 + tuple(1.0 for _ in prob.cells[1:]))
        ebasis = DGBasis(emesh, np.full(emesh.n_elements, p))
        D = elasticity_diagonal_blocks(ebasis, **kw)[p][layer:-layer]
        eq = "nij,lnj->lni"
    Dinv = torch.linalg.inv(D).to(dtype)
    del D

    def dinv_mul(r):
        out = torch.einsum(eq, Dinv.to(r.dtype), r.reshape(L, n_local, bs))
        return out.reshape(r.shape)

    return dinv_mul


def _elasticity_pcg(prob: ShardedElasticity, dinv_mul):
    """Block-Jacobi PCG as ``start(b) -> state`` (from zero) and
    ``body(state) -> state``, the state ``(x, r, z, p, rz)``."""
    g = prob.group

    def start(b):
        z = dinv_mul(b)
        return torch.zeros_like(b), b, z, z, _dot(g, b, z)

    def body(state):
        x, r, z, pv, rz = state
        Ap = prob.apply(pv)
        alpha = safe_div(rz, _dot(g, pv, Ap))
        x = x + alpha * pv
        r = r - alpha * Ap
        z = dinv_mul(r)
        rz_new = _dot(g, r, z)
        pv = z + safe_div(rz_new, rz) * pv
        return x, r, z, pv, rz_new

    return start, body


def _elasticity_pcg_runner(prob: ShardedElasticity, dinv_mul, iters: int):
    """Block-Jacobi PCG ``b -> (x, ||r||)`` of a fixed count, a host loop
    with no host read (the coarse solve of a V-cycle, captured with the
    cycle)."""
    start, body = _elasticity_pcg(prob, dinv_mul)

    def run(b):
        state = start(b)
        for _ in range(iters):
            state = body(state)
        return state[0], _norm(prob.group, state[1])

    return run


@dataclass
class ShardedElasticityPMG:
    levels: list          # coarsest..finest ShardedElasticity problems
    transfers: list       # per gap: ("p", T) | ("h", children, T_cp)
    step: callable        # V-cycle (x, b) -> x (sharded arrays)
    lmaxs: list           # per level 1.05 * rho(D^-1 A)


def _children_map(cells_c, dim: int) -> np.ndarray:
    """[N_c, 2^d] fine element ids of each coarse element's children
    (bit convention of ``geometry._bits``: axis 0 = highest bit)."""
    cells_f = tuple(2 * x for x in cells_c)
    B = geo._bits(dim).astype(np.int64)
    idx = np.indices(cells_c).reshape(dim, -1).T  # C order (ax0 slow)
    strides = np.array([int(np.prod(cells_f[a + 1:])) for a in range(dim)],
                       np.int64)
    ch = np.empty((len(idx), 2 ** dim), np.int64)
    for cp in range(2 ** dim):
        ch[:, cp] = (2 * idx + B[cp]) @ strides
    return ch


def build_sharded_elasticity_pmg(cells, p: int, mu: float = 1.0,
                                 lam: float = 1.0,
                                 group: ShardGroup | None = None,
                                 penalty: float = 8.0,
                                 dirichlet: bool = True,
                                 dtype=torch.float64,
                                 penalty_scaling: str = "measure",
                                 gmesh=None, pre_steps: int = 3,
                                 post_steps: int = 3,
                                 coarse_cg_iters: int = 60,
                                 h_levels: int = 0,
                                 smoother: str = "cheb",
                                 smoother_sweeps: int = 1
                                 ) -> ShardedElasticityPMG:
    """Sharded p-multigrid V-cycle for vector-valued elasticity: the
    p-chain ``p, p//2, ..., 1`` with ``h_levels`` geometric levels at
    degree 1 below it; p-transfers act per displacement component
    (element-local, no communication), h-transfers embed the children
    of a slab-aligned coarse element (no communication either);
    Chebyshev(pre/post_steps) on block Jacobi, or ``smoother="patch"``
    vertex-patch sweeps on box levels whose patch block is at most 1024;
    block-Jacobi PCG (``coarse_cg_iters``) on the coarsest level.

    Coarse levels are re-discretized with the penalty-matched
    coefficient ``penalty * (p/q)^2``, so every level carries the fine
    level's face coefficient sigma p^2 (naive re-discretization diverges
    for elasticity)."""
    from hpdg_tpu_torch.basis import lagrange, tensor
    dim = len(cells)
    cells = tuple(int(c) for c in cells)
    group = resolve_group(group)
    dev_ = group.device
    orders = [p]
    while orders[-1] > 1:
        orders.append(max(1, orders[-1] // 2))
    orders = orders[::-1]  # coarsest..finest

    def coarsen_cells(c, k):
        cc = tuple(x // (2 ** k) for x in c)
        if any(x * 2 ** k != y for x, y in zip(cc, cells)) or 0 in cc:
            raise ValueError(f"cells {c} not {k}x 2-coarsenable")
        return cc

    def coarse_gmesh(gm_f, cells_f, children):
        """Q1 coarse geometry: coarse corner k = fine child k's corner k
        (exact when the fine mesh refines a Q1 mesh)."""
        if gm_f is None:
            return None
        Cf = _global_corners(gm_f)
        cc = Cf[children, np.arange(2 ** dim)[None, :], :]
        base = hmesh.structured(tuple(x // 2 for x in cells_f))
        return replace(base, corners=cc)

    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev_)  # noqa: E731
    levels = []   # (cells_l, q_l, gmesh_l)
    gaps = []     # per gap (coarse side of level l)
    q0 = orders[0]
    hl = []
    gm_l, cells_l = gmesh, cells
    for k in range(h_levels):
        ch = _children_map(coarsen_cells(cells, k + 1), dim)
        gm_c = coarse_gmesh(gm_l, cells_l, ch)
        cells_l = coarsen_cells(cells, k + 1)
        hl.append((cells_l, q0, gm_c, ch))
        gm_l = gm_c
    for cells_c, qc, gmc, ch in reversed(hl):
        levels.append((cells_c, qc, gmc))
        # DG-Q1-style embedding per child position: per-axis basis values
        # at (side + nodes)/2, tensorized in C order (axis 0 first)
        nodes = lagrange.nodes_1d(q0)
        Ms = [lagrange.lagrange_values(nodes, (s + nodes) / 2.0).T
              for s in (0, 1)]
        B = geo._bits(dim).astype(int)
        Tcps = []
        for cp in range(2 ** dim):
            out = Ms[B[cp, 0]]
            for a in range(1, dim):
                out = np.kron(out, Ms[B[cp, a]])
            Tcps.append(out)
        # this rank's coarse elements and their children in its own
        # fine rows (the slabs align: a coarse slab is half a fine one)
        nc_loc = len(ch) // group.ndev
        nf_loc = nc_loc * 2 ** dim
        ch_loc = group.local_rows(ch, nc_loc) - group.rank * group.L * nf_loc
        gaps.append(("h", torch.as_tensor(ch_loc, device=dev_),
                     T(np.stack(Tcps))))
    for li, q in enumerate(orders):
        levels.append((cells, q, gmesh))
        if li > 0:
            gaps.append(("p", T(tensor.interpolation_matrix(
                orders[li - 1], q, dim))))

    kw = dict(mu=mu, lam=lam, group=group, dirichlet=dirichlet, dtype=dtype,
              penalty_scaling=penalty_scaling)
    pens = [penalty * (p / q) ** 2 for (_, q, _) in levels]
    probs = [build_sharded_elasticity(cl, q, penalty=pq, gmesh=gl, **kw)
             for (cl, q, gl), pq in zip(levels, pens)]
    dinvs = [elasticity_dinv_mul(pr, mu=mu, lam=lam, penalty=pq,
                                 dirichlet=dirichlet, dtype=dtype)
             for pr, pq in zip(probs, pens)]

    # per-level rho(D^-1 A) by power iteration from a fixed-seed random
    # start: every rank draws the same GLOBAL vector and keeps its rows
    rng = np.random.default_rng(1887)
    lmaxs = []
    for prob, dinv in zip(probs, dinvs):
        v = T(group.local_rows(rng.standard_normal((prob.n_global,
                                                     prob.bs)),
                               prob.n_local))
        v = v / _norm(group, v)

        def power(v, prob=prob, dinv=dinv):
            w = dinv(prob.apply(v))
            return w / _norm(group, w)

        v = repeat(power, v, 30)
        lmaxs.append(1.05 * float(_norm(group, dinv(prob.apply(v)))))

    def cheb(prob, dinv, lmax, x, b, degree, lmin_frac=0.15):
        # Chebyshev on the block-Jacobi-preconditioned operator
        theta = 0.5 * (lmax * lmin_frac + lmax)
        delta = 0.5 * (lmax - lmax * lmin_frac)
        r = dinv(b - prob.apply(x))
        d = r / theta
        sigma = theta / delta
        rho_old = 1.0 / sigma
        x = x + d
        for _ in range(degree - 1):
            r = dinv(b - prob.apply(x))
            rho_new = 1.0 / (2.0 * sigma - rho_old)
            d = (rho_new * rho_old) * d + (2.0 * rho_new / delta) * r
            rho_old = rho_new
            x = x + d
        return x

    # vertex-patch smoothing on BOX levels whose patch blocks stay under
    # 1024 dofs; bigger or curved levels keep Chebyshev.  The serial
    # level matrix only feeds the class inverses and is freed after.
    patch_sweeps = [None] * len(levels)
    if smoother == "patch":
        from hpdg_tpu_torch.assemble.elasticity import assemble_elasticity
        from hpdg_tpu_torch.parallel.patches import sharded_patch_sweeps
        for li, ((cl, q, gl), pq, prob) in enumerate(
                zip(levels, pens, probs)):
            if gl is not None or 2 ** dim * dim * (q + 1) ** dim > 1024:
                continue
            basg = DGBasis(hmesh.structured(cl),
                           np.full(int(np.prod(cl)), q, dtype=np.int32))
            Ag = assemble_elasticity(basg, mu=mu, lam=lam, penalty=pq,
                                     dirichlet=dirichlet, dtype=dtype,
                                     penalty_scaling=penalty_scaling,
                                     device=dev_)
            patch_sweeps[li] = sharded_patch_sweeps(prob, Ag, basg,
                                                    dtype=dtype)
            del Ag

    coarse = _elasticity_pcg_runner(probs[0], dinvs[0], coarse_cg_iters)

    def restrict(l, r):
        gap = gaps[l - 1]
        nl_f = (levels[l][1] + 1) ** dim
        if gap[0] == "p":
            nl_c = (levels[l - 1][1] + 1) ** dim
            return torch.einsum("ndi,ic->ndc", r.reshape(-1, dim, nl_f),
                                gap[1].to(r.dtype)).reshape(-1, dim * nl_c)
        _, ch, Tcps = gap
        rch = r.reshape(-1, dim, nl_f)[ch]  # [N_c, 2^d, d, nl]
        return torch.einsum("ncdi,cij->ndj", rch, Tcps.to(r.dtype)
                            ).reshape(-1, dim * nl_f)

    def prolong(l, c):
        gap = gaps[l - 1]
        nl_f = (levels[l][1] + 1) ** dim
        if gap[0] == "p":
            nl_c = (levels[l - 1][1] + 1) ** dim
            return torch.einsum("ndc,ic->ndi", c.reshape(-1, dim, nl_c),
                                gap[1].to(c.dtype)).reshape(-1, dim * nl_f)
        _, ch, Tcps = gap
        xf_ch = torch.einsum("ndj,cij->ncdi", c.reshape(-1, dim, nl_f),
                             Tcps.to(c.dtype))
        # every fine element is the child of exactly one coarse one:
        # the prolongation SETS its block
        out = torch.zeros((group.L * probs[l].n_local, dim, nl_f),
                          dtype=c.dtype, device=c.device)
        out[ch] = xf_ch
        return out.reshape(-1, dim * nl_f)

    def run(l, x, b):
        if l == 0:
            return coarse(b)[0]
        prob = probs[l]
        if patch_sweeps[l] is not None:
            fwd, bwd = patch_sweeps[l]
            for _ in range(smoother_sweeps):
                x = fwd(x, b)
        else:
            x = cheb(prob, dinvs[l], lmaxs[l], x, b, pre_steps)
        rc = restrict(l, b - prob.apply(x))
        x = x + prolong(l, run(l - 1, torch.zeros_like(rc), rc))
        if patch_sweeps[l] is not None:
            for _ in range(smoother_sweeps):
                x = bwd(x, b)
        else:
            x = cheb(prob, dinvs[l], lmaxs[l], x, b, post_steps)
        return x

    nlev = len(levels)

    def step(x, b):
        return run(nlev - 1, x, b)

    return ShardedElasticityPMG(levels=probs, transfers=gaps, step=step,
                                lmaxs=lmaxs)


def solve_sharded_elasticity_pmg(pmg: ShardedElasticityPMG, b,
                                 cycles: int = 20):
    """``cycles`` V-cycles from zero, one captured and replayed on a card
    (``solvers.graphs.repeat``) -> ``(x, ||b - A x||)``."""
    fine = pmg.levels[-1]
    x = repeat(lambda x: pmg.step(x, b), torch.zeros_like(b), cycles)
    return x, _norm(fine.group, b - fine.apply(x))


def elasticity_pmg_pcg_solve(pmg: ShardedElasticityPMG, b,
                             iters: int = 30):
    """V-cycle-preconditioned CG, ``iters`` iterations without a host
    read, one (with its V-cycle) captured and replayed on a card ->
    ``(x, ||r|| / ||b||)``.  The symmetric V-cycle from zero is an SPD
    preconditioner, so plain CG applies."""
    fine = pmg.levels[-1]
    g = fine.group
    start, body = _elasticity_pcg(
        fine, lambda r: pmg.step(torch.zeros_like(r), r))
    x, r, *_ = repeat(body, start(b), iters)
    return x, _norm(g, r) / _norm(g, b)
