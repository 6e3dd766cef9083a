"""Mixed-degree (hp) sharded SIPG over a shard group.

Port of ``hpdg_tpu.parallel.hp``.  The reference's design carries over
unchanged, with its SPMD program replaced by one batched shard body:

* slab, block (``device_grid``) or cut-plane (general meshes with
  hanging faces) partitions of the elements over ``ndev`` shards;
* per-shard-identical padded bucket layouts: shard ``s`` stores its
  owned elements of degree ``p`` in rows ``s*m_p .. s*m_p+m_p-1`` of a
  ``[ndev*m_p, (p+1)^d]`` array, padding rows exactly zero;
* per-degree halo buffers of fixed size moved by
  :meth:`~hpdg_tpu_torch.parallel.comm.ShardGroup.ppermute`;
* per-shard plan data stacked over the shard axis.  A rank holds the
  rows of its own shards; every index table is flattened with the
  shard's row offset, so the body runs over all local shards at once:
  one gather, one batched contraction and ONE ``index_add_`` per bucket,
  whatever the number of shards.

Padded face rows point at the dump row ``L*m_p`` of each bucket's output
(``L`` = shards on this rank), which is dropped before the owned mask.
The host build (``build_plan``, ``DGBasis`` and diagonal blocks per
shard) is numpy as in the reference; every rank plans all shards (the
padded sizes are global maxima) but computes diagonal blocks and plan
data for its own shards only.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from hpdg_tpu_torch import mesh as hmesh
from hpdg_tpu_torch.basis import tensor
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.assemble.plan import (build_plan, penalty_coef,
                                          boundary_penalty_coef,
                                          face_group_tables,
                                          face_phys_points)
from hpdg_tpu_torch.assemble.sipg import is_tensor_coefficient
from hpdg_tpu_torch.matrixfree.diagonal import sipg_diagonal_blocks
from hpdg_tpu_torch.matrixfree.sumfact import _chain
from hpdg_tpu_torch.mesh import geometry as geo
from hpdg_tpu_torch.parallel.comm import (ShardGroup, Sharding,
                                          resolve_group, safe_div)

_I = np.int32


@dataclass
class HPSharded:
    """A sharded mixed-degree SIPG problem."""

    cells: tuple
    degrees: np.ndarray           # global per-element degree map
    ndev: int
    axis_name: str
    group: ShardGroup
    degree_set: tuple             # global sorted degrees
    m_own: dict                   # p -> padded owned count per shard
    shardings: dict               # p -> Sharding of the x[p] arrays
    owned_slots: dict             # (s, p) -> global element ids in slot order
    apply: callable               # {p: [L*m_p, bs_p]} -> same
    dinv_mul: callable            # block-Jacobi preconditioner r -> Dinv r
    diag: dict                    # p -> [L*m_p, bs, bs] diagonal blocks
    n_local: int
    layer: int
    axes: tuple = ("x",)          # device-grid axis names
    device_grid: tuple = (1,)     # shards per partitioned mesh axis
    dim: int = 0                  # mesh dimension (cells may be None)
    gmesh: object = None          # the global Mesh
    halo: dict = field(default_factory=dict)  # exchange sizes per apply
    tables: dict = field(default_factory=dict)  # this rank's index stacks
    build_seconds: float = 0.0    # host wall seconds of the builder
    retype: callable = None       # dtype -> (apply, dinv_mul)

    @property
    def ndim(self) -> int:
        return self.dim or len(self.cells)

    def astype(self, dtype) -> "HPSharded":
        """The same problem with its plan data in ``dtype`` (no host
        rebuild)."""
        from dataclasses import replace
        apply, dinv_mul = self.retype(dtype)
        return replace(self, apply=apply, dinv_mul=dinv_mul,
                       diag={p: v.to(dtype) for p, v in self.diag.items()})

    def zeros(self, dtype=torch.float64):
        L = self.group.L
        return {p: torch.zeros((L * self.m_own[p], (p + 1) ** self.ndim),
                               dtype=dtype, device=self.group.device)
                for p in self.degree_set}

    def _slot_rows(self, serial_basis: DGBasis, p: int, shards, lo: int):
        """(rows counted from shard ``lo``, serial bucket positions) of
        the owned degree-``p`` elements of ``shards``."""
        rows, pos = [], []
        for s in shards:
            ids = self.owned_slots[(s, p)]
            rows.append((s - lo) * self.m_own[p] + np.arange(len(ids)))
            pos.append(serial_basis.elem_bucket_pos[ids])
        return np.concatenate(rows), np.concatenate(pos)

    def scatter_global(self, xg: dict, serial_basis: DGBasis, dtype=None):
        """Serial bucketed vector -> this rank's sharded rows."""
        out = {}
        dev_ = self.group.device
        for p in self.degree_set:
            src = torch.as_tensor(xg[p]).to(dev_)
            rows, pos = self._slot_rows(serial_basis, p, self.group.shards,
                                        self.group.shards.start)
            buf = torch.zeros((self.group.L * self.m_own[p],
                               (p + 1) ** self.ndim),
                              dtype=dtype or src.dtype, device=dev_)
            buf[_idx(rows, dev_)] = src[_idx(pos, dev_)].to(buf.dtype)
            out[p] = buf
        return out

    def gather_global(self, xs: dict, serial_basis: DGBasis) -> dict:
        """Sharded layout -> the serial bucketed vector (every rank gets
        all of it), as tensors on the group's device."""
        dev_ = self.group.device
        dim = self.ndim
        dtype = next(iter(xs.values())).dtype
        out = {p: torch.zeros((serial_basis.bucket_size(p), (p + 1) ** dim),
                              dtype=dtype, device=dev_)
               for p in serial_basis.bucket_degrees}
        for p in self.degree_set:
            full = self.group.all_rows(xs[p])
            rows, pos = self._slot_rows(serial_basis, p, range(self.ndev), 0)
            out[p][_idx(pos, dev_)] = full[_idx(rows, dev_)]
        return out


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64).reshape(-1),
                           device=device)


def _box_ids(lo, shape, cells):
    """Global element ids of the lattice box [lo, lo+shape) in local
    C-order (axis 0 slowest — matching hmesh.structured element order)."""
    dim = len(cells)
    grids = np.meshgrid(*[np.arange(lo[a], lo[a] + shape[a])
                          for a in range(dim)], indexing="ij")
    ids = np.zeros(tuple(shape), dtype=np.int64)
    for a in range(dim):
        ids = ids * cells[a] + grids[a]
    return ids.reshape(-1)


def _cast_floats(tree, dtype):
    """A copy of a nested dict/list/tuple of tensors with every floating
    tensor cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _host_k(diffusion, xq):
    """The user's medium at host points ``xq``, as numpy f64."""
    k = diffusion(torch.as_tensor(np.asarray(xq, np.float64)))
    return k.detach().cpu().double().numpy()


def build_hp_sharded(cells, degrees, group: ShardGroup | None = None,
                     penalty: float = 2.0, dirichlet: bool = True,
                     dtype=torch.float64, penalty_scaling: str = "measure",
                     axis_name: str = "x", device_grid=None, diffusion=None,
                     gmesh=None) -> HPSharded:
    """The sharded mixed-degree SIPG apply for a structured mesh.

    ``degrees``: global per-element degree array (element order of
    ``hmesh.structured(cells)``).  ``device_grid``: shards per
    partitioned mesh axis, e.g. ``(4, 2)``; default ``(group.ndev,)``,
    the 1-axis slab.  ``group``: the shard group (default: one process,
    one shard per visible card, on the card)."""
    t_build = time.perf_counter()
    cells = tuple(int(c) for c in cells)
    dim = len(cells)
    degrees = np.asarray(degrees, dtype=_I).reshape(-1)
    if device_grid is None:
        group = resolve_group(group)
        device_grid = (group.ndev,)
    device_grid = tuple(int(d) for d in device_grid)
    npax = len(device_grid)
    if npax > dim:
        raise ValueError(f"device_grid {device_grid} has more axes than the "
                         f"mesh ({dim})")
    ndev = int(np.prod(device_grid))
    group = resolve_group(group, ndev)
    for a in range(npax):
        if cells[a] % device_grid[a]:
            raise ValueError(f"cells[{a}]={cells[a]} not divisible by "
                             f"device_grid[{a}]={device_grid[a]}")
    axes = (axis_name,) if npax == 1 else tuple("xyzw"[a] for a in range(npax))
    loc = tuple(cells[a] // device_grid[a] if a < npax else cells[a]
                for a in range(dim))
    if gmesh is None:
        gmesh = hmesh.structured(cells)
    elif gmesh.n_elements != int(np.prod(cells)):
        raise ValueError("gmesh must be the structured(cells) lattice")
    n_local = int(np.prod(loc))
    layer = n_local // loc[0]
    HAX = [a for a in range(npax) if device_grid[a] > 1]

    # channel 1+2*ha+side carries my (axis, side) ghost; I pack my
    # OPPOSITE-side boundary layer for it
    channels = {}
    for ha, a in enumerate(HAX):
        hi_perm = [(i, i + 1) for i in range(device_grid[a] - 1)]
        lo_perm = [(i + 1, i) for i in range(device_grid[a] - 1)]
        channels[1 + 2 * ha + 0] = (a, hi_perm)
        channels[1 + 2 * ha + 1] = (a, lo_perm)

    def _own_layer_ids(a, side):
        lshape = list(loc)
        lshape[a] = 1
        llo = [0] * dim
        llo[a] = 0 if side == 0 else loc[a] - 1
        return _box_ids(llo, lshape, loc)

    shards = []
    send_ids = {}
    for s in range(ndev):
        S = np.unravel_index(s, device_grid)
        olo = [S[a] * loc[a] if a < npax else 0 for a in range(dim)]
        own = _box_ids(olo, loc, cells)
        # ghost layers in channel order; shards with no neighbour on a
        # side get detached fakes (match nothing, zero coefficients)
        ghosts = []
        for ha, a in enumerate(HAX):
            for side in (0, 1):
                gshape = list(loc)
                gshape[a] = 1
                has = (S[a] > 0) if side == 0 else (S[a] < device_grid[a] - 1)
                if has:
                    glo = list(olo)
                    glo[a] = olo[a] - 1 if side == 0 else olo[a] + loc[a]
                    ids = _box_ids(glo, gshape, cells)
                    glow = gmesh.lower[ids]
                    gext = gmesh.extent[ids]
                    gdeg = degrees[ids]
                else:
                    mlo = list(olo)
                    mlo[a] = olo[a] if side == 0 else olo[a] + loc[a] - 1
                    mids = _box_ids(mlo, gshape, cells)
                    glow = gmesh.lower[mids].copy()
                    glow[:, a] -= 1000.0 + s  # detached
                    gext = gmesh.extent[mids]
                    gdeg = degrees[mids]
                ghosts.append(dict(ch=1 + 2 * ha + side, lower=glow,
                                   extent=gext, lay_deg=gdeg,
                                   gids=ids if has else mids,
                                   detached=not has))
                send_ids[(s, 1 + 2 * ha + side)] = own[
                    _own_layer_ids(a, 1 - side)]
        lo = [gmesh.lower[own]] + [g["lower"] for g in ghosts]
        ex = [gmesh.extent[own]] + [g["extent"] for g in ghosts]
        dg = [degrees[own]] + [g["lay_deg"] for g in ghosts]
        ejac = eshift = ecorn = None
        if getattr(gmesh, "jac", None) is not None:
            eids = np.concatenate([own] + [g["gids"] for g in ghosts])
            ejac, eshift = gmesh.jac[eids], gmesh.shift[eids]
        if getattr(gmesh, "corners", None) is not None:
            # detached fake ghosts get box corners: their parametric
            # boxes are moved, so real corners would give garbage
            # Jacobians in masked lanes
            parts = [gmesh.corners[own]]
            B = geo._bits(gmesh.dim)
            for g in ghosts:
                if g["detached"]:
                    parts.append(g["lower"][:, None, :]
                                 + B[None, :, :] * g["extent"][:, None, :])
                else:
                    parts.append(gmesh.corners[g["gids"]])
            ecorn = np.concatenate(parts)
        emesh = hmesh.from_boxes(np.concatenate(lo), np.concatenate(ex),
                                 validate=False, jac=ejac, shift=eshift,
                                 corners=ecorn)
        ebasis = DGBasis(emesh, np.concatenate(dg))
        shards.append(dict(own=own, ghosts=ghosts, emesh=emesh, ebasis=ebasis,
                           plan=build_plan(ebasis)))

    res = _finish_sharded(gmesh, degrees, shards, channels, send_ids,
                          group, device_grid, axes, penalty, dirichlet,
                          dtype, penalty_scaling, cells=cells,
                          n_local=n_local, layer=layer,
                          diffusion=diffusion)
    res.build_seconds = time.perf_counter() - t_build
    return res


def slab_partition(gmesh, ndev: int, axis: int = 0) -> np.ndarray:
    """Balanced 1-axis slab partition of a general box mesh: ``ndev - 1``
    cut planes along ``axis`` (from coordinates that split no element)
    balancing element counts; element -> slab of its center.  Raises if
    no valid balanced cut exists."""
    xlo = gmesh.lower[:, axis]
    xhi = xlo + gmesh.extent[:, axis]
    tol = float(gmesh.extent.min()) * 1e-9
    cands = np.unique(np.round(np.concatenate([xlo, xhi]), 12))
    cands = cands[(cands > xlo.min() + tol) & (cands < xhi.max() - tol)]
    valid = np.array([c for c in cands
                      if not np.any((xlo < c - tol) & (xhi > c + tol))])
    if len(valid) < ndev - 1:
        raise ValueError(f"only {len(valid)} uncut planes along axis {axis} "
                         f"for {ndev} shards")
    centers = np.sort(xlo + 0.5 * gmesh.extent[:, axis])
    n = len(centers)
    counts = np.searchsorted(centers, valid - tol)
    # monotone greedy with forced distinctness
    planes = []
    prev = -1
    for k in range(1, ndev):
        target = n * k / ndev
        lo_i = prev + 1
        hi_i = len(valid) - 1 - (ndev - 1 - k)
        j = lo_i + int(np.argmin(np.abs(counts[lo_i:hi_i + 1] - target)))
        planes.append(float(valid[j]))
        prev = j
    shard = np.searchsorted(planes, xlo + 0.5 * gmesh.extent[:, axis]).astype(
        np.int64)
    counts = np.bincount(shard, minlength=ndev)
    if counts.min() == 0:
        raise ValueError(f"empty shard in partition (counts {counts})")
    return shard


def balanced_partition(gmesh, ndev: int) -> np.ndarray:
    """Perfectly balanced jagged partition: elements ordered
    lexicographically by center, cut into equal-count runs."""
    centers = gmesh.lower + 0.5 * gmesh.extent
    order = np.lexsort(tuple(centers[:, a]
                             for a in range(gmesh.dim - 1, -1, -1)))
    shard = np.empty(gmesh.n_elements, np.int64)
    bounds = np.linspace(0, gmesh.n_elements, ndev + 1).astype(np.int64)
    for sidx in range(ndev):
        shard[order[bounds[sidx]:bounds[sidx + 1]]] = sidx
    return shard


def morton_partition(gmesh, ndev: int, max_level: int = 21) -> np.ndarray:
    """Space-filling-curve partition: elements ordered by the Morton code
    of their quantized centers, cut into equal-count runs."""
    centers = gmesh.lower + 0.5 * gmesh.extent
    lo = centers.min(axis=0)
    hi = centers.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.minimum(((centers - lo) / span * (2**max_level - 1)).astype(
        np.int64), 2**max_level - 1)
    code = np.zeros(gmesh.n_elements, dtype=object)  # python ints: no ovfl
    for bit in range(max_level):
        for a in range(gmesh.dim):
            code = code + (((q[:, a] >> bit) & 1).astype(object)
                           << (bit * gmesh.dim + a))
    order = np.argsort(np.array([int(c) for c in code]), kind="stable")
    shard = np.empty(gmesh.n_elements, np.int64)
    bounds = np.linspace(0, gmesh.n_elements, ndev + 1).astype(np.int64)
    for sidx in range(ndev):
        shard[order[bounds[sidx]:bounds[sidx + 1]]] = sidx
    return shard


def build_hp_sharded_general(gmesh, degrees, group: ShardGroup | None = None,
                             penalty: float = 2.0, dirichlet: bool = True,
                             dtype=torch.float64,
                             penalty_scaling: str = "measure",
                             axis_name: str = "x",
                             elem_shard=None, diffusion=None,
                             max_offset: int = 8,
                             plan_cache: dict | None = None) -> HPSharded:
    """Sharded mixed-degree SIPG on a GENERAL box mesh (2:1 hanging
    faces included) under any element partition: ``slab_partition``
    (default), ``balanced_partition``, ``morton_partition`` or an
    explicit ``elem_shard``.  Every shard offset in the face couplings
    gets one halo channel.

    ``plan_cache``: a dict threaded across rebuilds of the same problem
    family; shards whose content is unchanged reuse their extended
    mesh/basis/plan, diagonal blocks and plan data, keyed by a content
    hash.  Appends ``(hits, misses)`` per build under ``"__stats__"``."""
    t_build = time.perf_counter()
    degrees = np.asarray(degrees, dtype=_I).reshape(-1)
    group = resolve_group(group)
    ndev = group.ndev
    f = gmesh.faces
    if elem_shard is None:
        elem_shard = slab_partition(gmesh, ndev)
    elem_shard = np.asarray(elem_shard).reshape(-1)
    si, so = elem_shard[f.inside], elem_shard[f.outside]
    offsets = sorted({int(o) for o in np.unique(so - si)} |
                     {int(o) for o in np.unique(si - so)})
    offsets = [o for o in offsets if o != 0]
    if offsets and max(abs(o) for o in offsets) > max_offset:
        raise ValueError(f"partition couples shards {max(map(abs, offsets))}"
                         f" apart (> max_offset={max_offset})")

    # one channel per shard offset o: shard s receives the elements of
    # shard s + o that touch it
    channels = {}
    for k, o in enumerate(offsets):
        perm = [(i, i - o) for i in range(ndev) if 0 <= i - o < ndev]
        channels[k + 1] = (0, perm)

    def _adj(a, b):
        """Elements of shard a face-adjacent to shard b, ascending ids."""
        mask = ((si == a) & (so == b)) | ((si == b) & (so == a))
        if not mask.any():
            return np.empty(0, np.int64)
        els = np.concatenate([f.inside[mask], f.outside[mask]])
        return np.unique(els[elem_shard[els] == a])

    shards = []
    send_ids = {}
    hits = misses = 0
    for s in range(ndev):
        own = np.where(elem_shard == s)[0]
        ghosts = []
        for k, o in enumerate(offsets):
            nb = s + o
            gids = _adj(nb, s) if 0 <= nb < ndev else np.empty(0, np.int64)
            ghosts.append(dict(ch=k + 1, lower=gmesh.lower[gids],
                               extent=gmesh.extent[gids],
                               lay_deg=degrees[gids], gids=gids))
            rcv = s - o
            send_ids[(s, k + 1)] = _adj(s, rcv) if 0 <= rcv < ndev \
                else np.empty(0, np.int64)
        lo = [gmesh.lower[own]] + [g["lower"] for g in ghosts]
        ex = [gmesh.extent[own]] + [g["extent"] for g in ghosts]
        dg = [degrees[own]] + [g["lay_deg"] for g in ghosts]
        ejac = eshift = ecorn = None
        eids = np.concatenate([own] + [g["gids"] for g in ghosts])
        if getattr(gmesh, "jac", None) is not None:
            ejac, eshift = gmesh.jac[eids], gmesh.shift[eids]
        if getattr(gmesh, "corners", None) is not None:
            ecorn = gmesh.corners[eids]
        key = None
        if plan_cache is not None:
            h = hashlib.sha1()
            for a in (lo + ex + dg
                      + ([ejac, eshift] if ejac is not None else [])
                      + ([ecorn] if ecorn is not None else [])):
                h.update(np.ascontiguousarray(a).tobytes())
            h.update(np.int64([g["lower"].shape[0] for g in ghosts]
                              ).tobytes())
            key = h.hexdigest()
            ent = plan_cache.get(key)
            if ent is not None:
                hits += 1
                sh_ent = dict(own=own, ghosts=ghosts, emesh=ent["emesh"],
                              ebasis=ent["ebasis"], plan=ent["plan"],
                              cache_key=key)
                for src, dst in (("diag", "diag_cache"),
                                 ("dinv", "dinv_cache"),
                                 ("lane", "lane_cache")):
                    if ent.get(src) is not None:
                        sh_ent[dst] = ent[src]
                shards.append(sh_ent)
                continue
            misses += 1
        emesh = hmesh.from_boxes(np.concatenate(lo), np.concatenate(ex),
                                 validate=False, jac=ejac, shift=eshift,
                                 corners=ecorn)
        ebasis = DGBasis(emesh, np.concatenate(dg))
        shards.append(dict(own=own, ghosts=ghosts, emesh=emesh, ebasis=ebasis,
                           plan=build_plan(ebasis), cache_key=key))

    res = _finish_sharded(gmesh, degrees, shards, channels, send_ids,
                          group, (ndev,), (axis_name,), penalty, dirichlet,
                          dtype, penalty_scaling, cells=None,
                          n_local=max(len(sh["own"]) for sh in shards),
                          layer=0, diffusion=diffusion)
    if plan_cache is not None:
        for sh in shards:
            k = sh.get("cache_key")
            if k is None:
                continue
            ent = plan_cache.get(k)
            if ent is None:
                plan_cache[k] = dict(emesh=sh["emesh"], ebasis=sh["ebasis"],
                                     plan=sh["plan"],
                                     diag=sh.get("diag_cache"),
                                     dinv=sh.get("dinv_cache"),
                                     lane=sh.get("lane_cache"))
            else:
                # older entries grow the newly computed pieces in place
                for src, dst in (("diag_cache", "diag"),
                                 ("dinv_cache", "dinv"),
                                 ("lane_cache", "lane")):
                    if ent.get(dst) is None and sh.get(src) is not None:
                        ent[dst] = sh[src]
        plan_cache.setdefault("__stats__", []).append((hits, misses))
    res.build_seconds = time.perf_counter() - t_build
    return res


def _finish_sharded(gmesh, degrees, shards, channels, send_ids, group,
                    device_grid, axes, penalty, dirichlet, dtype,
                    penalty_scaling, cells, n_local, layer,
                    diffusion=None) -> HPSharded:
    """Common tail of the sharded builders: pad class sets across shards,
    build this rank's stacked plan data and the batched shard body.

    ``shards[s]`` has ``own`` (global ids, the owned slot order),
    ``ghosts`` (blocks in a fixed global channel order; block ids == the
    neighbour's ``send_ids`` for that channel) and ``emesh``/``ebasis``/
    ``plan`` over own + ghost elements (own first).
    ``channels[ch] = (device-grid axis, ppermute perm)``."""
    dim = gmesh.dim
    ndev = len(shards)
    dev_ = group.device
    L = group.L
    lo_s = group.shards.start
    local = list(group.shards)
    f64 = torch.float64
    affine = geo.has_affine(gmesh)
    kmat = affine or is_tensor_coefficient(diffusion, dim, f64, "cpu")
    has_k = diffusion is not None or affine
    DEG = tuple(sorted(int(d) for d in np.unique(degrees)))
    CHS = sorted(channels)
    n_own = [len(sh["own"]) for sh in shards]

    # ---------------- global class sets + padded sizes ----------------
    m_own = {p: max(int(np.sum(degrees[sh["own"]] == p)) for sh in shards)
             for p in DEG}
    m_ext = {p: max((sh["ebasis"].bucket_size(p)
                     if p in sh["ebasis"].bucket_degrees else 0)
                    for sh in shards) for p in DEG}
    G = {}  # (p, ch) -> padded halo-buffer length
    for p in DEG:
        for ch in CHS:
            G[(p, ch)] = max(int(np.sum(degrees[send_ids[(s, ch)]] == p))
                             for s in range(ndev))
    FCLS = []
    rep = {}
    for sh in shards:
        for fg in sh["plan"].face_groups:
            c = (fg.p_in, fg.p_out, fg.axis, fg.nc_code)
            if c not in rep:
                rep[c] = (sh["ebasis"], fg)
                FCLS.append(c)
    FCLS = sorted(FCLS)
    BCLS = sorted({(bg.p, bg.axis, bg.side)
                   for sh in shards for bg in sh["plan"].boundary_groups
                   }) if dirichlet else []
    Fmax = {c: 0 for c in FCLS}
    Bmax = {c: 0 for c in BCLS}
    for sh in shards:
        for fg in sh["plan"].face_groups:
            c = (fg.p_in, fg.p_out, fg.axis, fg.nc_code)
            Fmax[c] = max(Fmax[c], len(fg.face_ids))
        if dirichlet:
            for bg in sh["plan"].boundary_groups:
                c = (bg.p, bg.axis, bg.side)
                Bmax[c] = max(Bmax[c], len(bg.face_ids))

    owned_slots = {}
    for s, sh in enumerate(shards):
        od = degrees[sh["own"]]
        for p in DEG:
            owned_slots[(s, p)] = sh["own"][od == p]

    # per-shard diagonal blocks in f64 on the group's device, computed
    # once per local shard (ghost blocks unused)
    for s in local:
        sh = shards[s]
        if sh.get("diag_cache") is None:
            sh["diag_cache"] = sipg_diagonal_blocks(
                sh["ebasis"], penalty=penalty, dirichlet=dirichlet,
                plan=sh["plan"], penalty_scaling=penalty_scaling,
                diffusion=diffusion, dtype=f64, device=dev_)

    def _deg_lane(sh, s, p, vtp):
        """Shard ``s``'s UNPADDED contributions for degree ``p`` (a pure
        function of the shard's content; rides the plan cache)."""
        eb = sh["ebasis"]
        own_p = owned_slots[(s, p)]
        no = len(own_p)
        out = {"no": no}
        if p in eb.bucket_degrees:
            # ext bucket: owned slots first, then ghosts; a ghost's recv
            # index = its rank among deg-p elements of its block
            elems = eb.bucket_elems[p]
            ek_v = np.zeros(len(elems), _I)
            ei_v = np.arange(len(elems), dtype=_I)
            ghm = elems >= n_own[s]
            if ghm.any():
                blk_off = []
                off = n_own[s]
                for g in sh["ghosts"]:
                    blk_off.append(off)
                    off += len(g["lay_deg"])
                e_g = elems[ghm]
                gi = np.searchsorted(blk_off, e_g, side="right") - 1
                ek_v[ghm] = np.array([g["ch"] for g in sh["ghosts"]],
                                     _I)[gi]
                ei_g = np.zeros(len(e_g), _I)
                for gidx, g in enumerate(sh["ghosts"]):
                    mblk = gi == gidx
                    if mblk.any():
                        cs = np.concatenate(
                            [[0], np.cumsum(g["lay_deg"] == p)])
                        ei_g[mblk] = cs[e_g[mblk] - blk_off[gidx]]
                ei_v[ghm] = ei_g
            out["ek"], out["ei"] = ek_v, ei_v
        snd = {}
        for ch in CHS:
            sel = send_ids[(s, ch)]
            sel = sel[degrees[sel] == p]
            snd[ch] = np.searchsorted(own_p, sel).astype(_I)
        out["snd"] = snd
        if no:
            ext = gmesh.extent[own_p]
            out["bc"] = np.prod(ext, axis=1)[:, None] / ext**2
            if kmat:
                out["bih"] = 1.0 / ext
                out["bdj"] = np.prod(ext, axis=1)
            if has_k:
                xpq = (gmesh.lower[own_p][:, None, :]
                       + vtp["points"][None, :, :] * ext[:, None, :])
                xq = geo.apply_map(gmesh, own_p, xpq)
                kq_b = _host_k(diffusion, xq) if diffusion is not None \
                    else None
                if affine:
                    kq_b = np.asarray(geo.effective_tensor(
                        gmesh, own_p, kq_b, xpq))
                out["bk"] = kq_b
        return out

    J = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                  device=dev_)
    I = lambda a: torch.as_tensor(np.asarray(a, np.int64),  # noqa: E731, E741
                                  device=dev_)
    srow = np.arange(L)[:, None]  # local shard index per stacked row

    dd = {"ext": {}, "send": {}, "bulk": {}, "own": {}, "dinv": {},
          "diag": {}, "fg": {}, "bg": {}}
    tables = {"ext_kind": {}, "ext_idx": {}, "send": {}}
    for p in DEG:
        bs = (p + 1) ** dim
        ek = np.zeros((L, m_ext[p]), _I)
        ei = np.zeros((L, m_ext[p]), _I)
        snd = {ch: np.zeros((L, max(G[(p, ch)], 1)), _I) for ch in CHS}
        bc = np.zeros((L, m_own[p], dim))
        om = np.zeros((L, m_own[p]))
        dr = torch.eye(bs, dtype=f64, device=dev_).repeat(L, m_own[p], 1, 1)
        dv = torch.zeros((L, m_own[p], bs, bs), dtype=f64, device=dev_)
        vtp = None
        if has_k:
            vtp = tensor.volume_tables(p, dim, p + 2,
                                       family=shards[0]["ebasis"].family)
            kshape = (dim, dim) if kmat else ()
            bk = np.zeros((L, m_own[p], len(vtp["weights"])) + kshape)
        if kmat:
            bih = np.zeros((L, m_own[p], dim))
            bdj = np.zeros((L, m_own[p]))
        for s in local:
            sh, r = shards[s], s - lo_s
            lane = sh.setdefault("lane_cache", {})
            ln = lane.get(("deg", p))
            if ln is None:
                ln = _deg_lane(sh, s, p, vtp)
                lane[("deg", p)] = ln
            no = ln["no"]
            om[r, :no] = 1.0
            if "ek" in ln:
                ek[r, :len(ln["ek"])] = ln["ek"]
                ei[r, :len(ln["ei"])] = ln["ei"]
            for ch in CHS:
                sv = ln["snd"][ch]
                snd[ch][r, :len(sv)] = sv
            if no:
                bc[r, :no] = ln["bc"]
                if kmat:
                    bih[r, :no] = ln["bih"]
                    bdj[r, :no] = ln["bdj"]
                if has_k:
                    bk[r, :no] = ln["bk"]
            D = sh["diag_cache"]
            if p in D and no:
                dr[r, :no] = D[p][:no]
                # the inverses ride the plan cache too
                dinv_c = sh.setdefault("dinv_cache", {})
                if p not in dinv_c:
                    dinv_c[p] = torch.linalg.inv(dr[r, :no])
                dv[r, :no] = dinv_c[p]
        tables["ext_kind"][p], tables["ext_idx"][p] = ek, ei
        tables["send"].update({(p, ch): snd[ch] for ch in CHS})
        # flattened gather of the extended bucket: source rows are
        # [x[p] (L*m_own) | recv(ch) (L*G) for each live channel]
        m = m_own[p]
        ext = srow * m + np.clip(ei, 0, m - 1)
        base = L * m
        live = []
        for ch in CHS:
            g_ = G[(p, ch)]
            if g_ == 0:
                continue
            sel = ek == ch
            ext = np.where(sel, base + srow * g_ + np.clip(ei, 0, g_ - 1),
                           ext)
            live.append((ch, g_))
            dd["send"][(p, ch)] = I((srow * m + snd[ch]).reshape(-1))
            base += L * g_
        dd["ext"][p] = (I(ext.reshape(-1)), live)
        blk = dict(bc=[J(bc[..., a].reshape(-1, *(1,) * dim))
                       for a in range(dim)])
        if has_k:
            blk["k"] = J(bk.reshape((L * m,) + bk.shape[2:]))
        if kmat:
            blk["invh"] = [J(bih[..., a].reshape(-1, *(1,) * dim))
                           for a in range(dim)]
            blk["detj"] = J(bdj.reshape(-1, *(1,) * dim))
        dd["bulk"][p] = blk
        dd["own"][p] = J(om.reshape(-1, 1))
        dd["dinv"][p] = dv.reshape(L * m, bs, bs).to(dtype)
        dd["diag"][p] = dr.reshape(L * m, bs, bs).to(dtype)

    # ---------------- interior face classes ----------------
    fam = shards[0]["ebasis"].family
    for c in FCLS:
        pi, po, ax, ncc = c
        F = Fmax[c]
        arr = dict(in_pos=np.zeros((L, F), _I), out_pos=np.zeros((L, F), _I),
                   own_in=np.zeros((L, F), bool),
                   own_out=np.zeros((L, F), bool),
                   fmeas=np.zeros((L, F)), pen=np.zeros((L, F)),
                   ihi=np.zeros((L, F)), iho=np.zeros((L, F)))
        ebasis_c, fg_c = rep[c]
        fin_c, fout_c = face_group_tables(ebasis_c, fg_c, max(pi, po) + 2)
        if has_k:
            kshape = (dim, dim) if kmat else ()
            arr["kq"] = np.zeros((L, F, len(fin_c["weights"])) + kshape)
            if affine:  # per-side effective tensors differ
                arr["kq_out"] = np.zeros_like(arr["kq"])
        if kmat:
            arr["ihi_all"] = np.zeros((L, F, dim))
            arr["iho_all"] = np.zeros((L, F, dim))

        def _fg_lane(sh, s):
            """Shard ``s``'s unpadded rows for face class ``c``."""
            rows = []
            for fg in sh["plan"].face_groups:
                if (fg.p_in, fg.p_out, fg.axis, fg.nc_code) != c:
                    continue
                ein = sh["emesh"].faces.inside[fg.face_ids]
                eout = sh["emesh"].faces.outside[fg.face_ids]
                row = dict(k=len(fg.face_ids), in_pos=fg.in_pos,
                           out_pos=fg.out_pos, own_in=ein < n_own[s],
                           own_out=eout < n_own[s], fmeas=fg.fmeas,
                           ihi=fg.inv_h_in, iho=fg.inv_h_out,
                           pen=(geo.penalty_coef_mesh(
                               sh["emesh"], fg, penalty, max(pi, po),
                               penalty_scaling)
                               if affine else
                               penalty_coef(fg, penalty, max(pi, po),
                                            penalty_scaling)))
                if has_k:
                    xpq = face_phys_points(sh["ebasis"], fg,
                                           fin_c["points"])
                    xq = (geo.apply_map(sh["emesh"], ein, xpq)
                          if affine else xpq)
                    kq_f = _host_k(diffusion, xq) \
                        if diffusion is not None else None
                    if affine:
                        row["kq"] = np.asarray(geo.effective_tensor(
                            sh["emesh"], ein, kq_f, xpq))
                        row["kq_out"] = np.asarray(geo.effective_tensor(
                            sh["emesh"], eout, kq_f, xpq))
                    else:
                        row["kq"] = kq_f
                if kmat:
                    row["ihi_all"] = 1.0 / sh["emesh"].extent[ein]
                    row["iho_all"] = 1.0 / sh["emesh"].extent[eout]
                rows.append(row)
            return rows

        for s in local:
            sh, r = shards[s], s - lo_s
            lane = sh.setdefault("lane_cache", {})
            rows = lane.get(("fg", c))
            if rows is None:
                rows = _fg_lane(sh, s)
                lane[("fg", c)] = rows
            for row in rows:
                k = row["k"]
                for key in ("in_pos", "out_pos", "own_in", "own_out",
                            "fmeas", "ihi", "iho", "pen"):
                    arr[key][r, :k] = row[key]
                if has_k:
                    arr["kq"][r, :k] = row["kq"]
                    if affine:
                        arr["kq_out"][r, :k] = row["kq_out"]
                if kmat:
                    arr["ihi_all"][r, :k] = row["ihi_all"]
                    arr["iho_all"][r, :k] = row["iho_all"]
        w = fin_c["weights"]
        t = dict(
            pi=pi, po=po, ax=ax,
            u_in=I((srow * m_ext[pi] + arr["in_pos"]).reshape(-1)),
            u_out=I((srow * m_ext[po] + arr["out_pos"]).reshape(-1)),
            tgt_in=I(np.where(arr["own_in"], srow * m_own[pi]
                              + arr["in_pos"], L * m_own[pi]).reshape(-1)),
            tgt_out=I(np.where(arr["own_out"], srow * m_own[po]
                               + arr["out_pos"], L * m_own[po]).reshape(-1)),
            zw=J(arr["fmeas"].reshape(-1, 1) * w[None, :]),
            penw=J(arr["pen"].reshape(-1, 1) * w[None, :]),
            ihi=J(arr["ihi"].reshape(-1, 1)), iho=J(arr["iho"].reshape(-1, 1)),
            Vi=J(fin_c["V"]), Di=J(fin_c["Dn"]), Vo=J(fout_c["V"]),
            Do=J(fout_c["Dn"]), ViT=J(fin_c["V"].T), DiT=J(fin_c["Dn"].T),
            VoT=J(fout_c["V"].T), DoT=J(fout_c["Dn"].T))
        if has_k and not kmat:
            t["kf"] = J(arr["kq"].reshape(L * F, -1))
        if kmat:
            kq = arr["kq"].reshape((L * F,) + arr["kq"].shape[2:])
            kqo = (arr["kq_out"] if "kq_out" in arr else arr["kq"]).reshape(
                kq.shape)
            t["Ka"], t["Kao"] = J(kq[..., ax, :]), J(kqo[..., ax, :])
            t["ihv"] = J(arr["ihi_all"].reshape(L * F, dim))
            t["ohv"] = J(arr["iho_all"].reshape(L * F, dim))
            t["Dalli"], t["Dallo"] = J(fin_c["Dall"]), J(fout_c["Dall"])
        dd["fg"][c] = t

    # ---------------- Dirichlet boundary classes ----------------
    for c in BCLS:
        p, ax, side = c
        B = Bmax[c]
        arr = dict(pos=np.zeros((L, B), _I), valid=np.zeros((L, B), bool),
                   fmeas=np.zeros((L, B)), pen=np.zeros((L, B)),
                   ih=np.zeros((L, B)))
        ftc = tensor.face_tables(p, dim, ax, side, p + 2, family=fam)
        if has_k:
            kshape = (dim, dim) if kmat else ()
            arr["kq"] = np.zeros((L, B, len(ftc["weights"])) + kshape)
        if kmat:
            arr["ih_all"] = np.zeros((L, B, dim))

        def _bg_lane(sh, s):
            """Shard ``s``'s unpadded rows for boundary class ``c``
            (owned faces only: ghost outer boundaries and detached fakes
            are no domain boundary)."""
            rows = []
            for bg in sh["plan"].boundary_groups:
                if (bg.p, bg.axis, bg.side) != c:
                    continue
                elems = sh["emesh"].bfaces.elem[bg.face_ids]
                keep = np.where(elems < n_own[s])[0]
                row = dict(k=len(keep), pos=bg.pos[keep],
                           fmeas=bg.fmeas[keep], ih=bg.inv_h[keep],
                           pen=(geo.boundary_penalty_coef_mesh(
                               sh["emesh"], bg, penalty, penalty_scaling)
                               if affine else
                               boundary_penalty_coef(
                                   bg, penalty, penalty_scaling))[keep])
                if has_k:
                    em = sh["emesh"]
                    els = elems[keep]
                    lo = em.lower[els].copy()
                    if side == 1:
                        lo[:, ax] += em.extent[els, ax]
                    tangs = [a_ for a_ in range(dim) if a_ != ax]
                    xpq = np.repeat(lo[:, None, :], len(ftc["weights"]),
                                    axis=1)
                    for t_, a_ in enumerate(tangs):
                        xpq[:, :, a_] += (ftc["points"][None, :, t_]
                                          * em.extent[els, a_][:, None])
                    xq = geo.apply_map(em, els, xpq)
                    kq_bd = _host_k(diffusion, xq) \
                        if diffusion is not None else None
                    if affine:
                        kq_bd = np.asarray(geo.effective_tensor(
                            em, els, kq_bd, xpq))
                    row["kq"] = kq_bd
                if kmat:
                    row["ih_all"] = 1.0 / sh["emesh"].extent[elems[keep]]
                rows.append(row)
            return rows

        for s in local:
            sh, r = shards[s], s - lo_s
            lane = sh.setdefault("lane_cache", {})
            rows = lane.get(("bg", c))
            if rows is None:
                rows = _bg_lane(sh, s)
                lane[("bg", c)] = rows
            for row in rows:
                k = row["k"]
                arr["valid"][r, :k] = True
                for key in ("pos", "fmeas", "ih", "pen"):
                    arr[key][r, :k] = row[key]
                if has_k:
                    arr["kq"][r, :k] = row["kq"]
                if kmat:
                    arr["ih_all"][r, :k] = row["ih_all"]
        w = ftc["weights"]
        sign = 1.0 if side == 1 else -1.0
        t = dict(p=p, ax=ax, sign=sign,
                 u=I((srow * m_ext[p] + arr["pos"]).reshape(-1)),
                 tgt=I(np.where(arr["valid"], srow * m_own[p] + arr["pos"],
                                L * m_own[p]).reshape(-1)),
                 zw=J(arr["fmeas"].reshape(-1, 1) * w[None, :]),
                 penw=J(arr["pen"].reshape(-1, 1) * w[None, :]),
                 sih=J(sign * arr["ih"].reshape(-1, 1)),
                 V=J(ftc["V"]), D=J(ftc["Dn"]), VT=J(ftc["V"].T),
                 DT=J(ftc["Dn"].T))
        if has_k and not kmat:
            t["kf"] = J(arr["kq"].reshape(L * B, -1))
        if kmat:
            kq = arr["kq"].reshape((L * B,) + arr["kq"].shape[2:])
            t["Ka"] = J(kq[..., ax, :])
            t["ih"] = J(arr["ih_all"].reshape(L * B, dim))
            t["Dall"] = J(ftc["Dall"])
        dd["bg"][c] = t

    # ---------------- static volume tables ----------------
    vt_dev = {}
    for p in DEG:
        vt = tensor.volume_tables(p, dim, p + 2, family=fam)
        t1 = vt["t1d"]
        V, D = J(t1.values), J(t1.derivatives)
        vt_dev[p] = dict(V=V, D=D, Vt=V.T.contiguous(), Dt=D.T.contiguous(),
                         wq=J(vt["weights"].reshape((len(t1.qweights),)
                                                    * dim)))

    # halo pairs per channel, and what one apply moves
    pairs = {ch: group.grid_pairs(axis, perm, device_grid)
             for ch, (axis, perm) in channels.items()}
    halo_el = sum(int(np.sum(degrees[send_ids[(s, ch)]] >= 0))
                  for ch in CHS for s, _ in pairs[ch])
    halo_dofs = sum(int(np.sum((degrees[send_ids[(s, ch)]] + 1) ** dim))
                    for ch in CHS for s, _ in pairs[ch])
    halo_rows = sum(G[(p, ch)] * len(pairs[ch]) for p in DEG for ch in CHS)

    # ---------------- the batched shard body ----------------
    def _body(dd, vt_dev):
        """The apply and block-Jacobi closures over the plan data."""
        scatter = {p: [] for p in DEG}
        for c in FCLS:
            t = dd["fg"][c]
            scatter[t["pi"]].append(t["tgt_in"])
            scatter[t["po"]].append(t["tgt_out"])
        for c in BCLS:
            t = dd["bg"][c]
            scatter[t["p"]].append(t["tgt"])
        scatter = {p: torch.cat(v) for p, v in scatter.items() if v}

        def _bulk(p, xp):
            it, b = vt_dev[p], dd["bulk"][p]
            n = xp.shape[0]
            d1 = it["V"].shape[0]
            u = xp.reshape((n,) + (d1,) * dim)
            tabs_f = lambda a: [it["D"] if c_ == a else it["V"]  # noqa: E731
                                for c_ in range(dim)]
            tabs_b = lambda a: [it["Dt"] if c_ == a else it["Vt"]  # noqa: E731
                                for c_ in range(dim)]
            out = 0.0
            if kmat:
                kq = b["k"].reshape((n,) + it["wq"].shape + (dim, dim))
                wdet = it["wq"][None] * b["detj"]
                dus = [_chain(u, tabs_f(c_)) * b["invh"][c_]
                       for c_ in range(dim)]
                for a in range(dim):
                    g = 0.0
                    for c_ in range(dim):
                        g = g + kq[..., a, c_] * dus[c_]
                    g = g * wdet * b["invh"][a]
                    out = out + _chain(g, tabs_b(a))
            else:
                kq = (b["k"].reshape((n,) + it["wq"].shape) if "k" in b
                      else None)
                for a in range(dim):
                    g = _chain(u, tabs_f(a)) * it["wq"][None] * b["bc"][a]
                    if kq is not None:
                        g = g * kq
                    out = out + _chain(g, tabs_b(a))
            return out.reshape(xp.shape)

        def apply(x):
            # halo exchange per degree per channel, then the extended buckets
            xe = {}
            for p in DEG:
                idx, live = dd["ext"][p]
                parts = [x[p]]
                for ch, g_ in live:
                    buf = x[p][dd["send"][(p, ch)]].reshape(L, g_, -1)
                    parts.append(group.permute(buf, pairs[ch]).reshape(
                        L * g_, -1))
                xe[p] = torch.cat(parts)[idx] if live else x[p][idx]
            contribs = {p: [] for p in scatter}
            for c in FCLS:
                t = dd["fg"][c]
                u_in, u_out = xe[t["pi"]][t["u_in"]], xe[t["po"]][t["u_out"]]
                jump = u_in @ t["Vi"] - u_out @ t["Vo"]
                zw, penw = t["zw"], t["penw"]
                if kmat:
                    Ka, Kao, ihv, ohv = t["Ka"], t["Kao"], t["ihv"], t["ohv"]
                    duin = torch.einsum("fi,biq->fbq", u_in, t["Dalli"])
                    duout = torch.einsum("fi,biq->fbq", u_out, t["Dallo"])
                    dninq = torch.einsum("fqb,fb,fbq->fq", Ka, ihv, duin)
                    dnoutq = torch.einsum("fqb,fb,fbq->fq", Kao, ohv, duout)
                    avg = 0.5 * (dninq + dnoutq)
                    t2b = zw * (-0.5 * jump)
                    contribs[t["pi"]].append(
                        (-zw * avg + penw * jump) @ t["ViT"] + torch.einsum(
                            "fq,fqb,fb,biq->fi", t2b, Ka, ihv, t["Dalli"]))
                    contribs[t["po"]].append(
                        (zw * avg - penw * jump) @ t["VoT"] + torch.einsum(
                            "fq,fqb,fb,biq->fi", t2b, Kao, ohv, t["Dallo"]))
                    continue
                dninq = (u_in @ t["Di"]) * t["ihi"]
                dnoutq = (u_out @ t["Do"]) * t["iho"]
                avg = 0.5 * (dninq + dnoutq)
                kf = t.get("kf", 1.0)
                t1_in = -zw * (kf * avg) + penw * jump
                t2 = zw * (-0.5 * kf * jump)
                t1_out = zw * (kf * avg) - penw * jump
                contribs[t["pi"]].append(t1_in @ t["ViT"]
                                         + (t2 * t["ihi"]) @ t["DiT"])
                contribs[t["po"]].append(t1_out @ t["VoT"]
                                         + (t2 * t["iho"]) @ t["DoT"])
            for c in BCLS:
                t = dd["bg"][c]
                u = xe[t["p"]][t["u"]]
                uq = u @ t["V"]
                zw, penw = t["zw"], t["penw"]
                if kmat:
                    du = torch.einsum("fi,biq->fbq", u, t["Dall"])
                    dnKq = t["sign"] * torch.einsum("fqb,fb,fbq->fq", t["Ka"],
                                                    t["ih"], du)
                    t1 = -zw * dnKq + penw * uq
                    contribs[t["p"]].append(
                        t1 @ t["VT"] + t["sign"] * torch.einsum(
                            "fq,fqb,fb,biq->fi", zw * (-uq), t["Ka"], t["ih"],
                            t["Dall"]))
                    continue
                dnq = (u @ t["D"]) * t["sih"]
                kf = t.get("kf", 1.0)
                t1 = -zw * (kf * dnq) + penw * uq
                t2 = zw * (-(kf * uq)) * t["sih"]
                contribs[t["p"]].append(t1 @ t["VT"] + t2 @ t["DT"])
            y = {}
            for p in DEG:
                yb = _bulk(p, x[p])
                if p in scatter:
                    yb = torch.cat([yb, yb.new_zeros((1, yb.shape[1]))])
                    yb = yb.index_add(0, scatter[p],
                                      torch.cat(contribs[p]).to(yb.dtype))
                    yb = yb[:-1]
                y[p] = yb * dd["own"][p].to(yb.dtype)
            return y

        def dinv_mul(r):
            return {p: torch.einsum("nij,nj->ni", dd["dinv"][p].to(r[p].dtype),
                                    r[p]) for p in DEG}
        return apply, dinv_mul

    apply, dinv_mul = _body(dd, vt_dev)

    def retype(dtype_):
        """The apply and block Jacobi of the same plan data in
        ``dtype_``."""
        return _body(_cast_floats(dd, dtype_), _cast_floats(vt_dev, dtype_))

    shardings = {p: Sharding(group, m_own[p]) for p in DEG}
    return HPSharded(cells=cells, degrees=degrees, ndev=ndev,
                     axis_name=axes[0], group=group, degree_set=DEG,
                     m_own=m_own, shardings=shardings,
                     owned_slots=owned_slots, apply=apply, dinv_mul=dinv_mul,
                     diag=dd["diag"], n_local=n_local, layer=layer,
                     axes=axes, device_grid=tuple(device_grid), dim=dim,
                     gmesh=gmesh, tables=tables, retype=retype,
                     halo=dict(elements=halo_el, dofs=halo_dofs,
                               padded_rows=halo_rows,
                               exchanges=sum(len(v) for _, v in
                                             dd["ext"].values())))


# ---------------------------------------------------------------------------
# global (sharded) vector helpers for bucket dicts
# ---------------------------------------------------------------------------

def hp_dot(a: dict, b: dict, group: ShardGroup | None = None):
    """Global dot product; ``group`` sums the rank-local partials (a
    one-process group needs none)."""
    parts = [torch.vdot(a[p].reshape(-1), b[p].reshape(-1)) for p in a]
    d = sum(parts[1:], parts[0])
    return group.psum(d) if group is not None else d


def hp_axpy(alpha, x: dict, y: dict) -> dict:
    return {p: y[p] + alpha * x[p] for p in y}


def hp_norm(a: dict, group: ShardGroup | None = None):
    return torch.sqrt(hp_dot(a, a, group).real)


def _zeros_like(b: dict) -> dict:
    return {p: torch.zeros_like(v) for p, v in b.items()}


def _pcg(apply, precond, b: dict, x: dict, iters: int, group):
    """Fixed-count PCG from ``x`` (a host loop with no host read; the
    guarded divisions make converged iterations no-ops).  Returns
    ``(x, r)``."""
    r = hp_axpy(-1.0, apply(x), b)
    z = precond(r)
    rz = hp_dot(r, z, group)
    pv = z
    for _ in range(iters):
        Ap = apply(pv)
        alpha = safe_div(rz, hp_dot(pv, Ap, group))
        x = hp_axpy(alpha, pv, x)
        r = hp_axpy(-alpha, Ap, r)
        z = precond(r)
        rz_new = hp_dot(r, z, group)
        pv = hp_axpy(safe_div(rz_new, rz), pv, z)
        rz = rz_new
    return x, r


def hp_pcg_solve(prob: HPSharded, b: dict, iters: int = 200,
                 x0: dict = None):
    """Block-Jacobi-preconditioned CG on sharded bucket dicts, ``iters``
    iterations.  Returns ``(x, ||r||)``."""
    x0 = x0 if x0 is not None else _zeros_like(b)
    x, r = _pcg(prob.apply, prob.dinv_mul, b, x0, iters, prob.group)
    return x, hp_norm(r, prob.group)


def _hp_rho_est(prob: HPSharded, dtype, iters: int = 30,
                precond=None) -> float:
    """Power-iteration estimate of rho(M^-1 A) for a sharded level (M =
    block diagonal by default, or ``precond``), from a fixed-seed random
    start: every rank draws the same GLOBAL vector (default_rng(1887)
    over the padded global shape, degrees ascending) and keeps its own
    rows, so the estimate does not depend on the number of ranks."""
    rng = np.random.default_rng(1887)
    g = prob.group
    v = {}
    for p in prob.degree_set:
        full = rng.standard_normal((prob.ndev * prob.m_own[p],
                                    (p + 1) ** prob.ndim))
        v[p] = torch.as_tensor(g.local_rows(full, prob.m_own[p]),
                               dtype=dtype, device=g.device)
    M = precond if precond is not None else prob.dinv_mul
    for _ in range(iters):
        w = M(prob.apply(v))
        nw = hp_norm(w, g)
        v = {p: a / nw for p, a in w.items()}
    return float(hp_norm(M(prob.apply(v)), g))


# ---------------------------------------------------------------------------
# sharded hp (mixed-degree) multigrid
# ---------------------------------------------------------------------------

@dataclass
class HPShardedPMG:
    levels: list        # coarsest..finest HPSharded problems
    degree_maps: list   # per-level global degree arrays
    step: callable      # (x, b) -> x on sharded bucket dicts


def _slot_index(prob: HPSharded, n_elements: int):
    """Global element -> (shard, owned slot within its degree bucket)."""
    shard = np.full(n_elements, -1, np.int64)
    slot = np.full(n_elements, -1, np.int64)
    for (s, p), ids in prob.owned_slots.items():
        shard[ids] = s
        slot[ids] = np.arange(len(ids))
    return shard, slot


def _local_tables(group, per_shard: list, fill: int):
    """Per-shard index lists (global shard order) -> this rank's padded
    ``[L, C]`` table and the common width ``C`` (the max over ALL
    shards, at least 1)."""
    C = max(max((len(v) for v in per_shard), default=0), 1)
    out = np.full((group.L, C), fill, np.int64)
    for s in group.shards:
        v = per_shard[s]
        out[s - group.shards.start, :len(v)] = v
    return out


def _transfer_fns(probf: HPSharded, probc: HPSharded, classes: dict,
                  Ts: dict, dtype):
    """Element-local restrict/prolong from per-class tables ``classes[key]
    = (fine slots [ndev lists], coarse slots [ndev lists], pf, pc)`` and
    blocks ``Ts[key]`` (bs_f, bs_c).  Padded entries target the dump
    rows; no communication."""
    g = probf.group
    L = g.L
    dev_ = g.device
    srow = np.arange(L)[:, None]
    I = lambda a: _idx(a, dev_)  # noqa: E731, E741
    tabs = []
    for key in sorted(classes):
        fs, cs, pf, pc = classes[key]
        Mf, Mc = probf.m_own[pf], probc.m_own[pc]
        fi = _local_tables(g, fs, Mf)
        ci = _local_tables(g, cs, Mc)
        T = torch.as_tensor(Ts[key], dtype=dtype, device=dev_)
        tabs.append(dict(
            pf=pf, pc=pc, T=T, TT=T.T.contiguous(),
            f_src=I(srow * Mf + np.minimum(fi, Mf - 1)),
            f_mask=torch.as_tensor((fi < Mf).reshape(-1, 1), dtype=dtype,
                                   device=dev_),
            c_tgt=I(np.where(ci < Mc, srow * Mc + ci, L * Mc)),
            c_src=I(srow * Mc + np.minimum(ci, Mc - 1)),
            f_tgt=I(np.where(fi < Mf, srow * Mf + fi, L * Mf))))
    dim = probf.ndim

    def restrict(rf):
        rc = {pc: torch.zeros((L * probc.m_own[pc] + 1, (pc + 1) ** dim),
                              dtype=dtype, device=dev_)
              for pc in probc.degree_set}
        for t in tabs:
            vals = (rf[t["pf"]][t["f_src"]] @ t["T"]) * t["f_mask"]
            rc[t["pc"]].index_add_(0, t["c_tgt"], vals)
        return {pc: v[:-1] for pc, v in rc.items()}

    def prolong(xc):
        xf = {pf: torch.zeros((L * probf.m_own[pf] + 1, (pf + 1) ** dim),
                              dtype=dtype, device=dev_)
              for pf in probf.degree_set}
        for t in tabs:
            xf[t["pf"]][t["f_tgt"]] = xc[t["pc"]][t["c_src"]] @ t["TT"]
        return {pf: v[:-1] for pf, v in xf.items()}

    return restrict, prolong


def _hp_transfer(probf: HPSharded, probc: HPSharded, degf, degc,
                 axis_name: str, dtype):
    """Element-local sharded p-transfer between two degree maps on the
    same mesh and partition (block-diagonal: no communication)."""
    dim = probf.ndim
    ndev = probf.ndev
    degc = np.asarray(degc).reshape(-1)
    pairs = sorted({(int(a), int(b)) for a, b in zip(degf, degc)})
    _, slot_c = _slot_index(probc, len(degc))
    classes, Ts = {}, {}
    for pf, pc in pairs:
        fs, cs = [], []
        for s in range(ndev):
            own_f = probf.owned_slots[(s, pf)]
            k = np.nonzero(degc[own_f] == pc)[0]
            fs.append(k)
            cs.append(slot_c[own_f[k]])
        classes[(pf, pc)] = (fs, cs, pf, pc)
        Ts[(pf, pc)] = tensor.interpolation_matrix(pc, pf, dim)
    return _transfer_fns(probf, probc, classes, Ts, dtype)


def _vcycle(probs, transfers, smooths, coarse_cg_iters):
    """The V-cycle of the sharded hierarchies: Chebyshev pre/post
    smoothing, element-local transfers, fixed-count block-Jacobi PCG on
    the coarsest level."""
    group = probs[0].group

    def coarse_solve(b):
        prob = probs[0]
        return _pcg(prob.apply, prob.dinv_mul, b, _zeros_like(b),
                    coarse_cg_iters, group)[0]

    def run(l, x, b):
        if l == 0:
            return coarse_solve(b)
        x = smooths[l](x, b)
        r = {p: b[p] - v for p, v in probs[l].apply(x).items()}
        restrict, prolong = transfers[l - 1]
        rc = restrict(r)
        xc = run(l - 1, _zeros_like(rc), rc)
        x = hp_axpy(1.0, prolong(xc), x)
        return smooths[l](x, b)

    return lambda x, b: run(len(probs) - 1, x, b)


def _cheb_smooths(probs, dtype, cheb_degree, precs=None):
    from hpdg_tpu_torch.solvers import smoothers as sm
    out = []
    for i, prob in enumerate(probs):
        M = precs[i] if precs is not None else prob.dinv_mul
        rho = _hp_rho_est(prob, dtype, precond=M)
        out.append(sm.chebyshev_smoother(prob.apply, M, lmax=1.1 * rho,
                                         degree=cheb_degree))
    return out


def _p_maps(degrees):
    dmaps = [degrees]
    while dmaps[-1].max() > 1:
        order = max(1, int(dmaps[-1].max()) // 2)
        dmaps.append(np.minimum(degrees, order).astype(_I))
    return dmaps


def build_hp_sharded_pmg(cells, degrees, group: ShardGroup | None = None,
                         penalty: float = 2.0, dirichlet: bool = True,
                         dtype=torch.float64,
                         penalty_scaling: str = "measure",
                         cheb_degree: int = 3, device_grid=None,
                         gmesh=None, diffusion=None,
                         coarse_cg_iters: int = 60) -> HPShardedPMG:
    """Sharded mixed-degree p-multigrid: level degree maps min(k_e,
    order) with the order halving to 1, Chebyshev(``cheb_degree``)
    smoothing on the block-Jacobi-preconditioned operator and a
    block-Jacobi PCG coarse solve.  ``gmesh``: a general box mesh to use
    instead of ``structured(cells)`` (one shared cut-plane partition)."""
    degrees = np.asarray(degrees, dtype=_I).reshape(-1)
    dmaps = _p_maps(degrees)[::-1]  # coarsest..finest
    if gmesh is not None:
        group = resolve_group(group)
        shard = slab_partition(gmesh, group.ndev)
        probs = [build_hp_sharded_general(
            gmesh, d, group=group, penalty=penalty, dirichlet=dirichlet,
            dtype=dtype, penalty_scaling=penalty_scaling, elem_shard=shard,
            diffusion=diffusion) for d in dmaps]
    else:
        probs = [build_hp_sharded(cells, d, group=group, penalty=penalty,
                                  dirichlet=dirichlet, dtype=dtype,
                                  penalty_scaling=penalty_scaling,
                                  device_grid=device_grid,
                                  diffusion=diffusion)
                 for d in dmaps]
    axis_name = probs[0].axis_name
    transfers = [_hp_transfer(probs[l + 1], probs[l], dmaps[l + 1], dmaps[l],
                              axis_name, dtype)
                 for l in range(len(probs) - 1)]
    smooths = _cheb_smooths(probs, dtype, cheb_degree)
    return HPShardedPMG(levels=probs, degree_maps=dmaps,
                        step=_vcycle(probs, transfers, smooths,
                                     coarse_cg_iters))


def hp_pmg_pcg_solve(pmg: HPShardedPMG, b: dict, iters: int = 30):
    """V-cycle-preconditioned CG on sharded bucket dicts, ``iters``
    iterations.  Returns ``(x, relative residual)``."""
    fine = pmg.levels[-1]
    g = fine.group
    nb = hp_norm(b, g)
    x, r = _pcg(fine.apply, lambda r: pmg.step(_zeros_like(r), r), b,
                _zeros_like(b), iters, g)
    return x, hp_norm(r, g) / nb


# ---------------------------------------------------------------------------
# sharded h-levels (uniform-degree geometric coarsening below p = 1)
# ---------------------------------------------------------------------------

def _child_T_matrices(pc: int, pf: int, dim: int, halve, dtype=None):
    """Per-child-position prolongation blocks (bs_f, bs_c): the
    degree-``pc`` parent basis at the child's degree-``pf`` nodes.
    ``halve[a]``: axis ``a`` coarsens 2:1.  Child position ``var``
    enumerates the halving axes, the first as the HIGHEST bit.  Host
    numpy f64."""
    from hpdg_tpu_torch.basis import lagrange
    nodes_c = lagrange.nodes_1d(pc, "lobatto")
    nodes_f = lagrange.nodes_1d(pf, "lobatto")
    mi_c = tensor.multiindices(pc, dim)
    mi_f = tensor.multiindices(pf, dim)
    haxes = [a for a in range(dim) if halve[a]]
    out = []
    for var in range(2 ** len(haxes)):
        bits = np.zeros(dim)
        scale = np.ones(dim)
        for t, a in enumerate(haxes):
            bits[a] = (var >> (len(haxes) - 1 - t)) & 1
            scale[a] = 0.5
        xp = scale[None, :] * (bits[None, :] + nodes_f[mi_f])
        per_axis = [lagrange.lagrange_values(nodes_c, xp[:, a])
                    for a in range(dim)]
        T = np.ones((len(mi_f), len(mi_c)))
        for a in range(dim):
            T = T * per_axis[a][mi_c[:, a], :].T
        out.append(T)
    return out


def _coarsen_degree_map(deg_f, cf, cc, rule: str = "max"):
    """Geometrically coarsened lattice degree map: per coarse element the
    max (or min) over its children's degrees."""
    dim = len(cf)
    deg_f = np.asarray(deg_f, dtype=_I).reshape(-1)
    coords = np.unravel_index(np.arange(int(np.prod(cf))), cf)
    pc = np.zeros(int(np.prod(cf)), np.int64)
    for a in range(dim):
        pc = pc * cc[a] + coords[a] // (cf[a] // cc[a])
    if rule == "max":
        out = np.zeros(int(np.prod(cc)), _I)
        np.maximum.at(out, pc, deg_f)
    else:
        out = np.full(int(np.prod(cc)), 127, _I)
        np.minimum.at(out, pc, deg_f)
    return out


def _hp_h_transfer(probf: HPSharded, probc: HPSharded, degf, degc,
                   axis_name: str, dtype):
    """Sharded geometric transfer between a lattice and its 2:1
    coarsening of some subset of axes, mixed degrees on either side
    (classes keyed (pc, pf, child position)).  The partitions are
    aligned, so every coarse element and its children share a shard:
    element-local GEMMs, no communication."""
    dim = len(probf.cells)
    ndev = probf.ndev
    cf, cc = probf.cells, probc.cells
    halve = tuple(cf[a] // cc[a] == 2 for a in range(dim))
    if any(cf[a] // cc[a] not in (1, 2) or cf[a] % cc[a] for a in range(dim)):
        raise ValueError(f"unsupported coarsening {cf} -> {cc}")
    haxes = [a for a in range(dim) if halve[a]]
    nc = 2 ** len(haxes)
    degf = np.asarray(degf, dtype=_I).reshape(-1)
    shard_f, slot_f = _slot_index(probf, len(degf))

    per = {}  # (pc, pf, var) -> per shard ([coarse slots], [fine slots])
    for s in range(ndev):
        for pc in probc.degree_set:
            ec = probc.owned_slots[(s, pc)]
            k = np.arange(len(ec))
            coords = np.unravel_index(ec, cc)
            for var in range(nc):
                fco = [np.asarray(c_) for c_ in coords]
                for t, a in enumerate(haxes):
                    fco[a] = 2 * coords[a] + ((var >> (len(haxes) - 1 - t))
                                              & 1)
                ef = np.ravel_multi_index(fco, cf) if len(ec) else \
                    np.empty(0, np.int64)
                if np.any(shard_f[ef] != s):
                    raise ValueError("partition misaligned: child and "
                                     "parent on different shards")
                pf_of = degf[ef]
                for pf in np.unique(pf_of):
                    sel = pf_of == pf
                    lst = per.setdefault(
                        (pc, int(pf), var),
                        [([], []) for _ in range(ndev)])
                    lst[s] = (k[sel], slot_f[ef[sel]])
    tcache, classes, Ts = {}, {}, {}
    for key in sorted(per):
        pc, pf, var = key
        if (pc, pf) not in tcache:
            tcache[(pc, pf)] = _child_T_matrices(pc, pf, dim, halve)
        Ts[key] = tcache[(pc, pf)][var]
        classes[key] = ([f for _, f in per[key]], [c for c, _ in per[key]],
                        pf, pc)
    return _transfer_fns(probf, probc, classes, Ts, dtype)


def build_hp_sharded_hmg(cells, degrees, h_levels: int = 1,
                         group: ShardGroup | None = None,
                         penalty: float = 2.0, dirichlet: bool = True,
                         dtype=torch.float64,
                         penalty_scaling: str = "measure",
                         cheb_degree: int = 5, cells_chain=None,
                         h_first: bool = False, device_grid=None,
                         h_first_rule: str = "uniform",
                         coarse_cg_iters: int = 60,
                         smoother: str = "cheb",
                         line_axis: int | None = None) -> HPShardedPMG:
    """Full sharded hp-multigrid: p-levels (min(k_e, order), halving) on
    the fine mesh, then ``h_levels`` geometric 2x coarsenings at p = 1.

    ``cells_chain``: explicit coarse-to-fine cells list (last == cells),
    e.g. a semicoarsening chain.  ``h_first``: the h-levels at the TOP
    of the hierarchy, p-levels on the coarsest mesh (the
    anisotropy-robust ordering; ``h_first_rule="geometric-max"`` carries
    coarsened degree maps down the h-chain).  ``smoother="line"``:
    Chebyshev over the line-block-tridiagonal preconditioner
    (``parallel.lines``), with the partition kept orthogonal to the line
    axis where it can be."""
    degrees = np.asarray(degrees, dtype=_I).reshape(-1)
    dim = len(cells)
    nd = (resolve_group(group).ndev if device_grid is None
          else int(np.prod(device_grid)))
    if smoother == "line" and device_grid is None and nd > 1:
        lax_ = line_axis if line_axis is not None else int(np.argmax(cells))
        if cells_chain is not None:
            chain_cells = [tuple(c) for c in cells_chain]
        else:
            chain_cells = [tuple(c // 2 ** l for c in cells)
                           for l in range(h_levels + 1)]
        cand = [a for a in range(dim) if a != lax_
                and all(c[a] % nd == 0 for c in chain_cells)]
        if cand:
            a = max(cand, key=lambda a: cells[a])
            device_grid = tuple(nd if i == a else 1 for i in range(a + 1))
    dgrid = tuple(device_grid) if device_grid is not None else (nd,)

    dmaps = _p_maps(degrees)
    if cells_chain is not None:
        hcells = [tuple(c) for c in reversed(list(cells_chain))]
        if hcells[0] != tuple(cells):
            raise ValueError("cells_chain must end with cells")
    else:
        hcells = [tuple(cells)]
        for _ in range(h_levels):
            nxt = tuple(c // 2 for c in hcells[-1])
            bad = any(c % 2 for c in hcells[-1]) or any(
                nxt[a] % dgrid[a] for a in range(len(dgrid)))
            if bad:
                raise ValueError(f"cannot h-coarsen {hcells[-1]} over "
                                 f"device grid {dgrid} (need even cells + "
                                 "divisible partitions)")
            hcells.append(nxt)
    kw = dict(group=group, penalty=penalty, dirichlet=dirichlet,
              dtype=dtype, penalty_scaling=penalty_scaling,
              device_grid=device_grid)
    probs = []
    if h_first and h_first_rule == "geometric-max" \
            and len(np.unique(degrees)) > 1:
        deg_chain = [degrees]
        for i in range(len(hcells) - 1):
            deg_chain.append(_coarsen_degree_map(
                deg_chain[-1], hcells[i], hcells[i + 1]))
        dc = deg_chain[-1]
        dmaps_c = _p_maps(dc)
        ccoarse = hcells[-1]
        level_deg = ([dm for dm in reversed(dmaps_c[1:])]
                     + [deg_chain[i]
                        for i in range(len(hcells) - 1, -1, -1)])
        level_cells = ([ccoarse] * (len(dmaps_c) - 1)
                       + [hcells[i] for i in range(len(hcells) - 1, -1, -1)])
    elif h_first:
        # p-levels to 1 on the COARSEST mesh, h-levels at the first
        # uniform order o* (the largest halving order <= min k_e), then
        # p-levels min(k_e, order) back up on the FINE mesh
        orders = [int(degrees.max())]
        while orders[-1] > 1:
            orders.append(max(1, orders[-1] // 2))
        dmin = int(degrees.min())
        ostar = next(o for o in orders if o <= dmin)
        ccoarse = hcells[-1]
        ncc = int(np.prod(ccoarse))
        coarse_orders = [o for o in orders if o < ostar]
        fine_maps = [np.minimum(degrees, o).astype(_I)
                     for o in orders if o > ostar]
        level_deg = ([np.full(ncc, o, _I) for o in reversed(coarse_orders)]
                     + [np.full(int(np.prod(cl)), ostar, _I)
                        for cl in reversed(hcells)]
                     + [dm for dm in reversed(fine_maps)])
        level_cells = ([ccoarse] * len(coarse_orders) + list(reversed(hcells))
                       + [tuple(cells)] * len(fine_maps))
    else:
        # coarsest..finest: h-levels (at p=1) below the p-levels
        level_deg = ([np.ones(int(np.prod(cl)), _I)
                      for cl in reversed(hcells[1:])]
                     + [dm for dm in reversed(dmaps)])
        level_cells = list(reversed(hcells[1:])) + [tuple(cells)] * len(dmaps)
    for cl, dm in zip(level_cells, level_deg):
        probs.append(build_hp_sharded(cl, dm, **kw))
    transfers = []
    for i in range(len(probs) - 1):
        fn = (_hp_h_transfer if probs[i].cells != probs[i + 1].cells
              else _hp_transfer)
        transfers.append(fn(probs[i + 1], probs[i], level_deg[i + 1],
                            level_deg[i], probs[0].axis_name, dtype))
    precs = None
    if smoother == "line":
        from hpdg_tpu_torch.parallel.lines import hp_line_precond
        precs = [hp_line_precond(prob, dm, axis=line_axis, penalty=penalty,
                                 dirichlet=dirichlet,
                                 penalty_scaling=penalty_scaling,
                                 dtype=dtype)
                 for prob, dm in zip(probs, level_deg)]
    smooths = _cheb_smooths(probs, dtype, cheb_degree, precs)
    return HPShardedPMG(levels=probs, degree_maps=level_deg,
                        step=_vcycle(probs, transfers, smooths,
                                     coarse_cg_iters))


# ---------------------------------------------------------------------------
# sharded h-levels on GENERAL adaptive meshes (refinement-history chain)
# ---------------------------------------------------------------------------

def _geo_T(p: int, dim: int, scale, shift, family, dtype=None):
    """Parent-basis-at-child-nodes block (bs_child, bs_parent) for the
    affine embedding x_parent = shift + scale * x_child (host f64)."""
    from hpdg_tpu_torch.basis import lagrange
    nodes = lagrange.nodes_1d(p, family)
    mi = tensor.multiindices(p, dim)
    xp = np.asarray(shift)[None, :] + nodes[mi] * np.asarray(scale)[None, :]
    T = np.ones((len(mi), len(mi)))
    for a in range(dim):
        va = lagrange.lagrange_values(nodes, xp[:, a])
        T = T * va[mi[:, a], :].T
    return T


def _hp_h_transfer_general(probf: HPSharded, probc: HPSharded,
                           fine_mesh, coarse_mesh, p: int, dtype):
    """Sharded transfer between an adaptively refined mesh and its parent
    mesh at uniform degree ``p``: per fine element one dense block chosen
    by its affine embedding class.  The partition is induced from the
    coarse mesh, so the transfer is element-local."""
    dim = probf.ndim
    ndev = probf.ndev
    anc = fine_mesh.parent
    scale = fine_mesh.extent / coarse_mesh.extent[anc]
    shift = (fine_mesh.lower - coarse_mesh.lower[anc]) \
        / coarse_mesh.extent[anc]
    q = np.rint(np.concatenate([scale, shift], axis=1) * 2**20).astype(
        np.int64)
    uniq, cls = np.unique(q, axis=0, return_inverse=True)
    cls = cls.reshape(-1)
    shard_c, slot_c = _slot_index(probc, coarse_mesh.n_elements)
    classes, Ts = {}, {}
    per = {c: ([], []) for c in range(len(uniq))}
    for s in range(ndev):
        own_f = probf.owned_slots[(s, p)]
        ec = anc[own_f]
        if np.any(shard_c[ec] != s):
            raise ValueError("induced partition misaligned: child and "
                             "parent on different shards")
        cf = cls[own_f]
        for c in range(len(uniq)):
            sel = np.nonzero(cf == c)[0]
            per[c][0].append(sel)
            per[c][1].append(slot_c[ec[sel]])
    for c in range(len(uniq)):
        Ts[c] = _geo_T(p, dim, uniq[c, :dim] / 2**20, uniq[c, dim:] / 2**20,
                       "lobatto")
        classes[c] = (per[c][0], per[c][1], p, p)
    return _transfer_fns(probf, probc, classes, Ts, dtype)


def build_hp_sharded_hmg_general(gmesh, degrees,
                                 group: ShardGroup | None = None,
                                 h_levels: int | None = None,
                                 penalty: float = 2.0,
                                 dirichlet: bool = True, dtype=torch.float64,
                                 penalty_scaling: str = "measure",
                                 cheb_degree: int = 5, diffusion=None,
                                 coarse_cg_iters: int = 60) -> HPShardedPMG:
    """Full sharded hp-multigrid on an adaptively refined mesh: p-levels
    on the fine mesh, then geometric h-levels along the refinement
    history (parent meshes) at p = 1.  The partition is computed on the
    coarsest mesh and induced on every finer one."""
    degrees = np.asarray(degrees, dtype=_I).reshape(-1)
    group = resolve_group(group)
    ndev = group.ndev
    chain = [gmesh]
    while chain[-1].parent_mesh is not None and (
            h_levels is None or len(chain) <= h_levels):
        chain.append(chain[-1].parent_mesh)
    shard_chain = [None] * len(chain)
    shard_chain[-1] = slab_partition(chain[-1], ndev)
    for li in range(len(chain) - 2, -1, -1):
        shard_chain[li] = shard_chain[li + 1][chain[li].parent]
    dmaps = _p_maps(degrees)
    kw = dict(group=group, penalty=penalty, dirichlet=dirichlet,
              dtype=dtype, penalty_scaling=penalty_scaling,
              diffusion=diffusion)
    probs = []
    for li in range(len(chain) - 1, 0, -1):
        probs.append(build_hp_sharded_general(
            chain[li], np.ones(chain[li].n_elements, _I),
            elem_shard=shard_chain[li], **kw))
    for dm in reversed(dmaps):
        probs.append(build_hp_sharded_general(
            gmesh, dm, elem_shard=shard_chain[0], **kw))
    level_deg = ([np.ones(chain[li].n_elements, _I)
                  for li in range(len(chain) - 1, 0, -1)]
                 + [dm for dm in reversed(dmaps)])
    transfers = []
    nh = len(chain) - 1
    for i in range(len(probs) - 1):
        if i < nh:  # h-pair: probs[i] on chain[nh-i], probs[i+1] finer
            lf = nh - i - 1
            transfers.append(_hp_h_transfer_general(
                probs[i + 1], probs[i], chain[lf], chain[lf + 1], 1, dtype))
        else:
            transfers.append(_hp_transfer(probs[i + 1], probs[i],
                                          level_deg[i + 1], level_deg[i],
                                          probs[0].axes[0], dtype))
    smooths = _cheb_smooths(probs, dtype, cheb_degree)
    return HPShardedPMG(levels=probs, degree_maps=level_deg,
                        step=_vcycle(probs, transfers, smooths,
                                     coarse_cg_iters))
