"""Sharded colored vertex-patch Schwarz sweeps (slab partitions).

Port of ``hpdg_tpu.parallel.patches``: the multiplicative sweep of
``solvers.patches`` over 2^dim parity colors, one shard program per
color.  A patch at a shard-boundary vertex spans one owned and one ghost
slab on each side; both shards receive the neighbour layer by
``ppermute`` (the exchange the apply uses) and solve the identical patch
redundantly, each keeping only its OWNED lanes, so no correction flows
back.  On a uniform lattice the patch operator depends only on which
outer faces are domain-boundary faces, so one dense inverse per class
serves every patch in it.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch.solvers import patches as spat


def _lattice_patches(cells):
    """Full-lattice vertex patches: per color (parity tuple, sorted),
    ``(verts [n, dim], els [n, 2^dim])`` with element ids in C order."""
    dim = len(cells)
    k = 1 << dim
    offs = np.array([[(c >> (dim - 1 - a)) & 1 for a in range(dim)]
                     for c in range(k)], dtype=np.int64)
    strides = np.array([int(np.prod(cells[a + 1:])) for a in range(dim)],
                       dtype=np.int64)
    verts = np.stack(np.meshgrid(*[np.arange(c - 1) for c in cells],
                                 indexing="ij"), axis=-1).reshape(-1, dim)
    els = (verts[:, None, :] + offs[None, :, :]) @ strides
    colors = {}
    par = verts % 2
    for key in sorted({tuple(r) for r in par}):
        sel = np.all(par == np.asarray(key), axis=1)
        colors[key] = (verts[sel], els[sel].astype(np.int64))
    return list(colors.values())


def _class_key(v, cells):
    return tuple((int(v[a]) == 0, int(v[a]) == cells[a] - 2)
                 for a in range(len(cells)))


def sharded_patch_sweeps(prob, A, basis, dtype=torch.float64):
    """``(forward, backward)`` multiplicative patch sweeps ``sweep(x, b)
    -> x`` for a slab-sharded uniform-degree problem (``cells``,
    ``ndev``, ``layer``, ``n_local``, ``apply``, ``group``; global
    ``[N, bs]`` arrays slab-partitioned along lattice axis 0).
    ``A``/``basis``: the SERIAL level operator the patch inverses come
    from."""
    cells = tuple(int(c) for c in prob.cells)
    dim = len(cells)
    k = 1 << dim
    (p,) = basis.bucket_degrees
    bs = getattr(prob, "bs", (p + 1) ** dim)
    K = k * bs
    group = prob.group
    dev_ = group.device
    L = group.L
    ndev, layer, n_local = prob.ndev, prob.layer, prob.n_local
    n_ext = n_local + 2 * layer
    loc0 = cells[0] // ndev

    inv_cache = {}

    def class_inverse(key, rep_els):
        if key not in inv_cache:
            inv = spat.patch_inverses(
                A, basis, [rep_els[None, :].astype(np.int32)], dtype=dtype,
                device=dev_)[0]
            inv_cache[key] = inv[0]
        return inv_cache[key]

    right_perm = [(i, i + 1) for i in range(ndev - 1)]
    left_perm = [(i + 1, i) for i in range(ndev - 1)]
    lo = group.shards.start

    color_tabs = []
    for verts, els in _lattice_patches(cells):
        by_class = {}
        for i in range(len(verts)):
            by_class.setdefault(_class_key(verts[i], cells), []).append(i)
        groups = []
        for key, ids in sorted(by_class.items()):
            ids = np.asarray(ids)
            inv = class_inverse(key, els[ids[0]])
            v0 = verts[ids, 0]
            per_shard = []
            for s in range(ndev):
                sel = ids[(v0 >= s * loc0 - 1) & (v0 <= (s + 1) * loc0 - 1)]
                e = els[sel]
                lidx = e - s * n_local + layer    # extended-local
                own = (e >= s * n_local) & (e < (s + 1) * n_local)
                per_shard.append((lidx, own))
            npat = max(len(t[0]) for t in per_shard)
            Li = np.zeros((L, npat, k), dtype=np.int64)
            O = np.zeros((L, npat, k), dtype=bool)
            for s in group.shards:
                lidx, own = per_shard[s]
                Li[s - lo, :len(lidx)] = lidx
                O[s - lo, :len(own)] = own
            flat = (np.arange(L)[:, None, None] * n_ext + Li).reshape(-1)
            groups.append((torch.as_tensor(flat, device=dev_),
                           torch.as_tensor(O.reshape(-1, k, 1), dtype=dtype,
                                           device=dev_), inv, L * npat))
        color_tabs.append(groups)

    def correction(r, groups):
        rs = r.reshape(L, n_local, bs)
        rl = group.ppermute(rs[:, -layer:].contiguous(), 0, right_perm)
        rr = group.ppermute(rs[:, :layer].contiguous(), 0, left_perm)
        re = torch.cat([rl, rs, rr], 1).reshape(L * n_ext, bs)
        dx = torch.zeros_like(re)
        for flat, own, inv, n in groups:
            rg = re[flat].reshape(n, K)
            y = (rg @ inv.T.to(r.dtype)).reshape(n, k, bs) * own.to(r.dtype)
            dx.index_add_(0, flat, y.reshape(n * k, bs))
        return dx.reshape(L, n_ext, bs)[:, layer:-layer].reshape(
            L * n_local, bs)

    def make_sweep(order):
        def sweep(x, b):
            for groups in order:
                r = b - prob.apply(x)
                x = x + correction(r, groups)
            return x
        return sweep

    return make_sweep(color_tabs), make_sweep(color_tabs[::-1])
