"""Vertex/cell arrays of small unstructured test domains, as a mesh
generator (Gmsh, meshio) would hand them over: ``points`` (npts, dim)
and ``cells`` (ncells, 2^dim) vertex ids in VTK quad/hexahedron order.

Used by the geometry examples, the tests and ``chip_smoke.py``; the
importers of ``mesh.geometry`` turn them into meshes.
"""

from __future__ import annotations

import numpy as np

# VTK corner order of the unit quad / hexahedron
VTK_QUAD = np.array([[0, 0], [1, 0], [1, 1], [0, 1]])
VTK_HEX = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
# one quarter turn of a cell's VTK numbering about its last axis
ROT_QUAD = np.array([1, 2, 3, 0])
ROT_HEX = np.array([1, 2, 3, 0, 5, 6, 7, 4])


def lattice(shape):
    """The unit lattice with ``shape`` cells per axis: integer vertex
    coordinates and cells in lattice C order (last axis fastest), what a
    transfinite (structured) Gmsh volume emits."""
    shape = tuple(int(s) for s in shape)
    dim = len(shape)
    grids = np.meshgrid(*[np.arange(s + 1) for s in shape], indexing="ij")
    pts = np.stack(grids, -1).reshape(-1, dim).astype(np.float64)
    strides = np.array([int(np.prod([s + 1 for s in shape[a + 1:]]))
                        for a in range(dim)])
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                               indexing="ij"), -1).reshape(-1, dim)
    ref = VTK_HEX if dim == 3 else VTK_QUAD
    return pts, np.stack([(idx + r) @ strides for r in ref], axis=1)


def mapped_lattice(shape, phi):
    """:func:`lattice` on the unit box, its vertices mapped by ``phi``
    ((m, dim) -> (m, dim))."""
    pts, cells = lattice(shape)
    return np.asarray(phi(pts / np.asarray(shape, np.float64)),
                      np.float64), cells


def annulus_quarter(x):
    """Unit square -> the annulus quarter 1 <= r <= 2, 0 <= theta <= pi/2."""
    x = np.asarray(x, np.float64)
    r, th = 1.0 + x[..., 0], 0.5 * np.pi * x[..., 1]
    return np.stack([r * np.cos(th), r * np.sin(th)], -1)


def cylinder_quarter(x):
    """Unit cube -> the quarter hollow cylinder
    ``((1+x0) cos(pi x1/2), (1+x0) sin(pi x1/2), x2)``, volume 3 pi/4."""
    x = np.asarray(x, np.float64)
    return np.concatenate([annulus_quarter(x[..., :2]), x[..., 2:]], -1)


def extrude(pts2, cells2, layers: int, height: float = 1.0):
    """Quads -> hexes: ``layers`` layers of equal thickness along z."""
    n = len(pts2)
    z = np.linspace(0.0, height, layers + 1)
    pts = np.concatenate([np.concatenate([pts2, np.full((n, 1), zk)], 1)
                          for zk in z])
    cells = np.concatenate([np.concatenate([cells2 + k * n,
                                            cells2 + (k + 1) * n], 1)
                            for k in range(layers)])
    return pts, cells


def ogrid_disk(nb: int, half: float = 0.45):
    """An O-grid ("butterfly") mesh of the unit disk: a centre block of
    ``nb x nb`` quads on the square ``[-half, half]^2`` and four outer
    blocks of ``nb x nb`` quads between its sides and the circle.  The
    four corners of the square are valence-3 vertices, so no
    identity-aligned global frame assignment exists: an import needs
    twisted face charts.  Returns ``(points, cells, counts)`` with
    ``counts = (n_interior_edges, n_boundary_edges)`` counted from the
    blocks."""
    t = np.linspace(0.0, 1.0, nb + 1)
    blocks = []
    g = np.stack(np.meshgrid(t, t, indexing="ij"), -1)  # (nb+1, nb+1, 2)
    blocks.append(half * (2.0 * g - 1.0))
    for k in range(4):  # the sides of the square, counter-clockwise
        ang0 = -0.75 * np.pi + 0.5 * np.pi * k
        c, s = np.cos(0.5 * np.pi * k), np.sin(0.5 * np.pi * k)
        rot = np.array([[c, -s], [s, c]])
        side = np.stack([half * (2.0 * t - 1.0), np.full(nb + 1, -half)],
                        -1) @ rot.T  # bottom side, turned k times
        ang = ang0 + 0.5 * np.pi * t
        arc = np.stack([np.cos(ang), np.sin(ang)], -1)
        r = t[None, :, None]
        blocks.append((1.0 - r) * side[:, None, :] + r * arc[:, None, :])
    allp = np.concatenate([b.reshape(-1, 2) for b in blocks])
    key = np.rint(allp * 1e9).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    pts = allp[first]
    inv = inv.reshape(-1)
    cells = []
    for b in range(5):
        vid = inv[b * (nb + 1) ** 2:(b + 1) * (nb + 1) ** 2].reshape(
            nb + 1, nb + 1)
        quad = np.stack([vid[:-1, :-1], vid[1:, :-1], vid[1:, 1:],
                         vid[:-1, 1:]], -1).reshape(-1, 4)
        cells.append(quad)
    cells = np.concatenate(cells)
    # VTK quads are counter-clockwise: mirror the clockwise ones
    p = pts[cells]
    area = 0.5 * ((p[:, 2, 0] - p[:, 0, 0]) * (p[:, 3, 1] - p[:, 1, 1])
                  - (p[:, 3, 0] - p[:, 1, 0]) * (p[:, 2, 1] - p[:, 0, 1]))
    cells[area < 0] = cells[area < 0][:, [0, 3, 2, 1]]
    return pts, cells, (10 * nb * nb - 2 * nb, 4 * nb)


def ogrid_cylinder(nb: int, layers: int):
    """:func:`ogrid_disk` extruded to ``layers`` layers of hexes.
    ``counts = (n_interior_faces, n_boundary_faces)``."""
    pts2, cells2, (e_int, e_bnd) = ogrid_disk(nb)
    pts, cells = extrude(pts2, cells2, layers)
    n2 = len(cells2)
    return pts, cells, (e_int * layers + n2 * (layers - 1),
                        e_bnd * layers + 2 * n2)


def shuffle_and_rotate(cells, rng):
    """The same mesh as a generator with no lattice in mind would write
    it: cells in random order, each cell's VTK numbering turned by a
    random number of quarter turns."""
    cells = np.array(cells, copy=True)[rng.permutation(len(cells))]
    rot = ROT_HEX if cells.shape[1] == 8 else ROT_QUAD
    turns = rng.integers(0, 4, len(cells))
    for k in range(1, 4):
        sel = turns >= k
        cells[sel] = cells[sel][:, rot]
    return cells
