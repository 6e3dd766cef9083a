"""VTK (.vtu) output: subsampled plots of hp-DG discretizations.

Port of ``hpdg_tpu.blocks.plot`` (the reference's BuildingBlocks::plot):
every element is subdivided into p^dim linear sub-cells with vertices at
the nodal points (DG: points are duplicated across element borders on
purpose), the coefficient vector becomes point data, and the
per-element polynomial degree is written as cell data.

A host-side ASCII XML writer: a state on any device is copied to the
host, and the file is byte-identical to the reference's for the same
state.
"""

from __future__ import annotations

import numpy as np

from hpdg_tpu_torch.basis.dgbasis import DGBasis


def _subcells(p: int, dim: int) -> np.ndarray:
    """Connectivity of the p^dim linear sub-cells in VTK vertex order,
    indices into the element's (p+1)^dim C-ordered node grid."""
    stride = [(p + 1) ** (dim - 1 - a) for a in range(dim)]

    def nid(idx):
        return sum(i * s for i, s in zip(idx, stride))

    cells = []
    ranges = np.stack(np.meshgrid(*[np.arange(p)] * dim, indexing="ij"),
                      axis=-1).reshape(-1, dim)
    for c in ranges:
        if dim == 2:
            i, j = c
            cells.append([nid((i, j)), nid((i + 1, j)),
                          nid((i + 1, j + 1)), nid((i, j + 1))])
        elif dim == 3:
            i, j, k = c
            cells.append([nid((i, j, k)), nid((i + 1, j, k)),
                          nid((i + 1, j + 1, k)), nid((i, j + 1, k)),
                          nid((i, j, k + 1)), nid((i + 1, j, k + 1)),
                          nid((i + 1, j + 1, k + 1)), nid((i, j + 1, k + 1))])
        else:
            i = c[0]
            cells.append([nid((i,)), nid((i + 1,))])
    return np.asarray(cells, dtype=np.int64)


_VTK_TYPE = {1: 3, 2: 9, 3: 12}  # line, quad, hexahedron


def write_vtu(path: str, basis: DGBasis, x: dict | None = None,
              name: str = "u"):
    """Write the mesh (and optionally the discrete function x) to `path`."""
    dim = basis.dim
    pts_all, conn_all, types_all, vals_all, deg_all = [], [], [], [], []
    offset = 0
    for p in basis.bucket_degrees:
        pos = basis.node_positions(p)  # (n, nl, dim)
        n, nl, _ = pos.shape
        pts = np.zeros((n * nl, 3))
        pts[:, :dim] = pos.reshape(-1, dim)
        pts_all.append(pts)
        sub = _subcells(p, dim)  # (ncell, verts)
        base = offset + np.arange(n)[:, None, None] * nl
        conn = (base + sub[None, :, :]).reshape(-1, sub.shape[1])
        conn_all.append(conn)
        types_all.append(np.full(len(conn), _VTK_TYPE[dim], dtype=np.int8))
        deg_all.append(np.full(len(conn), p, dtype=np.int32))
        if x is not None:
            vals_all.append(x[p].detach().cpu().numpy().reshape(-1))
        offset += n * nl

    pts = np.concatenate(pts_all)
    ncells = sum(len(c) for c in conn_all)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{len(pts)}" '
                f'NumberOfCells="{ncells}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        np.savetxt(f, pts, fmt="%.12g")
        f.write('</DataArray></Points>\n<Cells>\n')
        f.write('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
        for conn in conn_all:
            np.savetxt(f, conn, fmt="%d")
        f.write('</DataArray>\n<DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        offs = np.cumsum(np.concatenate(
            [np.full(len(c), c.shape[1], dtype=np.int64) for c in conn_all]))
        np.savetxt(f, offs, fmt="%d")
        f.write('</DataArray>\n<DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        np.savetxt(f, np.concatenate(types_all), fmt="%d")
        f.write('</DataArray>\n</Cells>\n')
        if x is not None:
            f.write(f'<PointData Scalars="{name}">'
                    f'<DataArray type="Float64" Name="{name}" '
                    'format="ascii">\n')
            np.savetxt(f, np.concatenate(vals_all), fmt="%.12g")
            f.write('</DataArray></PointData>\n')
        f.write('<CellData Scalars="degree">'
                '<DataArray type="Int32" Name="degree" format="ascii">\n')
        np.savetxt(f, np.concatenate(deg_all), fmt="%d")
        f.write('</DataArray></CellData>\n')
        f.write('</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')
