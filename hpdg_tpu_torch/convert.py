"""Carry state across from ``hpdg_tpu`` into the port, as numpy.

The system has no learned weights: its state is bucket-dict vectors and
block-sparse matrices.  These helpers take their numpy form (for a
reference array ``a``: ``np.asarray(a)``) so that both packages can be
fed the same state without this package importing JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.linalg.blockmatrix import BlockPattern, BlockSparseMatrix


def bucket_dict(x: dict, dtype=None, device=None) -> dict:
    """``{key: array}`` (numpy) -> ``{key: Tensor}`` on ``device``."""
    device = dev.resolve(device)
    out = {}
    for key, a in x.items():
        t = torch.from_numpy(np.array(a, copy=True))
        out[key] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def to_numpy(x: dict) -> dict:
    """``{p: Tensor}`` -> ``{p: numpy array}`` on the host."""
    return {p: t.detach().cpu().numpy() for p, t in x.items()}


def block_sparse_matrix(row_sizes: dict, col_sizes: dict, entries: dict,
                        values: dict, dim: int, dtype=None,
                        device=None, block_shape=(1, 1)) -> BlockSparseMatrix:
    """A reference ``BlockSparseMatrix`` given as its pattern
    (``row_sizes``, ``col_sizes``, ``entries[(pr, pc)] = (rows, cols)``),
    ``values[(pr, pc)]`` as numpy and its ``block_shape`` -> the port's
    matrix."""
    pattern = BlockPattern(row_sizes, col_sizes,
                           {k: (np.asarray(r), np.asarray(c))
                            for k, (r, c) in entries.items()})
    vals = bucket_dict(values, dtype=dtype, device=device)
    return BlockSparseMatrix(pattern, dim, {k: vals[k] for k in values},
                             tuple(block_shape))


def saved_state(basis, flat):
    """A reference ``SavedState`` given as its numpy ``flat`` vector, with
    ``basis`` the port's ``DGBasis`` on the same element boxes and degree
    map -> the port's ``blocks.persist.SavedState``."""
    from hpdg_tpu_torch.blocks.persist import SavedState
    flat = np.array(flat, dtype=np.float64, copy=True)
    if flat.shape != (basis.ndof,):
        raise ValueError(f"flat vector of shape {flat.shape}, the basis has "
                         f"{basis.ndof} dofs")
    return SavedState(basis=basis, flat=flat)


def mesh(dim: int, lower, extent, faces: dict, bfaces: dict, jac=None,
         shift=None, corners=None, parent=None, child_pos=None,
         parent_mesh=None):
    """A reference ``Mesh`` given as its numpy fields -> the port's
    ``Mesh`` with the IDENTICAL topology (no re-matching, so element
    frames and face charts of an importer carry over one to one).

    ``faces``: ``inside``, ``outside``, ``axis`` and optionally
    ``nc_code``, ``in_side``, ``out_axis``, ``out_side``, ``twist``;
    ``bfaces``: ``elem``, ``axis``, ``side``.  ``parent_mesh`` is the
    port's mesh that ``parent`` indexes into (already converted)."""
    from hpdg_tpu_torch.mesh.structured import BoundaryFaces, Faces, Mesh
    i32 = lambda a: np.array(a, dtype=np.int32, copy=True)  # noqa: E731
    f64 = lambda a: (None if a is None  # noqa: E731
                     else np.array(a, dtype=np.float64, copy=True))
    return Mesh(
        dim=int(dim), lower=f64(lower), extent=f64(extent),
        faces=Faces(**{k: i32(v) for k, v in faces.items()}),
        bfaces=BoundaryFaces(**{k: i32(v) for k, v in bfaces.items()}),
        parent=None if parent is None else i32(parent),
        child_pos=None if child_pos is None else i32(child_pos),
        parent_mesh=parent_mesh, jac=f64(jac), shift=f64(shift),
        corners=f64(corners))
