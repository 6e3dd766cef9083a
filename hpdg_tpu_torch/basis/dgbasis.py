"""The hp-DG function-space basis: per-element degrees + degree buckets.

Port of ``hpdg_tpu.basis.dgbasis`` (host-side numpy, unchanged
semantics): every element carries its own polynomial degree, and
elements are bucketed by degree so that every downstream operator works
on one dense ``[n_p, (p+1)^dim]`` tensor per bucket.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hpdg_tpu_torch.basis import lagrange, tensor
from hpdg_tpu_torch.mesh.structured import Mesh


@dataclass(frozen=True)
class DGBasis:
    mesh: Mesh
    degrees: np.ndarray  # (n_elements,) int32 per-element polynomial degree
    family: str = "lobatto"

    # ---- derived bucket metadata (filled in __post_init__) ----
    bucket_degrees: tuple = field(init=False)  # sorted unique degrees
    bucket_elems: dict = field(init=False)  # p -> int32 array of element ids
    elem_bucket_pos: np.ndarray = field(init=False)  # (n,) position within its bucket
    offsets: np.ndarray = field(init=False)  # (n,) flat dof offset per element
    block_sizes: np.ndarray = field(init=False)  # (n,) (p_e+1)^dim
    ndof: int = field(init=False)

    def __post_init__(self):
        degrees = np.asarray(self.degrees, dtype=np.int32)
        object.__setattr__(self, "degrees", degrees)
        uniq = np.unique(degrees)
        bucket_elems = {}
        pos = np.zeros(len(degrees), dtype=np.int32)
        for p in uniq:
            elems = np.where(degrees == p)[0].astype(np.int32)
            bucket_elems[int(p)] = elems
            pos[elems] = np.arange(len(elems), dtype=np.int32)
        bs = (degrees.astype(np.int64) + 1) ** self.mesh.dim
        offsets = np.zeros(len(degrees), dtype=np.int64)
        np.cumsum(bs[:-1], out=offsets[1:])
        object.__setattr__(self, "bucket_degrees", tuple(int(p) for p in uniq))
        object.__setattr__(self, "bucket_elems", bucket_elems)
        object.__setattr__(self, "elem_bucket_pos", pos)
        object.__setattr__(self, "offsets", offsets)
        object.__setattr__(self, "block_sizes", bs.astype(np.int32))
        object.__setattr__(self, "ndof", int(bs.sum()))

    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.mesh.dim

    def n_local(self, p: int) -> int:
        return (p + 1) ** self.mesh.dim

    def bucket_size(self, p: int) -> int:
        return len(self.bucket_elems[p])

    def max_degree(self) -> int:
        return int(self.degrees.max())

    def node_positions(self, p: int) -> np.ndarray:
        """Physical positions of the nodal dofs of bucket p, shape
        ``(n_p, (p+1)^dim, dim)`` (mapped through the mesh's geometry
        where it has one)."""
        from hpdg_tpu_torch.mesh import geometry as geo
        ref = lagrange.nodes_1d(p, self.family)[tensor.multiindices(p,
                                                                    self.dim)]
        elems = self.bucket_elems[p]
        x = (self.mesh.lower[elems][:, None, :]
             + ref[None, :, :] * self.mesh.extent[elems][:, None, :])
        return geo.apply_map(self.mesh, elems, x)

    def with_degrees(self, degrees: np.ndarray) -> "DGBasis":
        return DGBasis(self.mesh, degrees, self.family)
