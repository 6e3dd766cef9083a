"""Meshes as precomputed connectivity arrays (host-side numpy)."""

from hpdg_tpu_torch.mesh.structured import (Mesh, structured, refine,  # noqa: F401
                                            hierarchy, from_boxes, lshape)
