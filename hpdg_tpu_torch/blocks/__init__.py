"""High-level building blocks (the reference's BuildingBlocks API) and
state persistence across adaptation."""

from hpdg_tpu_torch.blocks import api, persist  # noqa: F401
