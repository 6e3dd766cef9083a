"""High-level building blocks (the reference's BuildingBlocks API);
``persist`` waits for ROADMAP queue 1, item 18."""

from hpdg_tpu_torch.blocks import api  # noqa: F401
