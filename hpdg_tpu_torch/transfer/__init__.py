"""Transfer operators: p-coarsening and h-coarsening."""

from hpdg_tpu_torch.transfer.element import (  # noqa: F401
    ElementTransfer, p_transfer, h_transfer, p_coarse_degrees)
