"""Matrix-free SIPG operators on uniform lattices."""

from hpdg_tpu_torch.matrixfree.uniform import (  # noqa: F401
    uniform_sipg_operator, uniform_sipg_factorized)
