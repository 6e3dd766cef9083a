"""Error norms against an exact solution, Dörfler marking and the hp
smoothness indicator."""

from hpdg_tpu_torch.estimators.error import (  # noqa: F401
    h1_seminorm_error, l2_error)
from hpdg_tpu_torch.estimators.smoothness import smoothness_indicator  # noqa: F401
from hpdg_tpu_torch.estimators.utility import (  # noqa: F401
    fraction, mark_fraction, quantile)
