"""Utilities: typed config tree + CLI parsing, timers/profiling."""

from hpdg_tpu_torch.utils.config import ParameterTree, parse_cli  # noqa: F401
from hpdg_tpu_torch.utils.timer import Timer, profile_region  # noqa: F401
