"""Marking utilities for adaptive refinement (host numpy).

Port of ``hpdg_tpu.estimators.utility`` (estimators/utility.hh of the
reference): ``quantile``, the Dörfler threshold ``fraction`` and
``mark_fraction``.
"""

from __future__ import annotations

import numpy as np


def quantile(values, q: float) -> float:
    """The q-quantile of the given per-element values."""
    v = np.sort(np.asarray(values))
    idx = min(len(v) - 1, int(q * len(v)))
    return float(v[idx])


def fraction(errors, frac: float) -> float:
    """Dörfler marking threshold: the largest t such that the elements
    with error >= t carry at least ``frac`` of the total error."""
    e = np.sort(np.asarray(errors))[::-1]
    total = e.sum()
    if total <= 0:
        return 0.0
    csum = np.cumsum(e)
    k = int(np.searchsorted(csum, frac * total))
    k = min(k, len(e) - 1)
    return float(e[k])


def mark_fraction(errors, frac: float) -> np.ndarray:
    """Boolean mask of elements to refine by Dörfler marking."""
    t = fraction(errors, frac)
    return np.asarray(errors) >= t
