"""Helpers the metric readers share."""

from __future__ import annotations

import numpy as np


def quantile(values, q: float, weights=None) -> float | None:
    """The smallest value with at least a share q of the weight at or
    below it (nearest rank; every weight 1 unless given)."""
    v = np.asarray(values, np.float64)
    if not len(v):
        return None
    w = np.ones_like(v) if weights is None else np.asarray(weights, np.float64)
    order = np.argsort(v, kind="stable")
    cum = np.cumsum(w[order])
    i = int(np.searchsorted(cum, q * cum[-1] - 1e-9 * cum[-1]))
    return float(v[order][min(i, len(v) - 1)])


def window_stats(run, key: str) -> float:
    return sum(c.stats[key] for c in run.calls)
