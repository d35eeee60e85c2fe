"""90th percentile over the window's requests of the first delivery
(`on_tokens` with at least one token) minus its call's start."""

from .common import quantile


def read(run):
    waits = [c.first[i] - c.t0 for c in run.calls for i in range(len(c.first))]
    return 1e3 * quantile(waits, 0.90)
