"""95th percentile over every generated token after a request's first:
the gap between the request's successive deliveries divided by the
tokens the later one brought, each token weighted."""

from .common import quantile


def read(run):
    gaps, weights = [], []
    for c in run.calls:
        for deliveries in c.deliveries:
            for (t_prev, _), (t, n) in zip(deliveries, deliveries[1:]):
                if n:
                    gaps.append((t - t_prev) / n)
                    weights.append(n)
    q = quantile(gaps, 0.95, weights)
    return None if q is None else 1e3 * q
