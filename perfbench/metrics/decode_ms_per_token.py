"""1000 * sum of `generate`'s decode_s over sum of its decode_tokens, over
the window's calls (host clock, each chunk ending in a device sync)."""

from .common import window_stats


def read(run):
    tokens = window_stats(run, "decode_tokens")
    return 1e3 * window_stats(run, "decode_s") / tokens if tokens else None
