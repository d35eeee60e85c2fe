"""Milliseconds of `generate`'s prefill_s per 1000 real prompt tokens,
over the window's calls."""

from .common import window_stats


def read(run):
    tokens = sum(sum(c.prompt_lens) for c in run.calls)
    return 1e6 * window_stats(run, "prefill_s") / tokens if tokens else None
