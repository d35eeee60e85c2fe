"""FLOPs of the window's generated tokens after each request's first (2 *
P_mm per token plus attention over each token's context, from the
positions the decode spans saw) over the bf16 peak times sum decode_s.
The window's calls are untraced; the traced call comes after them."""

from .. import roofline as R
from .common import window_stats


def read(run):
    flops = 0.0
    for call, steps, live in run.spans.decode:
        if 1 <= call <= len(run.calls):
            rows = int((live + 1).sum()) * steps + len(live) * steps * (steps - 1) // 2
            flops += R.decode_flops(run.model, len(live) * steps, rows)
    seconds = window_stats(run, "decode_s")
    return 100.0 * flops / (R.PEAK_BF16_FLOPS * seconds) if seconds and flops else None
