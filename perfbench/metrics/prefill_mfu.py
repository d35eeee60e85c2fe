"""FLOPs of the window's real prompt tokens (causal attention included,
the head once per prompt) over the bf16 peak times sum prefill_s."""

from .. import roofline as R
from .common import window_stats


def read(run):
    flops = sum(R.prefill_flops(run.model, n) for c in run.calls
                for n in c.prompt_lens)
    seconds = window_stats(run, "prefill_s")
    return 100.0 * flops / (R.PEAK_BF16_FLOPS * seconds) if seconds else None
