"""Sum over one call's prefill chunks of the least time of their
quantized matrix products at the chunk's padded width t
(`roofline.mmq_bound_s(model, t)`, from `generate`'s `prefill_widths`),
over the device time of the MMQ groups (split-K sums and bf16 casts
included) in the traced call outside its decode spans: every decode
kernel runs inside a decode span, which ends in the chunk's read, so the
rest are the prefill's. The bound takes its widths from the last window
call and the time from the traced call: it assumes the two take the same
widths, which holds because every call of a mix prefills the same prompt
lengths. Once the harness keeps the traced call's record, read the
widths from it instead. None where the program does not count the
widths."""

from .. import roofline as R
from ..trace import MMQ_GROUPS


def read(run):
    if run.trace is None or not run.calls:
        return None
    widths = run.calls[-1].stats.get("prefill_widths")
    if not widths:
        return None
    bound = sum(n * R.mmq_bound_s(run.model, t) for t, n in widths.items())
    seconds = run.trace.group_seconds(MMQ_GROUPS, ~run.trace.inside("decode"))
    return 100.0 * bound / seconds if seconds else None
