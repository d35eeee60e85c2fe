"""Sum over the traced call's decode steps of the least time of its
quantized matrix products (`roofline.mmq_bound_s` at the step's live
slots), over the device time of the MMQ groups (split-K sums and bf16
casts included) inside the decode spans."""

from .. import roofline as R
from ..trace import MMQ_GROUPS


def read(run):
    if run.trace is None:
        return None
    bound = sum(steps * R.mmq_bound_s(run.model, len(live))
                for call, steps, live in run.spans.decode
                if call == run.traced_call)
    seconds = run.trace.group_seconds(MMQ_GROUPS, run.trace.inside("decode"))
    return 100.0 * bound / seconds if seconds and bound else None
