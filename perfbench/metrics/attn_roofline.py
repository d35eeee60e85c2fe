"""Sum over the traced call's decode steps of the live KV rows' bytes as
stored (`roofline.attn_bound_s`) over the device time of the attention
kernels (K4 `attn_kernel`, K9 `tiled_`) inside the decode spans."""

from .. import roofline as R
from ..trace import ATTN_GROUPS


def read(run):
    if run.trace is None:
        return None
    rows = sum(int((live + 1).sum()) * steps
               + len(live) * steps * (steps - 1) // 2
               for call, steps, live in run.spans.decode
               if call == run.traced_call)
    seconds = run.trace.group_seconds(ATTN_GROUPS, run.trace.inside("decode"))
    return 100.0 * R.attn_bound_s(run.model, rows) / seconds if seconds and rows else None
