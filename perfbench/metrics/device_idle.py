"""1 - (device-busy time of the window's calls) / the window, in percent.
The busy time is the traced call's union of kernel and copy intervals,
once for each call of the window: every call of a run has the same
shapes (the same prompt lengths and output length), so the same device
work. The window is the untraced one on the host clock, so the share
holds none of the profiler's own host cost, which slows the traced
call's eager prefill 1.5-1.6x (the result's `trace_cost`)."""


def read(run):
    if run.trace is None or not run.calls:
        return None
    window = run.window[1] - run.window[0]
    return 100.0 * (1.0 - run.trace.busy_s() * len(run.calls) / window)
