"""Every generated token of every call in the window, over the window
(first call's start to last call's end)."""


def read(run):
    return sum(sum(c.served) for c in run.calls) / (run.window[1] - run.window[0])
