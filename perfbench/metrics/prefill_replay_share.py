"""100 x the window's prefill chunks that replayed a CUDA graph an
earlier chunk captured (`generate`'s `prefill_replays`) over all its
prefill chunks (the chunk counts of `prefill_widths`): below 100 where
the window captures. None where the program does not count either."""


def read(run):
    replays = chunks = 0
    for c in run.calls:
        if "prefill_replays" not in c.stats or "prefill_widths" not in c.stats:
            return None
        replays += c.stats["prefill_replays"]
        chunks += sum(c.stats["prefill_widths"].values())
    return 100.0 * replays / chunks if chunks else None
