"""Host-device syncs inside the window's prefills (`generate`'s
`prefill_syncs`: each chunk's host copies and per-layer cache writes'
reads of the positions, each first token's read) per 1000 prompt tokens.
None where the program does not count them."""


def read(run):
    syncs = tokens = 0
    for c in run.calls:
        if "prefill_syncs" not in c.stats:
            return None
        syncs += c.stats["prefill_syncs"]
        tokens += c.stats["prefill_tokens"]
    return 1e3 * syncs / tokens if tokens else None
