"""100 x the prompt tokens the window's calls prefilled over the tokens
their prefill chunks computed, padding included (`generate`'s
`prefill_tokens` and `prefill_widths`, counted where each chunk runs):
the share of prefill work that was not padding. None where the program
does not count them."""


def read(run):
    real = padded = 0
    for c in run.calls:
        if "prefill_widths" not in c.stats:
            return None
        real += c.stats["prefill_tokens"]
        padded += sum(t * n for t, n in c.stats["prefill_widths"].items())
    return 100.0 * real / padded if padded else None
