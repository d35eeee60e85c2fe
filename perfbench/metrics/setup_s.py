"""Process start to the first timed call: interpreter and imports, kernel
builds, the checkpoint, `LLM` and the warm-up call."""


def read(run):
    return run.setup_s
