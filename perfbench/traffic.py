"""The one traffic generator: a mix is a JSON file of parameters under
`perfbench/traffic/`, and this module turns it and a seed into the
`LLM.generate` calls of a run.

A call is `requests_per_call` prompts. Their lengths are the
log-uniform strata of `prompt_tokens` = [lo, hi]: the i-th of n is
lo * (hi / lo) ** ((i + 0.5) / n), rounded. The seed draws the order of
these lengths once per run, so every seed offers the same sizes and
every call of a run the same shapes (the warm-up call then meets every
decode graph the window meets), and draws each call's token ids
uniformly over the vocabulary. Every request asks for `max_new_tokens`
greedy tokens with no EOS stop, so each call does the same work.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *stream])


@dataclass(frozen=True)
class Traffic:
    name: str
    requests_per_call: int
    prompt_tokens: tuple
    max_new_tokens: int
    temperature: float

    @classmethod
    def from_file(cls, name: str, path: str) -> "Traffic":
        with open(path) as f:
            t = json.load(f)
        temperature = float(t["sampler"].get("temperature", 0.0))
        if temperature != 0.0 or set(t["sampler"]) - {"temperature"}:
            raise ValueError(f"{path}: only greedy traffic is checked "
                             "against the reference")
        return cls(name=name, requests_per_call=int(t["requests_per_call"]),
                   prompt_tokens=tuple(t["prompt_tokens"]),
                   max_new_tokens=int(t["max_new_tokens"]),
                   temperature=temperature)

    def lengths(self) -> list:
        lo, hi = self.prompt_tokens
        n = self.requests_per_call
        return [int(round(lo * (hi / lo) ** ((i + 0.5) / n)))
                for i in range(n)]

    def order(self, seed: int) -> list:
        """The run's prompt lengths in the order the seed draws."""
        lengths = self.lengths()
        return [lengths[i] for i in _rng(seed, 0).permutation(len(lengths))]

    def call(self, seed: int, index: int, vocab: int) -> list:
        """Prompts (lists of token ids) of call `index` of a run; index 0
        is the warm-up call."""
        rng = _rng(seed, 1, index)
        return [rng.integers(0, vocab, n).tolist() for n in self.order(seed)]

    def sample(self, seed: int, requests: list, count: int) -> list:
        """Indices of the `count` requests the reference checks: the
        longest (prompt and served tokens) and others drawn from the
        seed."""
        sizes = [len(p) + len(s) for p, s in requests]
        longest = int(np.argmax(sizes))
        rest = [i for i in range(len(requests)) if i != longest]
        k = min(count - 1, len(rest))
        pick = _rng(seed, 2).choice(len(rest), size=k, replace=False)
        return [longest] + sorted(rest[i] for i in pick)


def load(root: str, name: str) -> Traffic:
    return Traffic.from_file(name, os.path.join(root, "perfbench", "traffic",
                                                name + ".json"))
