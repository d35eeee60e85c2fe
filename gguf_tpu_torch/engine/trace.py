"""The engine's spans: an in-memory tracer that each `LLM` owns as
`llm.tracer`, off by default.

While `enabled`, a `generate` call records a span at each layer boundary
(admission sweeps, each request's prefill and its chunks, each decode
chunk and its copy, capture, replay and read, the host's emit and flush;
README.md lists them). A span holds its name, its start and end on
`time.perf_counter_ns()`, its id, the id of the open span that encloses
it, and the attributes a reader of the spans needs (a prefill chunk's
padded width, a capture's key). The `prefill` and `decode_chunk` spans
start and end on the same clock reads that `generate`'s `prefill_s` and
`decode_s` sum, so their durations add up to those stats exactly.
`drain()` hands the spans over and forgets them.

Off, `span()` returns one shared no-op context: no clock is read and
nothing is kept. There is no exporter, no thread and no global tracer.
No span is opened inside code a CUDA graph captures: a capture keeps
what it recorded, and a replay runs none of it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None        # the span open around it when it opened
    attrs: dict


class _Open:
    """An open span: it closes when its `with` block ends, at the clock
    read given to `end()` if one was, else at a read taken then."""
    __slots__ = ("_tracer", "span", "_end")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer, self.span, self._end = tracer, span, None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer._close(self.span, self._end)
        return False

    def end(self, end_ns: int) -> None:
        self._end = end_ns


class _Off:
    """What `span()` returns while the tracer is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, end_ns: int) -> None:
        pass


_OFF = _Off()


class Tracer:
    def __init__(self):
        self.enabled = False
        self._spans: list = []
        self._open: list = []         # open spans, innermost last
        self._next_id = 0

    def span(self, name: str, start_ns: int | None = None, **attrs):
        """A context: the span from `start_ns` (a clock read the caller
        took) or from now, to the end of the `with` block."""
        if not self.enabled:
            return _OFF
        sp = Span(name, time.perf_counter_ns() if start_ns is None
                  else start_ns, 0, self._next_id,
                  self._open[-1].id if self._open else None, attrs)
        self._next_id += 1
        self._open.append(sp)
        return _Open(self, sp)

    def drain(self) -> list:
        """The spans recorded since the last drain, in the order they
        closed (children before their parent)."""
        out, self._spans = self._spans, []
        return out

    def _close(self, sp: Span, end_ns: int | None) -> None:
        sp.end_ns = time.perf_counter_ns() if end_ns is None else end_ns
        # spans an exception left open inside it are dropped
        while self._open:
            if self._open.pop() is sp:
                break
        self._spans.append(sp)
