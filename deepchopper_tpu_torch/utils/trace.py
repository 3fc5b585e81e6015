"""Spans of the port's own work, on the clock of the device trace.

`span(name, **attrs)` marks a stretch of host work: the fused runner's
encode, feed and chop threads, the DataModule, the train step. A span
records (name, name of the span open around it on the same thread, start,
end, attrs), with start and end in ns since the epoch, the clock kineto
stamps the device's kernels and copies with. So a span can be laid over a
`torch.profiler` trace, and an idle gap of the device named by the host work
that was under way. The two reads of a span are of `time.monotonic_ns()`,
moved onto the epoch by one offset taken at import: a span's length, and
the stage totals taken from it, stay on the monotonic clock.

Spans record only while a `torch.profiler` session runs (`active()`);
otherwise `span` returns one shared no-op context: no clock read, no span
object. `timed` always reads the clock, for the stage totals that a
span shares its two clock reads with (`FusedStats`), and records under the
same rule. Records go into one bounded in-memory buffer of the process
(the newest `CAPACITY` are kept), appended under the GIL from any thread;
`spans()` returns a copy.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 20
# Epoch ns less monotonic ns: where a monotonic reading falls on the epoch.
_EPOCH_OFFSET_NS = time.time_ns() - time.monotonic_ns()


class Record(NamedTuple):
    name: str
    parent: str | None  # the innermost span open on the same thread when this one began
    start_ns: int  # epoch ns
    end_ns: int
    attrs: dict


_records: collections.deque[Record] = collections.deque(maxlen=CAPACITY)
_local = threading.local()


def active() -> bool:
    """True while a torch.profiler session runs in this process."""
    return _profiler._is_profiler_enabled


def spans() -> list[Record]:
    """A copy of the recorded spans, oldest first."""
    return list(_records)


def _stack() -> list[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """A timed stretch; recorded at its end when `record`. `seconds` is its
    length once it has ended."""

    __slots__ = ("name", "attrs", "record", "parent", "t0", "t1")

    def __init__(self, name: str, attrs: dict, record: bool):
        self.name, self.attrs, self.record, self.parent = name, attrs, record, None

    def __enter__(self) -> Span:
        if self.record:
            stack = _stack()
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.monotonic_ns()
        if self.record:
            _stack().pop()
            _records.append(Record(self.name, self.parent, self.t0 + _EPOCH_OFFSET_NS, self.t1 + _EPOCH_OFFSET_NS,
                                   self.attrs))  # fmt: skip
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


class _Off:
    """The context `span` returns while no profiler runs."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """Record the with-block as `name` while a profiler runs; else do nothing."""
    return Span(name, attrs, True) if active() else _OFF


def timed(name: str, **attrs) -> Span:
    """Time the with-block (`.seconds`), and record it as `span` would."""
    return Span(name, attrs, active())
