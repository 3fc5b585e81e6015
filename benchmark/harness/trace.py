"""The traced run: torch.profiler over the window (device activity only),
reduced to device busy time (the union of the intervals in which a kernel
or copy ran, so that overlapping kernels count once), device time by
kernel name, and the idle gaps named by the harness's host range open when
each began.

The harness marks its own calls into each layer with `span(name)`, kept by
the tracer on the wall clock that the profiler stamps its events with (ns
since the epoch); spans cost nothing when no trace runs. Host operators
are not traced: recording and reading them doubled a traced run's time.
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from pathlib import Path

KERNELS = json.loads((Path(__file__).resolve().parents[1] / "kernels.json").read_text())


class Tracer:
    """Holds the profiler, the window and the host spans of a traced run."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.window_at: tuple[float, float] | None = None
        self.spans: list[tuple[str, float, float]] = []

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0 * 1e-9, time.time_ns() * 1e-9))

    @contextlib.contextmanager
    def window(self):
        """The measured window, traced when enabled; the caller starts its
        clock inside, once the profiler runs."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        # Without a card (the harness's own CPU tests) there is no device to trace.
        activity = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
        with profile(activities=[activity], acc_events=True) as prof:
            t0 = time.time_ns()
            yield
            self.window_at = (t0 * 1e-9, time.time_ns() * 1e-9)
        self.prof = prof


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Trace:
    """A traced window, read once: times in seconds."""

    def __init__(self, tracer: Tracer):
        from torch.autograd import DeviceType

        self.t0, self.t1 = tracer.window_at
        self.window_s = self.t1 - self.t0
        device = []
        # The profiler's raw events: building its FunctionEvent tree for a
        # window of some 10^5 kernels takes minutes.
        for e in tracer.prof.profiler.kineto_results.events():
            # A host range (torch.optim's) also shows on the device's
            # timeline as a user annotation: no device work.
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                start = e.start_ns() * 1e-9
                end = start + e.duration_ns() * 1e-9
                if end > self.t0 and start < self.t1:
                    device.append((e.name(), max(start, self.t0), min(end, self.t1)))
        self.device = device
        self.ranges = list(tracer.spans)
        self.busy = _union([(s, e) for _n, s, e in self.device])
        self.busy_s = sum(e - s for s, e in self.busy)

    def time_of(self, what: str) -> float:
        """Device seconds of the kernels of one of the port's ops
        (`kernels.json`): 0.0 when none ran."""
        pats = [re.compile(p) for p in KERNELS["ops"][what]]
        return sum(e - s for n, s, e in self.device if any(p.search(n) for p in pats))

    def own_kernel_s(self) -> tuple[float, float]:
        """(device seconds in the port's own kernels, in every kernel); copies
        and sets are not kernels."""
        pats = [re.compile(p) for ps in KERNELS["ops"].values() for p in ps]
        copy = re.compile(KERNELS["not_kernels"])
        own = total = 0.0
        for n, s, e in self.device:
            if copy.search(n):
                continue
            total += e - s
            if any(p.search(n) for p in pats):
                own += e - s
        return own, total

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The k longest stretches of the window with nothing on the device,
        each named by the innermost harness range open when it began."""
        edges = [self.t0, *[x for iv in self.busy for x in iv], self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:k]:
            open_ = [r for r in self.ranges if r[1] <= g0 < r[2]]
            name = min(open_, key=lambda r: r[2] - r[1])[0] if open_ else "no harness range"
            out.append([name, g1 - g0])
        return out
