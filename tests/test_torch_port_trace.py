"""The port's span recorder (`deepchopper_tpu_torch.utils.trace`), its spans in
the fused runner, the engine, the chop worker, the DataModule and the train
step, and the benchmark's per-layer metrics that read them.

The recorder keeps nothing unless a torch.profiler session runs, and under
one stamps its spans on the clock of the profiler's events. The benchmark's
tiny cells (`benchmark/tests/conftest.py`: the registry's tiny HyenaDNA on
short reads, on the CPU) are run traced, as `benchmark/run.py --trace 1`
runs a cell: their spans must name every stage, and the stage totals of
`FusedStats` must be the sums of the spans that share their clock reads.
"""

from __future__ import annotations

import io
import json
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.spec import ROOT, metric_reader, path_module
from benchmark.harness.trace import Trace, Tracer
from benchmark.tests.conftest import tiny_cell
from deepchopper_tpu_torch.io import bgzf
from deepchopper_tpu_torch.io.bgzf import BgzfWriter
from deepchopper_tpu_torch.utils import trace

SPAN_METRICS = [m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                if m["source"] == "program_span" and "workloads" in m]  # fmt: skip
PREDICT_SPANS = ("source.index", "source.encode", "engine.prefetch_wait", "engine.dispatch", "engine.result_wait",
                 "fused.handoff", "fused.worker_wait", "chop.vote", "chop.regions", "chop.records",
                 "chop.bgzf")  # fmt: skip
# One of each a batch.
BATCH_SPANS = ("source.encode", "engine.dispatch", "engine.result_wait", "fused.handoff", "chop.vote",
               "chop.regions", "chop.records")  # fmt: skip


def _between(t0_ns: int, t1_ns: int) -> list[trace.Record]:
    return [r for r in trace.spans() if r.start_ns >= t0_ns and r.end_ns <= t1_ns]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_recorded_without_a_profiler():
    assert not trace.active()
    before = trace.spans()
    with trace.span("a", batch=1) as a, trace.span("b") as b:
        pass
    with trace.timed("c") as c:
        time.sleep(0.001)
    assert a is b  # the one shared no-op context
    assert c.seconds >= 0.001
    after = trace.spans()
    assert len(after) == len(before) and (not after or after[-1] is before[-1])


def test_spans_under_a_profiler_keep_parent_and_attrs():
    t0 = time.time_ns()

    def worker():
        with trace.span("w.outer"):
            with trace.span("w.inner", batch=7):
                pass

    with _cpu_profile():
        assert trace.active()
        with trace.span("m.outer", done=True):
            thread = threading.Thread(target=worker, name="span-worker")
            thread.start()
            thread.join(timeout=30)
            with trace.timed("m.inner", batch=3, capture=2) as inner:
                pass
    assert not thread.is_alive()
    with trace.span("after"):
        pass
    got = {r.name: r for r in _between(t0, time.time_ns())}
    assert set(got) == {"m.outer", "m.inner", "w.outer", "w.inner"}
    assert got["m.outer"].parent is None and got["m.outer"].attrs == {"done": True}
    assert got["m.inner"].parent == "m.outer" and got["m.inner"].attrs == {"batch": 3, "capture": 2}
    # A thread's spans nest within its own stack, not the spawning thread's.
    assert got["w.outer"].parent is None
    assert got["w.inner"].parent == "w.outer" and got["w.inner"].attrs == {"batch": 7}
    assert got["m.outer"].start_ns <= got["m.inner"].start_ns <= got["m.inner"].end_ns <= got["m.outer"].end_ns
    assert inner.seconds == pytest.approx((got["m.inner"].end_ns - got["m.inner"].start_ns) * 1e-9)


def test_threads_racing_to_record_lose_no_span():
    n_threads, n_spans = 16, 500
    t0 = time.time_ns()

    def worker(k):
        for i in range(n_spans):
            with trace.span(f"race.{k}"):
                with trace.span("race.inner", k=k, i=i):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=worker, args=(k,), name=f"race-{k}") for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = [r for r in _between(t0, time.time_ns()) if r.name.startswith("race.")]
    assert len(got) == 2 * n_threads * n_spans
    inner = sorted((r.attrs["k"], r.attrs["i"]) for r in got if r.name == "race.inner")
    assert inner == [(k, i) for k in range(n_threads) for i in range(n_spans)]
    for r in got:
        if r.name == "race.inner":
            assert r.parent == f"race.{r.attrs['k']}"
        else:
            assert r.parent is None


def test_a_span_holds_the_profiler_events_of_its_ops():
    a = torch.randn(256, 256)
    t0 = time.time_ns()
    with _cpu_profile() as prof:
        with trace.span("matmul"):
            torch.mm(a, a)
    rec = next(r for r in _between(t0, time.time_ns()) if r.name == "matmul")
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert rec.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= rec.end_ns


def test_bgzf_writes_are_spans_inside_their_caller(monkeypatch):
    """The deflate and write (`chop.bgzf`) run on the writer's own thread, in
    no span; the caller's wait on a full queue (`chop.bgzf_wait`) sits inside
    the caller's span, while the first batch is being written."""
    monkeypatch.setattr(bgzf, "BACKLOG_BYTES", 1)
    release = threading.Event()

    class HeldSink(io.BytesIO):
        def write(self, b):
            release.wait(timeout=30)
            return super().write(b)

    t0 = time.time_ns()
    opener = threading.Timer(0.2, release.set)
    with _cpu_profile():
        writer = BgzfWriter(HeldSink(), threads=2)
        opener.start()
        with trace.span("chop.records"):
            writer.write(b"ACGT" * (writer._batch // 2))  # two batches: the second waits for the first
        writer.close()
    opener.join(timeout=30)
    assert not opener.is_alive() and not writer._thread.is_alive()
    got = [r for r in _between(t0, time.time_ns()) if r.name.startswith("chop.bgzf")]
    assert [(r.name, r.parent) for r in got if r.name == "chop.bgzf"] == [("chop.bgzf", None)] * 2
    (wait,) = [r for r in got if r.name == "chop.bgzf_wait"]
    assert wait.parent == "chop.records" and wait.end_ns - wait.start_ns >= 0.1e9
    first = min((r for r in got if r.name == "chop.bgzf"), key=lambda r: r.start_ns)
    assert max(first.start_ns, wait.start_ns) < first.end_ns <= wait.end_ns


@pytest.fixture(scope="module")
def traced_runs():
    """The tiny fused and train cells, each set up and run for a short
    traced window as the benchmark runs them: kind -> (Run, window, spans)."""
    from benchmark.run import Run

    out = {}
    for kind in ("fused", "train"):
        cell = tiny_cell("hyena", kind)
        path = path_module(cell.path)
        tracer = Tracer(True)
        with tempfile.TemporaryDirectory(prefix="dctrace-") as tmp:
            state = path.setup(cell, 2**31 + 11, torch.device("cpu"), Path(tmp), tracer)
            win = path.window(state, 0.5, tracer)
            run = Run(cell, path.layer_inputs(cell, state, win), Trace(tracer))
        t0, t1 = tracer.window_at
        out[kind] = (run, win, _between(int(t0 * 1e9) - 1000, int(t1 * 1e9) + 1000))
    return out


def test_the_fused_pass_records_every_stage(traced_runs):
    _run, win, spans = traced_runs["fused"]
    by_name: dict[str, list[trace.Record]] = {}
    for r in spans:
        by_name.setdefault(r.name, []).append(r)
    assert set(PREDICT_SPANS) <= set(by_name)
    # The BGZF writes run on the writer's own thread; the worker's waits on
    # its full queue sit inside the record split.
    assert all(r.parent is None for n in PREDICT_SPANS for r in by_name[n])
    assert all(r.parent == "chop.records" for r in by_name.get("chop.bgzf_wait", ()))
    # Every batch the encode thread emitted goes through each stage once.
    passes = win["passes"]
    n_batches = len(by_name["source.encode"])
    assert n_batches >= len(passes)
    for name in BATCH_SPANS:
        assert len(by_name[name]) == n_batches, name
    assert len(by_name["fused.worker_wait"]) == n_batches + len(passes)  # and the end of each pass

    def seconds(*names):
        return sum((r.end_ns - r.start_ns) * 1e-9 for n in names for r in by_name[n])

    assert seconds("fused.handoff") == pytest.approx(sum(p.handoff_s for p in passes), rel=1e-9, abs=1e-9)
    assert seconds("chop.vote", "chop.regions") == pytest.approx(sum(p.smooth_s for p in passes), rel=1e-9, abs=1e-9)
    assert seconds("chop.records") == pytest.approx(sum(p.chop_write_s for p in passes), rel=1e-9, abs=1e-9)
    assert all(0 < p.handoff_s <= p.encode_s for p in passes)


def test_the_train_window_records_the_datamodule_and_the_step(traced_runs):
    _run, win, spans = traced_runs["train"]
    batches = [r for r in spans if r.name == "data.batch"]
    pads = [r for r in spans if r.name == "data.pad"]
    assert len(batches) == len(pads) == win["steps"] and all(r.parent == "data.batch" for r in pads)
    step = [r.name for r in spans if r.name.startswith("train.")]
    order = ["train.optimizer", "train.forward", "train.backward", "train.optimizer", "train.stats"]
    assert step == order * win["steps"]
    assert all(r.parent is None for r in spans if r.name.startswith(("train.", "data.batch")))


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=lambda m: m["name"])
def test_span_metrics_read_shares_of_their_own_kind(traced_runs, metric, monkeypatch):
    read = metric_reader(metric["name"])
    kind = "fused" if metric["name"].endswith(".predict") else "train"
    other = "train" if kind == "fused" else "fused"
    value = read(traced_runs[kind][0])
    if metric["name"].startswith("idle_"):
        assert value is None  # no device activity in a CPU trace
    else:
        assert value is not None and 0.0 <= value <= 100.0
    assert read(traced_runs[other][0]) is None
    assert read(SimpleNamespace(trace=None, layer=traced_runs[kind][0].layer)) is None
    # A checkout whose program has no recorder reads nothing, and raises nothing.
    import deepchopper_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "deepchopper_tpu_torch.utils.trace", None)
    assert read(traced_runs[kind][0]) is None


def test_bgzf_wait_share_reads_the_writers_queue_only_where_it_has_one(traced_runs, monkeypatch):
    """The tiny fused run never fills the writer's 64 MB queue, so the share
    reads 0; a program whose writer deflates on its caller's thread (no
    `BACKLOG_BYTES`) cannot wait on one, and reads nothing."""
    read = metric_reader("bgzf_wait_share.predict")
    run = traced_runs["fused"][0]
    assert read(run) == 0.0
    monkeypatch.delattr(bgzf, "BACKLOG_BYTES")
    assert read(run) is None


def test_idle_shares_count_only_device_idle_time_inside_the_spans(monkeypatch):
    """On a device trace laid over recorded spans: busy 0-1 s and 2-3 s of a
    4 s window; a handoff span over 0.5-2.5 s and another over 3.5-5 s (cut
    at the window's end) leave 1 s + 0.5 s idle inside them."""
    from benchmark.metrics._program_spans import idle_share

    t0 = time.time_ns()
    with _cpu_profile():
        with trace.span("fused.handoff"):
            pass
    rec = _between(t0, time.time_ns())[-1]
    base = rec.start_ns * 1e-9 - 10.0
    records = [rec._replace(start_ns=int((base + s) * 1e9), end_ns=int((base + e) * 1e9))
               for s, e in ((0.5, 2.5), (3.5, 5))]  # fmt: skip
    busy = [(base, base + 1), (base + 2, base + 3)]
    fake = SimpleNamespace(t0=base, t1=base + 4, window_s=4.0, busy=busy, busy_s=2.0)
    run = SimpleNamespace(trace=fake, layer={"kind": "predict"})
    monkeypatch.setattr(trace, "spans", lambda: records)
    assert idle_share(run, "predict", lambda n: n == "fused.handoff") == pytest.approx(100 * 1.5 / 4, abs=1e-4)
    assert idle_share(run, "predict", lambda n: n == "other") == 0.0
    fake.busy_s = 0.0
    assert idle_share(run, "predict", lambda n: n == "fused.handoff") is None
