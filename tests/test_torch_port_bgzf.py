"""The port's BGZF writer, which deflates on a thread of its own behind a
queue of at most `BACKLOG_BYTES` of payload.

Its stream is the one `native.bgzf_compress` gives over the whole payload,
EOF block after, whatever the thread count, the writes' sizes and the
native library's presence; the queue never holds more than its bound (or
one batch, where a batch is larger); an error of the sink surfaces on the
caller's thread, and no exit leaves the compressor thread behind. Each
test runs under its own time limit, so a hang fails it at once.
"""

from __future__ import annotations

import gzip
import io
import threading
import time

import numpy as np
import pytest

from deepchopper_tpu_torch import native
from deepchopper_tpu_torch.io import bgzf
from deepchopper_tpu_torch.io.bgzf import BGZF_EOF, MAX_BLOCK_SIZE, BgzfWriter, open_bgzf_reader

LIMIT_S = 30.0
# The lowered bound of the queue: 2.5 of the batches a one-thread writer
# queues (8 blocks), under one batch of a four-thread writer (32 blocks).
SMALL_BACKLOG = 20 * MAX_BLOCK_SIZE


def _within(fn, seconds: float = LIMIT_S):
    """Run `fn` on a thread and fail if it has not returned within `seconds`;
    returns what it returned, and raises what it raised."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 - raised again on the test's thread
            out["error"] = exc

    thread = threading.Thread(target=run, name="bgzf-test", daemon=True)
    thread.start()
    thread.join(seconds)
    assert not thread.is_alive(), f"still running after {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _payload(n: int, seed: int = 5) -> bytes:
    """Read-like bytes, as compressible as bases are, and no whole number of blocks."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    seq[rng.integers(0, n, n // 60)] = ord("\n")
    return seq.tobytes()


class Sink(io.BytesIO):
    """Keeps what was written after it is closed; records the writer's queued
    payload at each write, and waits `delay_s` in each."""

    def __init__(self, delay_s: float = 0.0):
        super().__init__()
        self.delay_s = delay_s
        self.writer: BgzfWriter | None = None
        self.held: list[int] = []
        self.data = b""

    def write(self, b) -> int:
        if self.writer is not None:
            self.held.append(self.writer._held)
        time.sleep(self.delay_s)
        return super().write(b)

    def close(self) -> None:
        if not self.closed:
            self.data = self.getvalue()
        super().close()


class FailingSink(io.BytesIO):
    def write(self, b) -> int:
        raise OSError("no space left on the sink")


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("writes", ["one_large", "many_small", "empty"])
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_the_stream_is_one_deflate_of_the_payload(threads, writes, path, tmp_path, monkeypatch):
    if not native.available():
        pytest.skip("the native host ops are unavailable: nothing to compare the stream with")
    payload = b"" if writes == "empty" else _payload(34 * MAX_BLOCK_SIZE + 12345)
    want = native.bgzf_compress(payload, 6, 2) + BGZF_EOF
    monkeypatch.setattr(bgzf, "BACKLOG_BYTES", SMALL_BACKLOG)
    sink = Sink(delay_s=0.005)  # the caller queues its next batch while one is written

    def write():
        with monkeypatch.context() as m:
            if path == "python":
                m.setattr(native, "get_lib", lambda: None)
            writer = sink.writer = BgzfWriter(sink, threads=threads)
            assert writer._native == (path == "native")
            if writes == "one_large":
                writer.write(payload)
            else:
                sizes = np.random.default_rng(threads).integers(1, 9000, len(payload) // 1000 + 1)
                cuts = np.minimum(np.concatenate([[0], np.cumsum(sizes)]), len(payload))
                for a, b in zip(cuts[:-1], cuts[1:]):
                    writer.write(payload[a:b])
            writer.close()
            return writer

    writer = _within(write)
    assert writer._thread is None or not writer._thread.is_alive()
    assert sink.data == want
    # The queue held more than one batch where the bound let it, and never more than the bound.
    assert max(sink.held, default=0) <= max(SMALL_BACKLOG, writer._batch)
    if writes != "empty" and threads == 1:
        assert max(sink.held) > writer._batch
    assert gzip.decompress(sink.data) == payload
    (tmp_path / "out.gz").write_bytes(sink.data)
    with open_bgzf_reader(tmp_path / "out.gz", threads=2) as fh:
        assert fh.read() == payload


@pytest.mark.parametrize("where", ["write", "close"])
def test_a_sink_error_surfaces_on_the_callers_thread(where, monkeypatch):
    """With the queue's bound at one block, every batch after the first waits
    for the compressor, so its failure reaches a `write`; a payload under one
    batch is deflated only at `close`."""
    monkeypatch.setattr(bgzf, "BACKLOG_BYTES", MAX_BLOCK_SIZE)
    payload = _payload(MAX_BLOCK_SIZE * 100 if where == "write" else 1000)

    def run():
        writer = BgzfWriter(FailingSink(), threads=2)
        raised_in = None
        try:
            for i in range(0, len(payload), 100000):
                writer.write(payload[i : i + 100000])
        except OSError:
            raised_in = "write"
        try:
            writer.close()
        except OSError:
            raised_in = raised_in or "close"
        return writer, raised_in

    writer, raised_in = _within(run)
    assert raised_in == where
    assert writer.closed and not writer._thread.is_alive()


def test_an_error_in_the_callers_block_leaves_no_thread_behind():
    """The caller raises while the compressor is still deflating what it
    queued: closing waits for it, writes every block and the EOF, and
    returns; the compressor thread has ended."""
    sink = Sink(delay_s=0.2)
    payload = _payload(40 * MAX_BLOCK_SIZE)

    def run():
        raw = BgzfWriter(sink, threads=2)
        with pytest.raises(KeyError, match="caller failed"):
            with io.BufferedWriter(raw, buffer_size=MAX_BLOCK_SIZE) as fh:
                fh.write(payload)
                assert raw._thread.is_alive()
                raise KeyError("caller failed")
        return raw

    raw = _within(run)
    assert raw.closed and not raw._thread.is_alive()
    assert gzip.decompress(sink.data) == payload and sink.data.endswith(BGZF_EOF)

