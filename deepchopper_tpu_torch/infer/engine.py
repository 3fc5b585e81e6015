"""Inference engine: bucketed, planned, prefetched predict on one device.

Port of `deepchopper_tpu/infer/engine.py:PredictEngine`. Reads are bucketed
onto the 17-width ladder (`data/bucketing.py`). A batch of b rows at width w
runs as the dispatches `_plan_dispatches` plans, exactly as the JAX engine
plans its jitted executables: one dispatch when b is one of the width's row
variants {t, t/4, t/16} (`_row_variants`), else the variants that fit, largest
first, with the remainder padded up to the smallest variant (or one padded
dispatch where splitting saves no rows). On the card each (rows, width) is one
captured CUDA graph of `step` (`CapturedStep`), the counterpart of one
`jax.jit` executable: captured at its first dispatch, whose eager run is that
dispatch's own, or ahead of the stream by `warmup`, and replayed for every
dispatch after. The long filters of each width are computed once and kept
(the model's `memo`). On the CPU the same plan runs `step` eagerly. Inputs
reach the device as int8 token ids and uint8 raw phred; the per-read L2
quality norm runs on the device. Outputs are float32 logits (B, W, 2), or an
on-device int8 argmax (B, W) with `return_labels`. Shards follow the
predict -> chop contract under `output_dir/<dataloader_idx>/<rank>_<batch>.{npz,pt}`;
`predict_to_predicts` and `infer.fused` skip the shards. The JAX engine's
streaming `warmup_async` is not ported, nor its single-process `mesh=`: over
several ranks (`parallel/`) each rank runs its own engine, with its own CUDA
graphs on its own card, on its interleaved slice of the reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue
import threading
import time
from collections.abc import Iterator
from pathlib import Path

import numpy as np
import torch

from .. import default
from ..data.bucketing import Batch, default_buckets
from ..data.fastq_module import iter_batches
from ..device import resolve_device
from ..io.predicts import Predict, write_prediction_shard, write_prediction_shard_pt
from ..ops import _build
from ..ops.sequence import detokenize_bases
from ..parallel.mesh import process_shard_info

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PredictStats:
    reads: int = 0
    batches: int = 0
    tokens: int = 0  # true token count (sum of read lengths incl. SEP)
    padded_tokens: int = 0  # tokens the device computed: rows x width of every dispatch
    elapsed_s: float = 0.0  # the stream, lazy captures included; runtime_setup and warmup are not in it
    compile_s: float = 0.0  # capturing CUDA graphs (their eager runs not included), lazy or in warmup
    setup_s: float = 0.0  # runtime_setup: build, load and the first launch
    build_s: float = 0.0  # the part of setup_s spent building kernel libraries
    captures: int = 0  # CUDA graphs captured, each right after an eager run of `step` at its shape
    warm_runs: int = 0  # those eager runs that were no dispatch's own (warmup's, on padding)
    # dispatches per padded (rows, width) shape
    shape_counts: dict = dataclasses.field(default_factory=dict)

    @property
    def dispatches(self) -> int:
        return sum(self.shape_counts.values())

    @property
    def reads_per_s(self) -> float:
        return self.reads / max(self.elapsed_s, 1e-9)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.elapsed_s, 1e-9)


def _prefetch_iter(it: Iterator, depth: int) -> Iterator:
    """Pull `it` on a daemon thread, `depth` items ahead.

    Exceptions from the producer re-raise at the consumer's next pull; the
    producer blocks when the consumer falls `depth` behind. If the consumer
    abandons the generator early, a stop flag unblocks the producer.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run() -> None:
        try:
            for item in it:
                if not _put(item):
                    return
            _put(end)
        except BaseException as exc:  # noqa: BLE001 - re-raised at the consumer
            _put(exc)
        finally:
            close = getattr(it, "close", None)
            if stop.is_set() and close is not None:
                close()

    threading.Thread(target=_run, name="batch-prefetch", daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class CapturedStep:
    """`PredictEngine.step` at one (rows, width) as a CUDA graph: static int8
    ids and uint8 quals the graph reads, the static output it writes, and
    the launches of one run of the step.

    Made from a first batch of that shape: the batch becomes the static
    inputs and runs eagerly on the current stream, which is that batch's own
    dispatch (`first`) and fills what must not be filled during a capture
    (the twiddle tables `ops.mixer` builds on the host and copies over, the
    width's long filters, cuFFT plans, library handles). `step` is then
    captured on `stream`; the capture launches nothing. The op wrappers count
    their launches in Python, so they count at the capture and would never
    count at a replay: the capture's counts are taken back and added again
    at every replay. A failed capture raises."""

    def __init__(self, step, ids: np.ndarray, quals: np.ndarray, device: torch.device, pool,
                 stream: torch.cuda.Stream):  # fmt: skip
        self.ids = torch.from_numpy(ids).to(device)
        self.quals = torch.from_numpy(quals).to(device)
        self.first: torch.Tensor | None = step(self.ids, self.quals)
        t0 = time.monotonic()
        before = [dict(c) for c in _build.COUNTERS]
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self.graph = torch.cuda.CUDAGraph()
            try:
                # thread_local: a CUDA call that another thread makes meanwhile
                # (the fused runner's, a caller's) does not void the capture.
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.out = step(self.ids, self.quals)
                except BaseException:
                    with contextlib.suppress(RuntimeError):  # end the broken capture, then raise its cause
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
            finally:
                self.counted = [(c, k, c[k] - b[k]) for c, b in zip(_build.COUNTERS, before) for k in b if c[k] != b[k]]
                for c, b in zip(_build.COUNTERS, before):
                    c.update(b)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.capture_s = time.monotonic() - t0

    def __call__(self, ids: np.ndarray, quals: np.ndarray) -> torch.Tensor:
        """Copy a (rows, width) batch into the static inputs and replay on
        the current stream; returns the static output (overwritten by the
        next replay: copy it out first)."""
        self.ids.copy_(torch.from_numpy(ids), non_blocking=True)
        self.quals.copy_(torch.from_numpy(quals), non_blocking=True)
        self.replay()
        return self.out

    def replay(self) -> None:
        """Replay on whatever the static inputs hold."""
        self.graph.replay()
        for counts, name, n in self.counted:
            counts[name] += n


def _pad_rows(a: np.ndarray, rows: int, fill: int) -> np.ndarray:
    out = np.full((rows, *a.shape[1:]), fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


class PredictEngine:
    def __init__(
        self,
        model: torch.nn.Module,
        max_length: int = 32768,
        tokens_per_batch: int = 1 << 17,
        buckets: list[int] | None = None,
        max_batch: int = 512,
        return_labels: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_length = max_length
        self.tokens_per_batch = tokens_per_batch
        self.buckets = buckets or default_buckets(max_length)
        self.max_batch = max_batch
        self.return_labels = return_labels
        self.stats = PredictStats()
        # Work of the model that depends on the width alone (its long
        # filters), kept for the engine's life: the graphs read it.
        self._memo: dict = {}
        # CUDA graphs by (rows, width, model.graph_key(width)); they share one
        # memory pool (a new one after a failed capture) and replay one at a
        # time on one stream, each output copied out before the next replay.
        self._graphs: dict[tuple, CapturedStep] = {}
        self._pool = None
        self._capture_stream: torch.cuda.Stream | None = None
        # Held over a capture and over each copy-in, replay and copy-out.
        self._lock = threading.Lock()

    def runtime_setup(self) -> float:
        """Take the one-time kernel setup off the timed stream; returns its
        seconds, also kept as `stats.setup_s`.

        Builds every CUDA source of `ops/_build.SOURCES` (all nvcc processes
        started together), loads each library, launches the setup kernel
        (`ops/setup.py`, x + 1 on one (8, 128) tile) once, synchronises and
        checks its output exactly. Runs once per engine: 0.0 on repeat calls
        and on the CPU. A failed build or launch raises."""
        if self.stats.setup_s or self.device.type != "cuda":
            return 0.0
        from ..ops import _build, setup

        t0 = time.monotonic()
        _build.build_all()
        t_built = time.monotonic()
        for source in _build.SOURCES:
            _build.load(source)
        x = torch.zeros(setup.SHAPE, dtype=torch.float32, device=self.device)
        out = setup.setup_tile(x)
        torch.cuda.synchronize(self.device)
        if not torch.equal(out.cpu(), torch.ones(setup.SHAPE)):
            raise RuntimeError("runtime_setup: the setup kernel's output is not x + 1")
        self.stats.build_s = t_built - t0
        self.stats.setup_s = time.monotonic() - t0
        log.info("runtime setup in %.3fs (build %.3fs)", self.stats.setup_s, self.stats.build_s)
        return self.stats.setup_s

    def warmup(self, buckets: list[int] | None = None, variants: bool = True) -> float:
        """Capture every (rows, width) of `buckets` (default: the ladder),
        each row variant or only the full batch, ahead of the stream, each
        after an eager run on padding; returns the wall seconds,
        `runtime_setup` included. Captures nothing on the CPU. Without it each
        shape is captured at its first dispatch."""
        shapes = []
        for w in buckets or self.buckets:
            rows = self._row_variants(w) if variants else [self._bucket_batch_size(w)]
            shapes.extend((r, w) for r in rows)
        t0 = time.monotonic()
        self.runtime_setup()
        for shape in dict.fromkeys(shapes):
            self._get_step(shape)
        return time.monotonic() - t0

    # -- the plan -------------------------------------------------------------

    def _bucket_batch_size(self, width: int) -> int:
        return max(1, min(self.max_batch, self.tokens_per_batch // width))

    def _row_variants(self, width: int) -> list[int]:
        """Row counts dispatched at `width`: the full batch t plus t/4 and
        t/16, as the JAX engine compiles them (`DEEPCHOPPER_ROW_VARIANTS`
        overrides the divisors, e.g. "2,4,8,16")."""
        t = self._bucket_batch_size(width)
        divs = tuple(int(x) for x in os.environ.get("DEEPCHOPPER_ROW_VARIANTS", "4,16").split(",") if x)
        return sorted({t, *(max(1, t // div) for div in divs)})

    def _plan_dispatches(self, b: int, w: int) -> list[tuple[int, int, int]]:
        """Split a b-row batch into (row_start, rows_valid, dispatched_rows)
        parts, as the JAX engine does: a batch of a variant's size is one
        dispatch; a smaller one decomposes greedily into the largest variants
        that fit, the remainder padded up to the smallest variant, unless
        that dispatches no fewer rows than one padded dispatch of the
        smallest variant that holds b; a batch above every variant (a foreign
        producer's) is one dispatch of its own size."""
        variants = self._row_variants(w)
        target_b = next((v for v in variants if v >= b), None)
        if target_b is None or target_b == b:
            return [(0, b, b)]
        plan: list[tuple[int, int, int]] = []
        start = 0
        rem = b
        for v in reversed(variants):
            while rem >= v:
                plan.append((start, v, v))
                start += v
                rem -= v
        if rem:
            plan.append((start, rem, variants[0]))
        if sum(p[2] for p in plan) >= target_b:
            return [(0, b, target_b)]
        return plan

    # -- the step and its graphs ---------------------------------------------

    @torch.inference_mode()
    def step(self, ids_i8: torch.Tensor, quals_u8: torch.Tensor) -> torch.Tensor:
        """One device batch: int8 ids, uint8 phred (B, W) on the device ->
        float32 logits (B, W, 2) or int8 labels (B, W), on the device."""
        ids = ids_i8.long()
        q = quals_u8.float()
        norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
        q = q / torch.clamp(norm, min=1e-12)
        logits = self.model(ids, q, memo=self._memo)
        if self.return_labels:
            return torch.argmax(logits, dim=-1).to(torch.int8)
        return logits.float()

    def _eager(self, ids: np.ndarray, quals: np.ndarray) -> torch.Tensor:
        return self.step(torch.from_numpy(ids).to(self.device), torch.from_numpy(quals).to(self.device))

    def _graph_key(self, shape: tuple[int, int]) -> tuple:
        return (*shape, self.model.graph_key(shape[1]))

    def _capture(self, key: tuple, ids: np.ndarray, quals: np.ndarray) -> CapturedStep:
        """Run `step` eagerly on a (rows, width) batch and capture it there;
        the seconds of the capture go to stats.compile_s."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            graph = CapturedStep(self.step, ids, quals, self.device, self._pool, self._capture_stream)
        except BaseException:
            # A failed capture releases the pool it began in: the next
            # capture starts a new one (graphs captured before keep theirs).
            self._pool = None
            raise
        self._graphs[key] = graph
        self.stats.captures += 1
        self.stats.compile_s += graph.capture_s
        log.info("captured %s in %.3fs", key, graph.capture_s)
        return graph

    def _run(self, shape: tuple[int, int], ids: np.ndarray, quals: np.ndarray) -> torch.Tensor:
        """One (rows, width) dispatch, (ids, quals) numpy -> output on the
        device: on the card a replay of the shape's CUDA graph or, at its
        first dispatch, the eager run its capture starts from; on the CPU
        the eager step. Called under the engine's lock."""
        if self.device.type != "cuda":
            return self._eager(ids, quals)
        key = self._graph_key(shape)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph(ids, quals)
        graph = self._capture(key, ids, quals)
        out, graph.first = graph.first, None
        return out

    def _get_step(self, shape: tuple[int, int]):
        """The callable that runs one (rows, width) dispatch, (ids, quals)
        numpy -> output on the device: on the card the shape's CUDA graph,
        captured here (after an eager run on padding, a warm run) if it is
        not yet; on the CPU the eager step."""
        if self.device.type != "cuda":
            return self._eager
        key = self._graph_key(shape)
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                pad = np.full(shape, default.TOKEN_PAD, dtype=np.int8)
                graph = self._capture(key, pad, np.zeros(shape, dtype=np.uint8))
                graph.first = None
                self.stats.warm_runs += 1
            return graph

    def _to_host(self, out: torch.Tensor) -> torch.Tensor:
        """Enqueue the copy of a device output to pinned host memory."""
        if self.device.type != "cuda":
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host

    # -- prediction -----------------------------------------------------------

    def _dispatch(self, batch: Batch) -> tuple[Batch, list, torch.cuda.Event | None]:
        """Enqueue one batch's dispatches and the copies of their results to
        pinned host memory."""
        if batch.quals_raw is None:
            raise ValueError("engine requires batches with quals_raw (see pad_batch)")
        b, w = batch.input_ids.shape
        ids8 = batch.input_ids.astype(np.int8, copy=False)  # vocab ids < 128
        parts = []
        for start, rows, target_b in self._plan_dispatches(b, w):
            ids_in, quals_in = ids8[start : start + rows], batch.quals_raw[start : start + rows]
            if rows < target_b:
                ids_in, quals_in = _pad_rows(ids_in, target_b, default.TOKEN_PAD), _pad_rows(quals_in, target_b, 0)
            with self._lock:
                out = self._run((target_b, w), ids_in, quals_in)
                parts.append(self._to_host(out[:rows]))
            self.stats.shape_counts[(target_b, w)] = self.stats.shape_counts.get((target_b, w), 0) + 1
            self.stats.padded_tokens += target_b * w
        if self.device.type != "cuda":
            return batch, parts, None
        done = torch.cuda.Event()
        done.record()
        return batch, parts, done

    def predict_batches(self, batches: Iterator[Batch], prefetch: int = 3) -> Iterator[tuple[Batch, np.ndarray]]:
        """Yield (batch, outputs): (B, W, 2) float32 logits, or (B, W) int8
        labels with `return_labels`.

        The input iterator (host encode) is pulled `prefetch` batches ahead
        on a background thread, and batch i+1 is enqueued on the device
        before batch i's result is handed to the caller, so the caller's
        shard write overlaps device work."""
        if prefetch:
            batches = _prefetch_iter(batches, prefetch)
        t_start = time.monotonic()
        pending = None
        try:
            for batch in batches:
                nxt = self._dispatch(batch)
                if pending is not None:
                    yield self._collect(*pending)
                pending = nxt
            if pending is not None:
                yield self._collect(*pending)
        finally:
            self.stats.elapsed_s += time.monotonic() - t_start

    def _collect(self, batch: Batch, parts: list, done: torch.cuda.Event | None) -> tuple[Batch, np.ndarray]:
        """Wait for a batch's copies and join its parts' rows, in order, as
        `_unpack` of the JAX engine does."""
        if done is not None:
            done.synchronize()
        self.stats.batches += 1
        self.stats.reads += len(batch.input_ids)
        self.stats.tokens += int(batch.lengths.sum())
        outs = [host.numpy() for host in parts]
        return batch, outs[0] if len(outs) == 1 else np.concatenate(outs)

    def predict_file(
        self,
        fq_path: str | Path,
        output_dir: str | Path,
        rank: int | None = None,
        dataloader_idx: int = 0,
        max_samples: int | None = None,
        limit_batches: int | None = None,
        shard: tuple[int, int] | None = None,
        shard_format: str = "npz",
    ) -> PredictStats:
        """Predict a FASTQ and write prediction shards: `shard_format` "npz",
        or "pt" (the reference's torch format, which its `deepchopper-chop`
        reads).

        Over several ranks, `rank` defaults to this process's rank and
        `shard` to (rank, world size) (`parallel.process_shard_info`): each
        rank reads its interleaved slice of the FASTQ and writes
        `{rank}_{batch}` shards, which the chop stage merges."""
        if shard_format not in ("npz", "pt"):
            raise ValueError(f"shard_format must be 'npz' or 'pt', got {shard_format!r}")
        write_shard = write_prediction_shard_pt if shard_format == "pt" else write_prediction_shard
        this_rank, world = process_shard_info()
        if rank is None:
            rank = this_rank
        if shard is None and world > 1:
            shard = (this_rank, world)
        out = Path(output_dir) / str(dataloader_idx)
        out.mkdir(parents=True, exist_ok=True)
        for i, (batch, outputs) in enumerate(self.predict_batches(self._batches(fq_path, max_samples, shard))):
            if limit_batches is not None and i >= limit_batches:
                break
            write_shard(
                out / f"{rank}_{i}.{shard_format}",
                prediction=outputs,
                target=batch.labels,
                seq=batch.input_ids,
                qual=batch.quals,
                ids=batch.ids,
            )
        log.info("predict: %d reads, %d batches, %.0f reads/s", self.stats.reads, self.stats.batches, self.stats.reads_per_s)
        return self.stats

    def _batches(self, fq_path: str | Path, max_samples: int | None,
                 shard: tuple[int, int] | None = None) -> Iterator[Batch]:  # fmt: skip
        return iter_batches(
            fq_path,
            max_length=self.max_length,
            tokens_per_batch=self.tokens_per_batch,
            buckets=self.buckets,
            max_samples=max_samples,
            max_batch=self.max_batch,
            shard=shard,
        )

    def predict_to_predicts(self, fq_path: str | Path, max_samples: int | None = None,
                            shard: tuple[int, int] | None = None) -> dict[str, Predict]:  # fmt: skip
        """FASTQ -> per-read `Predict`s (on-device argmax, no shard IO), for
        `chop.pipeline.stream_chop_with_predicts`; `shard=(rank, count)`
        predicts that rank's interleaved slice of the reads."""
        if not self.return_labels:
            raise ValueError("construct PredictEngine(return_labels=True) for the fused path")
        out: dict[str, Predict] = {}
        for batch, labels in self.predict_batches(self._batches(fq_path, max_samples, shard)):
            for i, rid in enumerate(batch.read_ids):
                n = int(batch.lengths[i]) - 1  # strip SEP
                seq = batch.seqs[i][:n] if batch.seqs is not None else detokenize_bases(batch.input_ids[i, :n])
                out[rid] = Predict(prediction=labels[i, :n].astype(np.int8), seq=seq, id=rid,
                                   is_truncated=bool(batch.ids[i, 1]))  # fmt: skip
        return out
