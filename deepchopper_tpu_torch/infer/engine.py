"""Inference engine: bucketed, prefetched predict on one device.

Port of `deepchopper_tpu/infer/engine.py:PredictEngine`. Reads are bucketed
onto the 17-width ladder (`data/bucketing.py`); each batch runs at its own
row count (eager PyTorch compiles nothing, so there is no executable cache
and no row-variant plan: `runtime_setup` is the whole warm-up). Inputs reach
the device as int8 token ids and uint8 raw phred; the per-read L2 quality
norm runs on the device. Outputs are float32 logits (B, W, 2), or an
on-device int8 argmax (B, W) with `return_labels`. Shards follow the predict
-> chop contract under `output_dir/<dataloader_idx>/<rank>_<batch>.{npz,pt}`;
`predict_to_predicts` and `infer.fused` skip the shards.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections.abc import Iterator
from pathlib import Path

import numpy as np
import torch

from ..data.bucketing import Batch, default_buckets
from ..data.fastq_module import iter_batches
from ..device import resolve_device
from ..io.predicts import Predict, write_prediction_shard, write_prediction_shard_pt
from ..ops.sequence import detokenize_bases

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PredictStats:
    reads: int = 0
    batches: int = 0
    tokens: int = 0  # true token count (sum of read lengths incl. SEP)
    padded_tokens: int = 0  # tokens the device computed (B * W per batch)
    elapsed_s: float = 0.0  # the stream only: runtime_setup is not in it
    setup_s: float = 0.0  # runtime_setup: build, load and the first launch
    build_s: float = 0.0  # the part of setup_s spent building kernel libraries

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

    @torch.inference_mode()
    def step(self, ids_i8: torch.Tensor, quals_u8: torch.Tensor) -> torch.Tensor:
        """One device batch: int8 ids, uint8 phred (B, W) on the device ->
        float32 logits (B, W, 2) or int8 labels (B, W), on the device."""
        ids = ids_i8.long()
        q = quals_u8.float()
        norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
        q = q / torch.clamp(norm, min=1e-12)
        logits = self.model(ids, q)
        if self.return_labels:
            return torch.argmax(logits, dim=-1).to(torch.int8)
        return logits.float()

    def _dispatch(self, batch: Batch) -> tuple[Batch, torch.Tensor, torch.cuda.Event | None]:
        """Enqueue one batch and the copy of its result to pinned host memory."""
        if batch.quals_raw is None:
            raise ValueError("engine requires batches with quals_raw (see pad_batch)")
        ids = torch.from_numpy(batch.input_ids.astype(np.int8, copy=False))  # vocab ids < 128
        quals = torch.from_numpy(batch.quals_raw)
        out = self.step(ids.to(self.device), quals.to(self.device))
        if self.device.type != "cuda":
            return batch, out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return batch, host, done

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

    def _collect(self, batch: Batch, out: torch.Tensor, done: torch.cuda.Event | None) -> tuple[Batch, np.ndarray]:
        if done is not None:
            done.synchronize()
        b, w = batch.input_ids.shape
        self.stats.batches += 1
        self.stats.reads += b
        self.stats.tokens += int(batch.lengths.sum())
        self.stats.padded_tokens += b * w
        return batch, out.numpy()

    def predict_file(
        self,
        fq_path: str | Path,
        output_dir: str | Path,
        rank: int = 0,
        dataloader_idx: int = 0,
        max_samples: int | None = None,
        limit_batches: int | None = None,
        shard_format: str = "npz",
    ) -> PredictStats:
        """Predict a FASTQ and write prediction shards: `shard_format` "npz",
        or "pt" (the reference's torch format, which its `deepchopper-chop`
        reads)."""
        if shard_format not in ("npz", "pt"):
            raise ValueError(f"shard_format must be 'npz' or 'pt', got {shard_format!r}")
        write_shard = write_prediction_shard_pt if shard_format == "pt" else write_prediction_shard
        out = Path(output_dir) / str(dataloader_idx)
        out.mkdir(parents=True, exist_ok=True)
        for i, (batch, outputs) in enumerate(self.predict_batches(self._batches(fq_path, max_samples))):
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

    def _batches(self, fq_path: str | Path, max_samples: int | None) -> Iterator[Batch]:
        return iter_batches(
            fq_path,
            max_length=self.max_length,
            tokens_per_batch=self.tokens_per_batch,
            buckets=self.buckets,
            max_samples=max_samples,
            max_batch=self.max_batch,
        )

    def predict_to_predicts(self, fq_path: str | Path, max_samples: int | None = None) -> dict[str, Predict]:
        """FASTQ -> per-read `Predict`s (on-device argmax, no shard IO), for
        `chop.pipeline.stream_chop_with_predicts`."""
        if not self.return_labels:
            raise ValueError("construct PredictEngine(return_labels=True) for the fused path")
        out: dict[str, Predict] = {}
        for batch, labels in self.predict_batches(self._batches(fq_path, max_samples)):
            for i, rid in enumerate(batch.read_ids):
                n = int(batch.lengths[i]) - 1  # strip SEP
                seq = batch.seqs[i][:n] if batch.seqs is not None else detokenize_bases(batch.input_ids[i, :n])
                out[rid] = Predict(prediction=labels[i, :n].astype(np.int8), seq=seq, id=rid,
                                   is_truncated=bool(batch.ids[i, 1]))  # fmt: skip
        return out
