"""`predict --fused-chop`, as the CLI runs it: one `PredictEngine(
return_labels=True)` with its kernels set up (`runtime_setup`), and
`infer.fused.fused_predict_chop` over a FASTQ, chopped BGZF out.

Set-up makes the weights (the head's class bias set so that the chop cuts
the mix's share of reads, `harness/calibrate.py`) and the pass's reads,
builds and loads the kernels, captures the engine's graphs at the row variants of every width
the reads reach (`warmup`) and runs one small pass (host plane, threads,
pinned buffers). The window repeats passes over the same file until
`--seconds` have passed; it ends with the last pass. A tap on the engine's
`predict_batches` keeps the labels the program gave a sample of reads, in
every pass. Once the window has closed, each pass's output is read back
and deleted, and the reference judges the sample; the share of reads the
chop cut and of sampled bases labelled adapter are printed as readings.
"""

from __future__ import annotations

import math
import shutil
import time
from pathlib import Path

import numpy as np

from benchmark.harness.traffic import length_set, make_reads, widths_reached
from benchmark.reference import judge


class LabelTap:
    """Wraps an engine's `predict_batches` and keeps the labels of the
    sampled reads (by name), one dict a pass. Passes the batches on as they
    are. With a tracer, marks the feed thread's wait on the engine and the
    encode thread's pull."""

    def __init__(self, engine, wanted: dict[bytes, int], tracer):
        self.inner = engine.predict_batches
        self.wanted = wanted
        self.tracer = tracer
        self.passes: list[dict[int, tuple[int, np.ndarray]]] = []

    def _encode(self, batches):
        it = iter(batches)
        while True:
            with self.tracer.span("bench.encode"):
                batch = next(it, None)
            if batch is None:
                return
            yield batch

    def __call__(self, batches, prefetch: int = 3):
        got: dict[int, tuple[int, np.ndarray]] = {}
        self.passes.append(got)
        it = self.inner(self._encode(batches), prefetch)
        while True:
            with self.tracer.span("bench.engine_wait"):
                item = next(it, None)
            if item is None:
                return
            batch, labels = item
            width = labels.shape[1]
            for row, (chunk, span_row) in enumerate(batch.refs):
                off, n = chunk.spans[span_row, 0], chunk.spans[span_row, 1]
                idx = self.wanted.get(chunk.buf[off : off + n].tobytes())
                if idx is not None:
                    got[idx] = (width, labels[row, : int(batch.lengths[row]) - 1].copy())
            with self.tracer.span("bench.chop_handoff"):
                yield batch, labels


def _sample(lengths: np.ndarray, seed: int, budget: int) -> list[int]:
    """Read indices drawn from the seed up to `budget` bases, the longest read first."""
    rng = np.random.default_rng([seed, 9])
    picked, total = [int(np.argmax(lengths))], int(lengths.max())
    for i in rng.permutation(len(lengths)):
        if total >= budget:
            break
        if i != picked[0]:
            picked.append(int(i))
            total += int(lengths[i])
    return picked


def setup(cell, seed: int, device, tmp: Path, tracer) -> dict:
    import torch

    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.infer.fused import fused_predict_chop
    from deepchopper_tpu_torch.chop import ChopOptions

    from benchmark.harness.calibrate import set_adapter_bias
    from benchmark.harness.model import served_model

    mix = cell.traffic
    buckets = default_buckets(mix["max_length"])
    model, weights = served_model(cell.config, seed, device)
    set_adapter_bias(weights, cell.config, mix, seed, buckets, device)
    model.load_state_dict(weights, strict=True)
    if device.type == "cuda":
        # The calibration's reference forward is the harness's, not the program's.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    engine = PredictEngine(model, max_length=mix["max_length"], tokens_per_batch=mix["tokens_per_batch"],
                           max_batch=mix["max_batch"], return_labels=True, device=device)  # fmt: skip
    engine.runtime_setup()
    reads = make_reads(mix, mix["reads_per_pass"], seed)
    fq = reads.write_fastq(tmp / "reads.fq")
    engine.warmup(widths_reached(length_set(mix, mix["reads_per_pass"]), buckets, mix["max_length"]))
    warm = make_reads(mix, mix["warm_reads"], seed, stream=1).write_fastq(tmp / "warm.fq")
    fused_predict_chop(engine, warm, ChopOptions(output_prefix=str(tmp / "warm" / "out")))
    shutil.rmtree(tmp / "warm")
    if device.type == "cuda":
        torch.cuda.synchronize()
    sample = _sample(reads.lengths(), seed, mix["check_bases"])
    tap = LabelTap(engine, {reads.names[i].encode(): i for i in sample}, tracer)
    engine.predict_batches = tap
    return {"engine": engine, "weights": weights, "reads": reads, "fq": fq, "tap": tap, "sample": sample,
            "run": lambda k: fused_predict_chop(engine, fq, ChopOptions(output_prefix=str(tmp / f"pass{k}" / "out")))}  # fmt: skip


def window(state: dict, seconds: float, tracer) -> dict:
    engine = state["engine"]
    before = (engine.stats.tokens, engine.stats.padded_tokens, dict(engine.stats.shape_counts))
    passes = []
    with tracer.window():
        t0 = time.monotonic()
        while True:
            with tracer.span("bench.pass"):
                passes.append(state["run"](len(passes)))
            if time.monotonic() - t0 >= seconds:
                break
        window_s = time.monotonic() - t0
    s = engine.stats
    shapes = {k: v - before[2].get(k, 0) for k, v in s.shape_counts.items() if v - before[2].get(k, 0)}
    return {"passes": passes, "window_s": window_s, "tokens": s.tokens - before[0],
            "padded_tokens": s.padded_tokens - before[1], "shapes": shapes}  # fmt: skip


def release(state: dict) -> None:
    """Drop the program's engine and model before the reference runs."""
    state.pop("engine")
    state.pop("run")
    state["tap"].inner = None


def check(cell, state: dict, win: dict, device, mode: str = "f32") -> dict[str, float]:
    """The compared numbers: the widest logit gap over every pass's labels
    of the sample, the sampled reads chopped otherwise than the reference
    chops their labels, and the output's stray reads (`judge.stray_records`);
    besides, as readings, the share of reads the chop cut over all passes
    and of the sample's bases labelled adapter in the first."""
    reads, max_length = state["reads"], cell.traffic["max_length"]
    stray = chopped_wrong = cut = 0
    labels_by_pass = state["tap"].passes
    for k, stats in enumerate(win["passes"]):
        out_path = Path(stats.output_file)
        output = judge.read_output(out_path)
        shutil.rmtree(out_path.parent)
        stray += judge.stray_records(reads.names, output)
        cut += judge.reads_cut(output)
        got = labels_by_pass[k] if k < len(labels_by_pass) else {}
        chopped_wrong += judge.chop_mismatches(reads, {i: lab for i, (_w, lab) in got.items()}, output, max_length)
    items = [(i, labels_by_pass[0][i][0]) if i in labels_by_pass[0] else (i, 0) for i in state["sample"]]
    first = [lab for _w, lab in labels_by_pass[0].values()] if labels_by_pass else []
    out = {"chop_mismatch": float(chopped_wrong), "stray_reads": float(stray),
           "chopped_read_share": cut / max(len(reads) * len(win["passes"]), 1),
           "adapter_base_share": float(np.concatenate(first).mean()) if first else math.nan}  # fmt: skip
    if any(w == 0 for _i, w in items):
        return {"logit_gap": math.inf, "logit_gap_mean": math.inf, "flip_share": math.inf, **out}
    ref = judge.read_logits(state["weights"], cell.config, reads, items, max_length, device, mode)
    band = cell.traffic["tie_band"]
    gaps = [judge.label_gaps(ref, {i: lab for i, (_w, lab) in got.items()}, band) for got in labels_by_pass]
    return {"logit_gap": max(g[0] for g in gaps), "logit_gap_mean": max(g[1] for g in gaps),
            "flip_share": max(g[2] for g in gaps), **out}  # fmt: skip


def end_to_end(cell, state: dict, win: dict) -> dict[str, float]:
    reads = sum(p.total_fq_count for p in win["passes"])
    return {"reads_per_s": reads / win["window_s"]}


def layer_inputs(cell, state: dict, win: dict) -> dict:
    """What the per-layer readers of this path read, besides the trace."""
    from benchmark.counts.flops import forward_flops

    lengths = state["reads"].lengths() + 1  # each read's tokens and SEP
    per_pass = sum(forward_flops(cell.config, int(n)) for n in lengths)
    passes = win["passes"]
    return {
        "kind": "predict",
        "window_s": win["window_s"],
        "tokens": win["tokens"],
        "padded_tokens": win["padded_tokens"],
        "shapes": win["shapes"],
        "model_flops": per_pass * len(passes),
        "feed_s": sum(p.encode_s for p in passes),
        "chop_s": sum(p.smooth_s + p.chop_write_s for p in passes),
        "elapsed_s": sum(p.elapsed_s for p in passes),
    }


def attempted_failed(cell, state: dict, win: dict, compared: dict) -> tuple[int, int]:
    return len(state["reads"]) * len(win["passes"]), int(compared["chop_mismatch"] + compared["stray_reads"])
