"""Single-record web demo.

Port of `deepchopper_tpu/ui/main.py`: paste one FASTQ record; the model
predicts per-base adapter labels, they are smoothed into intervals, and the
chopped segments are highlighted. `predict_record` is the UI-independent
core; `launch` serves it with gradio, an optional dependency: without it
`launch` raises ImportError.

`predict_record` runs one read at its own width (its length plus the SEP
token), as the JAX package does, through `PredictEngine.step` (int8 ids and
uint8 phred in, the quality norm on the device), on the model's device. At a
width outside the kernels' rule Hyena takes the route the JAX width rule
gives (`models.hyena.mixer_route`), as `predict` does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default
from ..data.bucketing import encode_read
from ..io.chop import remove_intervals_and_keep_left
from ..ops.labels import smooth_label_region
from ..ops.qual import encode_qual
from ..ops.sequence import normalize_seq
from ..utils.vis import highlight_targets


def parse_fq_record(text: str) -> tuple[str, str, str]:
    """Parse a pasted 4-line FASTQ record into (id, sequence, quality)."""
    lines = [ln.strip() for ln in text.strip().splitlines() if ln.strip()]
    if len(lines) < 4 or not lines[0].startswith("@"):
        raise ValueError("expected a 4-line FASTQ record starting with '@'")
    rid, seq, qual = lines[0][1:], lines[1], lines[3]
    if len(seq) != len(qual):
        raise ValueError("sequence and quality lengths differ")
    return rid, seq, qual


def predict_record(
    text: str,
    model: torch.nn.Module | None = None,
    smooth_window_size: int = default.SMOOTH_WINDOW_SIZE,
    min_interval_size: int = default.MIN_INTERVAL_SIZE,
    approved_interval_number: int = default.APPROVED_INTERVAL_NUMBER,
    torch_checkpoint: str | None = None,
    random_init: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Predict, smooth and chop one pasted record; returns the display
    payload: id, labels, smooth_intervals, highlighted, kept_segments,
    kept_intervals.

    With `model=None` the rna002 model is loaded on `device` (the card
    unless the CPU is asked for), its weights from `torch_checkpoint` or,
    with `random_init=True`, untrained: missing weights are a hard error.
    A given `model` runs on its own device."""
    from ..infer.engine import PredictEngine
    from ..models.registry import DeepChopper

    rid, seq, qual = parse_fq_record(text)
    seq = normalize_seq(seq)
    if model is None:
        model = DeepChopper.from_pretrained("rna002", torch_checkpoint=torch_checkpoint, random_init=random_init,
                                            device=device)  # fmt: skip
    engine = PredictEngine(model, device=next(model.parameters()).device)
    enc = encode_read(rid, seq, encode_qual(qual), None, max_length=32768)
    ids = torch.from_numpy(enc.input_ids[None].astype(np.int8)).to(engine.device)
    quals = torch.from_numpy(enc.quals_raw[None]).to(engine.device)
    logits = engine.step(ids, quals)[0].cpu().numpy()
    labels = logits.argmax(-1)[: len(seq)].astype(np.int8)
    intervals = smooth_label_region(labels, smooth_window_size, min_interval_size, approved_interval_number)
    kept, selected = remove_intervals_and_keep_left(seq, intervals)
    return {
        "id": rid,
        "labels": labels,
        "smooth_intervals": intervals,
        "highlighted": highlight_targets(seq, intervals, text_width=80, color=False),
        "kept_segments": [k.decode("ascii") for k in kept],
        "kept_intervals": selected,
    }


def launch(
    port: int = 7860,
    checkpoint: str | None = None,
    torch_checkpoint: str | None = None,
    random_init: bool = False,
    device: str | torch.device = "cuda",
) -> None:  # pragma: no cover - needs gradio
    """Serve the demo on `port` with the rna002 model on `device`. Raises
    ImportError without gradio, before loading anything."""
    try:
        import gradio as gr
    except ImportError as exc:
        raise ImportError(
            "gradio is not installed in this environment; the UI core (predict_record) works without it"
        ) from exc

    from ..models.registry import DeepChopper

    if checkpoint is not None:
        model = DeepChopper.from_checkpoint(checkpoint, "rna002", device=device)
    else:
        model = DeepChopper.from_pretrained("rna002", torch_checkpoint=torch_checkpoint, random_init=random_init,
                                            device=device)  # fmt: skip

    def _run(text: str):
        try:
            out = predict_record(text, model)
        except ValueError as exc:  # a malformed record: shown to the user, the server keeps serving
            return f"error: {exc}", ""
        return str(out["smooth_intervals"]), out["highlighted"]

    with gr.Blocks(title="DeepChopper") as demo:
        gr.Markdown("# DeepChopper\nDetect and chop chimera artifacts.")
        inp = gr.Textbox(lines=6, label="FASTQ record")
        btn = gr.Button("Predict")
        intervals = gr.Textbox(label="Adapter intervals")
        highlighted = gr.Textbox(label="Highlighted sequence")
        btn.click(_run, inputs=inp, outputs=[intervals, highlighted])
    demo.launch(server_port=port)
