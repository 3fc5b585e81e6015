"""Prediction shards: the predict -> chop file contract.

Copy of `deepchopper_tpu/io/predicts.py`. A shard holds one batch under the
keys {prediction (B, W, 2) float32 logits or (B, W) int8 labels, target
(B, W), seq (B, W) input ids, qual (B, W), id (B, 256) packed ascii}, as a
`.npz` file or as the reference's torch `.pt` dict; the loaders read both,
and so does the JAX package's `chop`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import default
from ..ops.labels import get_label_region, majority_voting
from ..ops.sequence import ascii_list2str, detokenize_bases

log = logging.getLogger(__name__)


@dataclass
class Predict:
    """One read's per-base predictions."""

    prediction: np.ndarray  # int8 per-base labels (ignore positions removed)
    seq: str
    id: str
    is_truncated: bool
    qual: str | None = None

    def seq_len(self) -> int:
        return len(self.seq)

    def qual_array(self) -> np.ndarray:
        if self.qual is None:
            return np.zeros(0, dtype=np.uint8)
        return np.frombuffer(self.qual.encode("ascii"), dtype=np.uint8) - default.QUAL_OFFSET

    def prediction_region(self) -> list[tuple[int, int]]:
        return get_label_region(self.prediction)

    def smooth_label(self, window_size: int) -> np.ndarray:
        return majority_voting(self.prediction, window_size)

    def smooth_prediction(self, window_size: int) -> list[tuple[int, int]]:
        return get_label_region(self.smooth_label(window_size))

    def smooth_and_select_intervals(
        self, smooth_window_size: int, min_interval_size: int, approved_interval_number: int
    ) -> list[tuple[int, int]]:
        """Smooth -> region-extract -> min-size filter -> count gate."""
        regions = self.smooth_prediction(smooth_window_size)
        intervals = [(s, e) for (s, e) in regions if e - s >= min_interval_size]
        if len(intervals) > approved_interval_number:
            return []
        return intervals


def decode_shard_arrays(
    prediction: np.ndarray,
    target: np.ndarray,
    seq: np.ndarray,
    ids: np.ndarray,
    ignore_label: int = default.IGNORE_LABEL,
) -> dict[str, Predict]:
    """Decode batch arrays into per-read `Predict`s.

    `prediction` is (B, L, 2) logits (argmaxed here) or (B, L) labels.
    Positions whose target is `ignore_label` are dropped.
    """
    prediction = np.asarray(prediction)
    if prediction.ndim == 3:
        labels = np.argmax(prediction, axis=2).astype(np.int8)
    else:
        labels = prediction.astype(np.int8)
    keep = np.asarray(target) != ignore_label
    seq = np.asarray(seq)
    ids = np.asarray(ids)
    out: dict[str, Predict] = {}
    for i in range(labels.shape[0]):
        id_len = int(ids[i, 0])
        id_str = ascii_list2str(ids[i, 2 : id_len + 2])
        out[id_str] = Predict(
            prediction=labels[i][keep[i]],
            seq=detokenize_bases(seq[i][keep[i]]),
            id=id_str,
            is_truncated=bool(ids[i, 1]),
        )
    return out


def load_predicts_from_batch_pt(pt_path: str | Path, ignore_label: int = default.IGNORE_LABEL) -> dict[str, Predict]:
    """Load one reference-format torch `.pt` shard."""
    tensors = torch.load(pt_path, map_location="cpu", weights_only=True)
    return decode_shard_arrays(
        tensors["prediction"].numpy(),
        tensors["target"].numpy(),
        tensors["seq"].numpy(),
        tensors["id"].numpy(),
        ignore_label,
    )


def load_predicts_from_batch_npz(npz_path: str | Path, ignore_label: int = default.IGNORE_LABEL) -> dict[str, Predict]:
    """Load one `.npz` shard."""
    with np.load(npz_path) as data:
        return decode_shard_arrays(data["prediction"], data["target"], data["seq"], data["id"], ignore_label)


def load_predicts_from_batch_pts(
    path: str | Path,
    ignore_label: int = default.IGNORE_LABEL,
    max_predicts: int | None = None,
    pattern: str = "*",
) -> dict[str, Predict]:
    """Load every `.pt`/`.npz` shard under a directory (or one shard file),
    in sorted path order. `max_predicts` caps the number of shard files;
    `pattern` restricts the walk (`"3_*"` loads rank 3's shards alone, as the
    shard-parallel chop does). A shard that fails to load is skipped with a
    warning, as the reference's chop does."""
    path = Path(path)
    if path.is_file():
        files = [path]
    else:
        files = sorted(p for p in path.rglob(pattern) if p.suffix in (".pt", ".npz"))
    if max_predicts is not None and len(files) > max_predicts:
        files = files[:max_predicts]
    out: dict[str, Predict] = {}
    for f in files:
        try:
            loader = load_predicts_from_batch_pt if f.suffix == ".pt" else load_predicts_from_batch_npz
            out.update(loader(f, ignore_label))
        except Exception as exc:  # noqa: BLE001 - a bad shard is skipped, as the reference does
            log.warning("load shard %s failed: %s", f, exc)
    return out


def pack_read_ids(ids: list[str], truncated: list[bool], max_id_length: int = default.MAX_ID_LENGTH) -> np.ndarray:
    """Pack read ids as [len, truncated, ord(c)...] rows padded to fixed width."""
    out = np.zeros((len(ids), max_id_length), dtype=np.int32)
    for i, (rid, trunc) in enumerate(zip(ids, truncated)):
        encoded = rid.encode("ascii", errors="replace")[: max_id_length - 2]
        out[i, 0] = len(rid)
        out[i, 1] = int(trunc)
        out[i, 2 : 2 + len(encoded)] = np.frombuffer(encoded, dtype=np.uint8)
    return out


def write_prediction_shard(
    path: str | Path,
    prediction: np.ndarray,
    target: np.ndarray,
    seq: np.ndarray,
    qual: np.ndarray,
    ids: np.ndarray,
) -> None:
    """Write one `.npz` shard with the predict->chop contract keys."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(
        tmp,
        prediction=np.asarray(prediction),
        target=np.asarray(target),
        seq=np.asarray(seq),
        qual=np.asarray(qual),
        id=np.asarray(ids),
    )
    tmp.replace(path)


def write_prediction_shard_pt(
    path: str | Path,
    prediction: np.ndarray,
    target: np.ndarray,
    seq: np.ndarray,
    qual: np.ndarray,
    ids: np.ndarray,
) -> None:
    """Write one reference-format torch `.pt` shard: the tensor dict the
    reference's predict callback saves (float logits, int64 target, seq and
    id, float qual), which the reference's `deepchopper-chop` reads."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp.pt")
    torch.save(
        {
            "prediction": torch.from_numpy(np.ascontiguousarray(prediction, dtype=np.float32)),
            "target": torch.from_numpy(np.ascontiguousarray(target, dtype=np.int64)),
            "seq": torch.from_numpy(np.ascontiguousarray(seq, dtype=np.int64)),
            "qual": torch.from_numpy(np.ascontiguousarray(qual, dtype=np.float32)),
            "id": torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64)),
        },
        tmp,
    )
    tmp.replace(path)
