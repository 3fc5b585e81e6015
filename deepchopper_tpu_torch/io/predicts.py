"""Prediction shards: the predict -> chop file contract.

Trimmed copy of the writer half of `deepchopper_tpu/io/predicts.py`. Shards
are `.npz` files with keys {prediction (B, W, 2) float32 logits or (B, W)
int8 labels, target (B, W), seq (B, W) input ids, qual (B, W), id (B, 256)
packed ascii}; the JAX package's `chop` reads them unchanged.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import default


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
