"""TensorBoard event-file logger, dependency-free.

Copy of `deepchopper_tpu/train/tb_logger.py`. Writes standard
`events.out.tfevents.*` files readable by TensorBoard. The TFRecord framing
(masked CRC32C) and the Event/Summary protobuf wire encodings are tiny and
hand-rolled, so no tensorboard package is needed.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire helpers
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _pb_string(num: int, s: bytes) -> bytes:
    return _field(num, 2) + _varint(len(s)) + s


def _pb_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _pb_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _pb_int64(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value { string tag = 1; float simple_value = 2; }
    body = _pb_string(1, tag.encode()) + _pb_float(2, float(value))
    return _pb_string(1, body)  # Summary.value is repeated field 1


def _event(wall_time: float, step: int, payload: bytes) -> bytes:
    # Event { double wall_time = 1; int64 step = 2; ... }
    return _pb_double(1, wall_time) + _pb_int64(2, step) + payload


class TensorBoardLogger:
    """Append scalar summaries to an events file under `log_dir`."""

    def __init__(self, log_dir: str | Path):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self.path = log_dir / name
        self._fh = open(self.path, "ab")
        # file_version event (Event.file_version = field 3, string)
        self._write(_event(time.time(), 0, _pb_string(3, b"brain.Event:2")))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(record)
        self._fh.write(struct.pack("<I", _masked_crc(record)))
        self._fh.flush()

    def log_scalars(self, step: int, scalars: dict[str, float]) -> None:
        summary = b"".join(
            _summary_value(tag, v)
            for tag, v in scalars.items()
            if isinstance(v, (int, float))
        )
        if not summary:
            return
        # Event.summary = field 11 (message)
        self._write(_event(time.time(), step, _pb_string(11, summary)))

    def log(self, row: dict) -> None:
        """CsvLogger-compatible entry point (epoch column becomes the step)."""
        step = int(row.get("epoch", row.get("step", 0)))
        self.log_scalars(step, {k: v for k, v in row.items() if isinstance(v, (int, float))})

    def close(self) -> None:
        self._fh.close()
