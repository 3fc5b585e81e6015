"""The run's last line, and the numbers `correct` compared, each beside its
limit, as the last lines of standard error."""

from __future__ import annotations

import json
import math
import subprocess
import sys


def device_info(count: int) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True,
        )  # fmt: skip
        out["power_limit_w"] = float(got.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def within_limits(compared: dict[str, tuple[float, float]]) -> bool:
    """Every number at or under its limit (a number that is not finite fails)."""
    return all(math.isfinite(v) and v <= lim for v, lim in compared.values())


def emit(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
         compared: dict[str, tuple[float, float]], breakdown: dict | None = None) -> None:  # fmt: skip
    """Print the compared numbers to stderr, then the result line last on stdout."""
    for name, (value, limit) in compared.items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    # JSON has no infinity or NaN: a number that is not finite prints as null.
    line["compared"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim} for k, (v, lim) in compared.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
