"""Device selection for the entry points.

Entry points default to the card. When CUDA is missing they raise: the CPU
is used only when the caller asks for it.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device is not present."""


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available on this machine; pass device='cpu' (CLI: --device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceUnavailable(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
