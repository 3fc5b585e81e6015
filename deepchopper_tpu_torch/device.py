"""Device selection for the entry points.

Entry points default to the card. When CUDA is missing they raise: the CPU
is used only when the caller asks for it. A rank of a multi-rank run takes
the card of its local rank (`LOCAL_RANK`, set by torchrun and by
`parallel.launch`); any other process, and a rank whose launcher set no
`LOCAL_RANK` (JAX's `DC_*` launch, one process a host), the current card.
"""

from __future__ import annotations

import os

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device is not present."""


def local_rank() -> int | None:
    """This process's rank among those on its machine, `LOCAL_RANK` as its
    launcher set it; None outside a launch of more than one rank
    (`DC_NUM_PROCESSES` or `WORLD_SIZE`). `DC_PROCESS_ID` is a global index,
    one process a host, and names no card."""
    world = os.environ.get("DC_NUM_PROCESSES") or os.environ.get("WORLD_SIZE") or "1"
    if int(world) > 1 and os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return None


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` with its card index filled in: the local rank's card inside a
    launch (ValueError when that card is not visible), else the current one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available on this machine; pass device='cpu' (CLI: --device cpu) to run on the CPU"
            )
        if dev.index is None:
            index = local_rank()
            if index is None:
                index = torch.cuda.current_device()
            elif index >= torch.cuda.device_count():
                raise ValueError(
                    f"local rank {index} has no card: {torch.cuda.device_count()} visible (ranks that share a "
                    "card set the same LOCAL_RANK and DC_BACKEND=gloo)"
                )
            dev = torch.device("cuda", index)
    elif dev.type != "cpu":
        raise DeviceUnavailable(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
