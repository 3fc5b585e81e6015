"""Data-parallel ranks: the port's distributed plane, on `torch.distributed`.

Port of `deepchopper_tpu/parallel/mesh.py`. The reference's only model-side
parallelism is DDP data parallelism. The JAX package drives every local
device from one process through a 1-axis `Mesh` (`train`, and the engine's
`mesh=`), and runs one process per host only across hosts (`predict`, through
`jax.distributed`). PyTorch's idiom is one process per GPU, so here a rank
is a process, and both of JAX's forms become ranks:

- `predict` takes its ranks from a launcher: `DC_COORDINATOR` (host:port),
  `DC_NUM_PROCESSES` and `DC_PROCESS_ID`, JAX's names, or torchrun's
  `MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE` and `RANK`. Each rank predicts
  its interleaved slice of the FASTQ and writes `{rank}_{batch}` shards,
  merged at the chop stage (`chop.pipeline.multihost_stream_chop`).
- `train` and `eval` with `trainer.n_devices` above 1 and no launcher start
  their own ranks (`launch`), one a card, under DDP.

The engine's single-process `mesh=` has no counterpart. What it promised,
sharded predict equals one device (`tests/test_multichip_predict.py:34`),
is held through ranks instead: the shards of several ranks chop to the same
bytes as one rank's.

Backends are chosen explicitly, never by falling back: `nccl` when each rank
has its own card, `gloo` on the CPU, and `gloo` when the caller places
several ranks on one card (the launcher sets `DC_BACKEND=gloo` and gives
every rank the same `LOCAL_RANK`). A rank's card is `cuda:$LOCAL_RANK`
(torchrun and `launch` set it; a `DC_*` launch of several processes on one
host sets it too), else the current card, as for JAX's one process a host:
`DC_PROCESS_ID` is a global index and names no card. A card count above
what is visible raises ValueError, as `make_mesh` does.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import socket
from collections.abc import Callable, Iterator
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist

from ..device import local_rank, resolve_device

# A collective that waits longer than this on a rank that died raises.
TIMEOUT = timedelta(minutes=10)


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def launched_world() -> int:
    """The number of ranks a launcher set in the environment (1 when none)."""
    return _env_int("DC_NUM_PROCESSES", "WORLD_SIZE") or 1


def default_backend(device: str | torch.device) -> str:
    """`DC_BACKEND` when the launcher set it, else nccl on the card and gloo
    on the CPU."""
    return os.environ.get("DC_BACKEND") or ("nccl" if torch.device(device).type == "cuda" else "gloo")


def initialize_distributed(
    backend: str | None = None,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Join the ranks a launcher started; returns True when a group of more
    than one rank is up (also when one already was), False for one process,
    which sets nothing up.

    Arguments fall back to `DC_COORDINATOR`, `DC_NUM_PROCESSES` and
    `DC_PROCESS_ID`, then to torchrun's `MASTER_ADDR`:`MASTER_PORT`,
    `WORLD_SIZE` and `RANK`. On the card each rank first takes its own
    device (`local_device`), so a rank whose card is missing raises before
    it joins."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes is None:
        num_processes = launched_world()
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = _env_int("DC_PROCESS_ID", "RANK")
    coordinator = coordinator or os.environ.get("DC_COORDINATOR")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if process_id is None or coordinator is None:
        raise ValueError(
            f"{num_processes} ranks, but no rank id or coordinator: set DC_PROCESS_ID and DC_COORDINATOR "
            "(or RANK, MASTER_ADDR and MASTER_PORT)"
        )
    backend = backend or default_backend(device)
    card = local_device(device) if torch.device(device).type == "cuda" else None
    # NCCL is told its rank's card: else it guesses cuda:{rank}, wrong for
    # one process a host.
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id, timeout=TIMEOUT,
        device_id=card if backend == "nccl" else None,
    )  # fmt: skip
    return True


def process_shard_info() -> tuple[int, int]:
    """(rank, world size): names the per-rank output shards."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier(name: str) -> None:
    """Wait for every rank (JAX's `sync_global_devices(name)`; the name is
    for the reader). Nothing to wait for in one process."""
    del name
    if dist.is_initialized():
        dist.barrier()


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: the CPU when asked for it, else the local rank's
    card (`device.resolve_device`), made the current CUDA device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over the ranks, in place; returns it."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def shutdown() -> None:
    """Leave the group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def joined(device: str | torch.device = "cuda") -> Iterator[tuple[int, int]]:
    """Join a launcher's ranks (`initialize_distributed`) for the duration;
    yields (rank, world size). Leaves only a group it set up itself."""
    owned = not dist.is_initialized()
    initialize_distributed(device=device)
    try:
        yield process_shard_info()
    finally:
        if owned:
            shutdown()


def check_world(world: int, device: str | torch.device) -> None:
    """One rank a card: more ranks than visible cards raise ValueError."""
    if torch.device(device).type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"requested {world} devices, have {torch.cuda.device_count()}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, device: str, backend: str | None, args: tuple,
               results) -> None:  # fmt: skip
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))  # fmt: skip
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # Explicit arguments: DC_* variables the parent inherited must not win.
    initialize_distributed(backend, f"127.0.0.1:{port}", world, rank, device=device)
    try:
        out = fn(*args)
        if rank == 0:
            # Plain pickle copies tensors' data: a result must outlive its rank.
            results.put(pickle.dumps(out))
    finally:
        shutdown()


def launch(fn: Callable, world: int, device: str | torch.device = "cuda", backend: str | None = None,
           args: tuple = ()) -> Any:  # fmt: skip
    """Run `fn(*args)` on `world` ranks, one process each (spawned, on a free
    localhost port; rank r on `cuda:r`, or the CPU); returns rank 0's result.

    `fn` must be importable by name, and its result picklable. A rank that
    raises or dies ends the others, and `launch` raises
    `torch.multiprocessing.ProcessRaisedException` (or `ProcessExitedException`)."""
    check_world(world, device)
    results = torch.multiprocessing.get_context("spawn").SimpleQueue()
    ranks = torch.multiprocessing.start_processes(
        _rank_main,
        args=(fn, world, _free_port(), str(device), backend, args, results),
        nprocs=world,
        join=False,
        start_method="spawn",
    )
    got = []
    while True:  # drain the result while waiting, so rank 0 never blocks on a full pipe
        done = ranks.join(timeout=0.2)  # raises when a rank failed, after ending the others
        while not results.empty():
            got.append(results.get())
        if done:
            return pickle.loads(got[0])
