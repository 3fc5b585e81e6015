"""Command-line interface: `predict`, `chop`, `train`, `eval`.

Port of those subcommands of `deepchopper_tpu/cli.py`. `predict` keeps its
flags, `--fused-chop`, `--fq` and `--shard-format` included, except
`--conv-precision`, which picks the TPU kernels' DFT precision and has no
counterpart here. `chop` keeps all of its flags. `train` and `eval` keep
`--config/-c`, the dotted `key.subkey=value` overrides and `--verbose`
(`train --sweep` is not ported yet). `predict`, `train` and `eval` add
`--device`: they run on the card unless asked for the CPU; without CUDA they
exit non-zero and write nothing. `chop` runs on the host only.

Over several ranks, one process a card (`parallel/`): `predict` joins the
ranks a launcher started (`DC_COORDINATOR`, `DC_NUM_PROCESSES`,
`DC_PROCESS_ID`, or torchrun's variables), each rank writing its own
`{rank}_{batch}` shards, or, with `--fused-chop`, chopping its own reads
into a part that rank 0 merges. `train` and `eval` start
`trainer.n_devices` ranks themselves when no launcher did.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from . import __version__


def _add_predict(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "predict",
        help="Predict per-base adapter labels for a FASTQ",
        epilog="The JAX package's --conv-precision is left out: it picks the TPU kernels' DFT precision, "
        "and the CUDA kernels compute their FFT in float32 always.",
    )
    p.add_argument("data_path", type=Path, help="Path to the FASTQ dataset")
    p.add_argument("--output", "-o", type=Path, default=Path("predictions"), help="Directory for prediction shards")
    p.add_argument("--batch-tokens", type=int, default=1 << 17, help="Tokens per device batch")
    p.add_argument("--batch-size", "-b", type=int, default=None, help="Cap on reads per batch")
    p.add_argument("--model", "-m", default="rna002", help="Model name (rna002, rna004, or registry name)")
    p.add_argument("--checkpoint", type=Path, default=None, help="Port checkpoint (torch.save of a state_dict)")
    p.add_argument("--torch-checkpoint", type=Path, default=None, help="Reference torch checkpoint to convert")
    p.add_argument(
        "--random-init",
        action="store_true",
        help="Run with UNTRAINED weights (tests/benchmarks only; otherwise missing weights are a hard error)",
    )
    p.add_argument("--max-sample", type=int, default=None, help="Stop after this many reads")
    p.add_argument("--limit-batches", type=int, default=None, help="Stop after this many device batches")
    p.add_argument("--max-length", type=int, default=32768, help="Token window; longer reads are truncated and flagged")
    p.add_argument("--fused-chop", action="store_true", help="Skip shard IO: predict and chop in one pass")
    p.add_argument(
        "--shard-format",
        choices=["npz", "pt"],
        default="npz",
        help="Prediction shard format: npz, or pt (the reference's torch format, readable by deepchopper-chop)",
    )
    p.add_argument("--fq", type=Path, default=None, help="FASTQ for --fused-chop qualities (defaults to data_path)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="Device to run the model on")
    p.add_argument("--verbose", "-v", action="store_true", help="Log at INFO level")


def _add_chop(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("chop", help="Chop reads using prediction shards")
    p.add_argument("predicts", type=Path, nargs="+", help="Prediction shard dirs/files (.pt or .npz)")
    p.add_argument("fq", type=Path, help="FASTQ file")
    p.add_argument("--smooth-window", "-s", type=int, default=21, help="Majority-vote smoothing window (odd)")
    p.add_argument("--min-interval-size", "--mis", type=int, default=13, help="Drop predicted adapter intervals shorter than this")
    p.add_argument("--approved-intervals", "-a", type=int, default=20, help="Reject reads with more smoothed intervals than this")
    p.add_argument("--max-process-intervals", "--mpi", type=int, default=4, help="Pass reads through unchanged above this interval count")
    p.add_argument("--min-read-length", "--mcr", type=int, default=20, help="Minimum kept-fragment length after chopping")
    p.add_argument("--output-chopped", "--ocq", action="store_true", help="Emit the removed adapter sequences instead of the kept parts")
    p.add_argument("--chop-type", "--ct", default="all", choices=["terminal", "internal", "all"], help="Restrict chopping to terminal/internal adapter reads")
    p.add_argument("--threads", "-t", type=int, default=2, help="BGZF writer threads")
    p.add_argument("--output", "-o", dest="output_prefix", default=None, help="Output prefix (default: input stem); suffix .<N>pd.<M>record.chop.fq.gz is appended")
    p.add_argument("--max-batch", "-m", type=int, default=None, help="Cap on the prediction shard files loaded")
    p.add_argument("--chunk-size", type=int, default=10000, help="Streaming chunk size in reads (bounds RSS)")
    p.add_argument("--verbose", "-v", action="store_true", help="Log at INFO level")


def _add_train_eval(sub: argparse._SubParsersAction) -> None:
    for name, text in (("train", "Train a model (config file + dotted overrides)"),
                       ("eval", "Evaluate a checkpoint (test split, or predict)")):  # fmt: skip
        p = sub.add_parser(name, help=text)
        p.add_argument("--config", "-c", type=Path, default=None, help="YAML config file (needs PyYAML)")
        p.add_argument("overrides", nargs="*", help="key.subkey=value overrides")
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="Device to run the model on")
        p.add_argument("--verbose", "-v", action="store_true", help="Log at INFO level")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deepchopper-tpu-torch",
        description="DeepChopper (PyTorch/CUDA port): a genomic language model to identify artificial sequences.",
    )
    parser.add_argument("--version", "-V", action="version", version=f"DeepChopper-TPU-torch {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_predict(sub)
    _add_chop(sub)
    _add_train_eval(sub)
    return parser


def predict(args: argparse.Namespace):
    """Run `predict` for parsed arguments. Returns the engine's `PredictStats`
    or, with `--fused-chop`, the chop's stats (`FusedStats` of the streamed
    runner, `ChopStats` with `--fq` set to another file or over several
    ranks, where ranks other than 0 return None), with the engine's
    `PredictStats` under `extras["engine"]`. Raises FileNotFoundError when no
    weights are given and DeviceUnavailable when the device is missing.

    Runs on the ranks of the process group the caller is in (`cmd_predict`
    joins a launcher's); each rank predicts its interleaved slice."""
    from .device import resolve_device
    from .infer.engine import PredictEngine
    from .models.registry import DeepChopper
    from .parallel import process_shard_info

    if not args.data_path.exists():
        raise FileNotFoundError(f"data path '{args.data_path}' does not exist.")
    device = resolve_device(args.device)
    if args.checkpoint is not None:
        model = DeepChopper.from_checkpoint(
            args.checkpoint, DeepChopper.PRETRAINED_ALIASES.get(args.model, args.model), device=device
        )
    else:
        model = DeepChopper.from_pretrained(
            args.model, torch_checkpoint=args.torch_checkpoint, random_init=args.random_init, device=device
        )
    engine = PredictEngine(
        model,
        max_length=args.max_length,
        tokens_per_batch=args.batch_tokens,
        max_batch=args.batch_size or 512,
        return_labels=args.fused_chop,
        device=device,
    )
    if not args.fused_chop:
        return engine.predict_file(
            args.data_path, args.output, max_samples=args.max_sample, limit_batches=args.limit_batches,
            shard_format=args.shard_format,
        )  # fmt: skip
    from .chop import ChopOptions

    engine.runtime_setup()  # where the JAX package runs warmup_async: off the timed stream
    rank, world = process_shard_info()
    if world > 1:
        # Each rank predicts its interleaved slice into {rank}_{batch} shards,
        # then chops the reads it predicted into a BGZF part; rank 0 merges
        # the parts (shard-parallel: smoothing, splitting and deflate run on
        # every rank at once).
        from .chop.pipeline import multihost_stream_chop
        from .io.predicts import load_predicts_from_batch_pts
        from .parallel import barrier

        engine.predict_file(args.data_path, args.output, max_samples=args.max_sample)
        barrier("deepchopper_predict_done")
        own = load_predicts_from_batch_pts(Path(args.output) / "0", pattern=f"{rank}_*")
        stats = multihost_stream_chop(own, args.fq or args.data_path, ChopOptions(), rank=rank, nprocs=world,
                                      barrier=barrier)  # fmt: skip
    elif args.fq is not None and args.fq != args.data_path:
        # The streamed runner predicts and chops one stream; a different
        # qualities file takes the two-phase in-memory path.
        from .chop import stream_chop_with_predicts

        predicts = engine.predict_to_predicts(args.data_path, max_samples=args.max_sample)
        stats = stream_chop_with_predicts(predicts, args.fq, ChopOptions())
    else:
        from .infer.fused import fused_predict_chop

        stats = fused_predict_chop(engine, args.data_path, ChopOptions(), max_samples=args.max_sample)
    if stats is not None:
        stats.extras["engine"] = engine.stats
    return stats


def cmd_predict(args: argparse.Namespace) -> int:
    from .device import DeviceUnavailable
    from .parallel import joined

    try:
        with joined(args.device):
            stats = predict(args)
    except FileNotFoundError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    if stats is None:  # a rank other than 0 of the shard-parallel chop: rank 0 reports
        return 0
    if args.fused_chop:
        engine = stats.extras["engine"]
        print(
            f"chopped {stats.total_fq_count} reads -> {stats.total_output_count} records in {stats.elapsed_s:.3f}s "
            f"(setup {engine.setup_s:.3f}s, graph capture {engine.compile_s:.3f}s) on {args.device} "
            f"-> {stats.output_file}"
        )
    else:
        print(
            f"predicted {stats.reads} reads ({stats.tokens} tokens, {stats.batches} batches) "
            f"in {stats.elapsed_s:.3f}s (graph capture {stats.compile_s:.3f}s) on {args.device} -> {args.output}"
        )
    return 0


def cmd_chop(args: argparse.Namespace) -> int:
    from .chop import ChopOptions, run_chop
    from .io.chop import ChopType

    opts = ChopOptions(
        smooth_window_size=args.smooth_window,
        min_interval_size=args.min_interval_size,
        approved_interval_number=args.approved_intervals,
        max_process_intervals=args.max_process_intervals,
        min_read_length_after_chop=args.min_read_length,
        output_chopped_seqs=args.output_chopped,
        chop_type=ChopType.parse(args.chop_type),
        chunk_size=args.chunk_size,
        threads=args.threads,
        max_batch_size=args.max_batch,
        output_prefix=args.output_prefix,
    )
    stats = run_chop(list(args.predicts), args.fq, opts)
    print(
        f"processed {stats.total_fq_count} reads -> {stats.total_output_count} records "
        f"in {stats.elapsed_s:.3f}s -> {stats.output_file}"
    )
    return 0


def train_config(args: argparse.Namespace):
    """The TrainConfig of parsed `train`/`eval` arguments (`--device` wins
    over a `device=` override)."""
    from .train.config import load_config

    cfg = load_config(args.config, args.overrides)
    cfg.device = args.device
    return cfg


def on_ranks(fn, cfg):
    """`fn(cfg)` on the run's ranks; returns rank 0's result, None on the
    other ranks. Inside a launcher's ranks each process joins them and runs
    its own; else `trainer.n_devices` above 1 (None: every visible card)
    spawns that many ranks (`parallel.launch`), and one rank runs here."""
    from .parallel import joined, launch, launched_world
    from .train.loop import world_size

    if launched_world() > 1:
        with joined(cfg.device) as (rank, _world):
            out = fn(cfg)
        return out if rank == 0 else None
    world = world_size(cfg)
    return launch(fn, world, cfg.device, args=(cfg,)) if world > 1 else fn(cfg)


def cmd_train(args: argparse.Namespace) -> int:
    from .device import DeviceUnavailable
    from .train.loop import train

    try:
        metrics = on_ranks(train, train_config(args))
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    if metrics is not None:
        print(f"train done: {metrics}")
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    from .device import DeviceUnavailable
    from .train.loop import evaluate

    try:
        metrics = on_ranks(evaluate, train_config(args))
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    if metrics is not None:
        print(f"eval done: {metrics}")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if getattr(args, "verbose", False) else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from .utils.pylogger import suppress_warnings

    suppress_warnings(verbose=getattr(args, "verbose", False))
    handlers = {"predict": cmd_predict, "chop": cmd_chop, "train": cmd_train, "eval": cmd_eval}
    return handlers[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
