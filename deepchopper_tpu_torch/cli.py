"""Command-line interface: `predict`, `train`, `eval`.

Port of those subcommands of `deepchopper_tpu/cli.py`. `predict` keeps its
flags except `--fused-chop`, `--fq`, `--shard-format` (shards are `.npz`) and
`--conv-precision`; `train` and `eval` keep `--config/-c`, the dotted
`key.subkey=value` overrides and `--verbose` (`train --sweep` is not ported
yet). Each adds `--device`: they run on the card unless asked for the CPU;
without CUDA they exit non-zero and write nothing.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from . import __version__


def _add_predict(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("predict", help="Predict per-base adapter labels for a FASTQ")
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
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="Device to run the model on")
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
    _add_train_eval(sub)
    return parser


def predict(args: argparse.Namespace):
    """Run `predict` for parsed arguments and return the engine's
    `PredictStats`. Raises FileNotFoundError when no weights are given and
    DeviceUnavailable when the device is missing."""
    from .device import resolve_device
    from .infer.engine import PredictEngine
    from .models.registry import DeepChopper

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
        device=device,
    )
    return engine.predict_file(
        args.data_path, args.output, max_samples=args.max_sample, limit_batches=args.limit_batches
    )


def cmd_predict(args: argparse.Namespace) -> int:
    from .device import DeviceUnavailable

    try:
        stats = predict(args)
    except FileNotFoundError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    print(
        f"predicted {stats.reads} reads ({stats.tokens} tokens, {stats.batches} batches) "
        f"in {stats.elapsed_s:.3f}s on {args.device} -> {args.output}"
    )
    return 0


def train_config(args: argparse.Namespace):
    """The TrainConfig of parsed `train`/`eval` arguments (`--device` wins
    over a `device=` override)."""
    from .train.config import load_config

    cfg = load_config(args.config, args.overrides)
    cfg.device = args.device
    return cfg


def cmd_train(args: argparse.Namespace) -> int:
    from .device import DeviceUnavailable
    from .train.loop import train

    try:
        metrics = train(train_config(args))
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    print(f"train done: {metrics}")
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    from .device import DeviceUnavailable
    from .train.loop import evaluate

    try:
        metrics = evaluate(train_config(args))
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    print(f"eval done: {metrics}")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if getattr(args, "verbose", False) else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    handlers = {"predict": cmd_predict, "train": cmd_train, "eval": cmd_eval}
    return handlers[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
