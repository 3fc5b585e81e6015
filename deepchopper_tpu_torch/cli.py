"""Command-line interface: `predict`, `chop`, `train`, `eval`, `web`,
`encode`, `stat`, `eval-bam`, `tools`.

Port of `deepchopper_tpu/cli.py`. `predict` keeps its flags, `--fused-chop`,
`--fq` and `--shard-format` included, except `--conv-precision`, which picks
the TPU kernels' DFT precision and has no counterpart here; `--model` also
takes a model folder (`save_pretrained`). `chop` keeps all of its flags.
`train` and `eval` keep `--config/-c`, the dotted `key.subkey=value`
overrides and `--verbose`, and `train` keeps `--sweep <yaml>` (TPE +
pruning, `train/sweep.py`; each trial on the ranks `train` would use). `web`
keeps its flags; the UI needs gradio, and without it `web` exits 1.
`predict`, `train`, `eval` and `web` add `--device`: they run on the card
unless asked for the CPU; without CUDA they exit non-zero and write nothing.

`chop`, `encode`, `stat`, `eval-bam` and `tools` (12 subtools) run on the
host only and take no `--device`; they keep the JAX package's flags,
defaults and printed lines. `encode` writes the parquet datasets that
`train data.train_data_path=<x.parquet>` reads; parquet needs pyarrow.
`eval-bam` scores prediction shards (`.npz` or `.pt`) against a BAM of the
unchopped reads, writing `stats_pd{N}_bt{M}.json` and
`overlap_results_spd{S}_pd{N}.json`.

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
        p.add_argument("--config", "-c", type=Path, default=None,
                       help="YAML config file (block mappings of scalars, as under configs/)")  # fmt: skip
        p.add_argument("overrides", nargs="*", help="key.subkey=value overrides")
        if name == "train":
            p.add_argument("--sweep", type=Path, default=None,
                           help="hparams-search YAML (TPE + pruning; see configs/hparams_search/)")  # fmt: skip
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="Device to run the model on")
        p.add_argument("--verbose", "-v", action="store_true", help="Log at INFO level")


def _add_web(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("web", help="Launch the web UI (needs gradio)")
    p.add_argument("--port", type=int, default=7860, help="HTTP port for the web UI")
    p.add_argument("--checkpoint", type=Path, default=None, help="Port checkpoint (torch.save of a state_dict)")
    p.add_argument("--torch-checkpoint", type=Path, default=None, help="Reference torch checkpoint to convert")
    p.add_argument("--random-init", action="store_true", help="Run with UNTRAINED weights (demo only)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="Device to run the model on")


def _add_host(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("encode", help="Encode FASTQ(s) to parquet datasets")
    p.add_argument("paths", type=Path, nargs="+", help="FASTQ files or folders of FASTQs")
    p.add_argument("--chunk", action="store_true", help="Write chunked parquet")
    p.add_argument("--chunk-size", type=int, default=1_000_000, help="Records per parquet chunk with --chunk")

    p = sub.add_parser("stat", help="Read-length summary for FASTQ/FASTA/BAM")
    p.add_argument("path", type=Path, help="FASTQ/FASTA/BAM file to summarize")

    p = sub.add_parser("eval-bam", help="BAM overlap evaluation of predictions")
    p.add_argument("bam", type=Path, help="Aligned BAM of the ORIGINAL (unchopped) reads")
    p.add_argument("predicts", type=Path, help="Prediction shard dir")
    p.add_argument("--output-dir", type=Path, default=Path("."), help="Where stats_*.json / overlap_results_*.json land")
    p.add_argument("--blat-cli", default=None, help="Path to the blat binary (enables BLAT categories)")
    p.add_argument("--hg38-2bit", default=None, help="Reference genome .2bit for BLAT")
    p.add_argument("--internal-threshold", type=float, default=0.9, help="Fraction of read length above which an interval counts as terminal")
    p.add_argument("--overlap-threshold", type=float, default=0.5, help="Minimum softclip/interval overlap fraction")
    p.add_argument("--min-mapping-quality", type=int, default=0, help="Skip alignments below this MAPQ")

    tools = sub.add_parser("tools", help="Developer utilities (reference dev binaries)")
    tsub = tools.add_subparsers(dest="tool", required=True)

    t = tsub.add_parser("fq2fa", help="FASTQ -> FASTA on stdout")
    t.add_argument("fq", type=Path)

    t = tsub.add_parser("fqsearch", help="Search reads by id substring / length")
    t.add_argument("fq", type=Path)
    t.add_argument("--id", dest="id_substring", default=None)
    t.add_argument("--min-len", type=int, default=None)
    t.add_argument("--max-len", type=int, default=None)

    t = tsub.add_parser("select", help="Select chopped reads by type annotation")
    t.add_argument("fq", type=Path)
    t.add_argument("--type", dest="chop_type", default="internal", choices=["terminal", "internal"])
    t.add_argument("--output", "-o", type=Path, default=None)

    t = tsub.add_parser("diff", help="Compare original vs chopped FASTQ lengths")
    t.add_argument("original", type=Path)
    t.add_argument("chopped", type=Path)

    t = tsub.add_parser("chimericstat", help="Count primary mapped reads with SA tags")
    t.add_argument("bam", type=Path)

    t = tsub.add_parser("sa", help="SA-tag supplementary alignment histogram")
    t.add_argument("bam", type=Path)

    t = tsub.add_parser("scdiff", help="Compare softclips between two BAMs")
    t.add_argument("original", type=Path)
    t.add_argument("chopped", type=Path)

    t = tsub.add_parser("replacefq", help="Replace records by id from another FASTQ")
    t.add_argument("target", type=Path)
    t.add_argument("replacement", type=Path)
    t.add_argument("output", type=Path)

    t = tsub.add_parser("replacebam", help="Swap internal-chopped records between BAMs")
    t.add_argument("--dcbam", type=Path, required=True, help="DeepChopper-processed BAM")
    t.add_argument("--dobam", type=Path, required=True, help="Original BAM")
    t.add_argument("--output", "-o", type=Path, required=True)
    t.add_argument("--threads", "-t", type=int, default=4)

    t = tsub.add_parser("psl-top1", help="Top-1 identity summary of a PSL file")
    t.add_argument("psl", type=Path)

    t = tsub.add_parser("blat-predictions", help="Batch-BLAT predicted adapter seqs")
    t.add_argument("predicts", type=Path, nargs="+", help="Prediction shard dirs/files")
    t.add_argument("--prefix", "-p", default="")
    t.add_argument("--sr", dest="selected_reads", type=Path, default=None)
    t.add_argument("--fq", dest="fastq", type=Path, default=None)
    t.add_argument("--smooth-window", "-s", type=int, default=21)
    t.add_argument("--min-interval-size", "--mis", type=int, default=13)
    t.add_argument("--approved-intervals", "-a", type=int, default=20)
    t.add_argument("--max-process-intervals", "--mpi", type=int, default=4)
    t.add_argument("--blat-cli", default=None)
    t.add_argument("--hg38-2bit", default=None)

    t = tsub.add_parser("encode-smoke", help="Tensor-encode a FASTQ and print shapes")
    t.add_argument("fq", type=Path)
    t.add_argument("--max-reads", type=int, default=100)


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
    _add_web(sub)
    _add_host(sub)
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


def sweep(args: argparse.Namespace):
    """Run `train --sweep` for parsed arguments; returns the trials, best
    first. Raises DeviceUnavailable when the device is missing, before any
    trial, and ValueError inside a launcher's ranks (the sweep starts each
    trial's ranks itself)."""
    from .device import resolve_device
    from .parallel import launched_world
    from .train.config import read_yaml
    from .train.sweep import run_sweep

    if launched_world() > 1:
        raise ValueError(
            "train --sweep starts each trial's ranks itself (trainer.n_devices): run it without a launcher"
        )
    cfg = train_config(args)
    resolve_device(cfg.device)
    spec = read_yaml(Path(args.sweep).read_text())
    return run_sweep(
        cfg,
        {k: str(v) for k, v in (spec.get("params") or {}).items()},
        n_trials=int(spec.get("n_trials", 10)),
        optimized_metric=spec.get("optimized_metric", "best_val_f1"),
        direction=spec.get("direction", "maximize"),
        sampler=spec.get("sampler", "tpe"),
        n_startup_trials=int(spec.get("n_startup_trials", 5)),
        pruning=bool(spec.get("pruning", True)),
        monitor=spec.get("monitor"),
        monitor_mode=spec.get("monitor_mode"),
        min_resource=int(spec.get("min_resource", 1)),
        reduction_factor=int(spec.get("reduction_factor", 3)),
        output_dir=Path(cfg.output_dir) / "sweep",
    )


def cmd_train(args: argparse.Namespace) -> int:
    from .device import DeviceUnavailable
    from .train.loop import on_ranks, train

    try:
        if args.sweep is not None:
            trials = sweep(args)
            best = trials[0] if trials else None
            print(f"sweep done: best={best.metric if best else None} {best.overrides if best else {}}")
            return 0
        metrics = on_ranks(train, train_config(args))
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    if metrics is not None:
        print(f"train done: {metrics}")
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    from .device import DeviceUnavailable
    from .train.loop import evaluate, on_ranks

    try:
        metrics = on_ranks(evaluate, train_config(args))
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    if metrics is not None:
        print(f"eval done: {metrics}")
    return 0


def cmd_web(args: argparse.Namespace) -> int:
    """Serve the single-record UI; exits 1 without gradio (as the JAX
    package's `web`), 2 without the device."""
    from .device import DeviceUnavailable, resolve_device
    from .ui.main import launch

    try:
        resolve_device(args.device)
        launch(port=args.port, checkpoint=args.checkpoint, torch_checkpoint=args.torch_checkpoint,
               random_init=args.random_init, device=args.device)  # fmt: skip
    except DeviceUnavailable as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    except ImportError as exc:
        print(f"web UI unavailable: {exc}", file=sys.stderr)
        return 1
    return 0


def cmd_encode(args: argparse.Namespace) -> int:
    from .io.parquet import encode_fq_path_to_parquet, encode_fq_path_to_parquet_chunk

    for path in args.paths:
        if args.chunk:
            out = encode_fq_path_to_parquet_chunk(path, chunk_size=args.chunk_size)
        else:
            out = encode_fq_path_to_parquet(path)
        print(f"encoded {path} -> {out}")
    return 0


def cmd_stat(args: argparse.Namespace) -> int:
    from .utils.stat import summary_record_len

    lens = summary_record_len(args.path)
    import numpy as np

    arr = np.asarray(lens)
    print(
        f"{args.path}: n={arr.size} min={arr.min()} p50={int(np.median(arr))} "
        f"mean={arr.mean():.1f} max={arr.max()}"
    )
    return 0


def cmd_eval_bam(args: argparse.Namespace) -> int:
    from .eval import OverlapOptions, collect_overlap_results_for_predicts

    opts = OverlapOptions(
        internal_threshold=args.internal_threshold,
        overlap_threshold=args.overlap_threshold,
        min_mapping_quality=args.min_mapping_quality,
        blat_cli=args.blat_cli,
        hg38_2bit=args.hg38_2bit,
    )
    results = collect_overlap_results_for_predicts(
        args.bam, args.predicts, opts, output_dir=args.output_dir
    )
    for key in sorted(results):
        print(f"{key}: {len(results[key])}")
    return 0


def cmd_tools(args: argparse.Namespace) -> int:
    from . import tools

    if args.tool == "fq2fa":
        tools.fq2fa(args.fq)
    elif args.tool == "fqsearch":
        for rec in tools.fqsearch(args.fq, args.id_substring, args.min_len, args.max_len):
            sys.stdout.buffer.write(rec.to_bytes())
    elif args.tool == "select":
        hits = tools.select_by_chop_type(args.fq, args.chop_type, args.output)
        print(f"selected {len(hits)} {args.chop_type} records", file=sys.stderr)
        if args.output is None:
            for rec in hits:
                sys.stdout.buffer.write(rec.to_bytes())
    elif args.tool == "diff":
        print(tools.diff_fq(args.original, args.chopped))
    elif args.tool == "chimericstat":
        s = tools.chimericstat(args.bam)
        print(f"total={s.total} primary_mapped={s.primary_mapped} with_sa={s.with_sa} ratio={s.ratio:.4f}")
    elif args.tool == "sa":
        print(tools.sa_summary(args.bam))
    elif args.tool == "scdiff":
        print(tools.scdiff(args.original, args.chopped))
    elif args.tool == "replacefq":
        n = tools.replacefq(args.target, args.replacement, args.output)
        print(f"replaced {n} records -> {args.output}")
    elif args.tool == "replacebam":
        n = tools.replacebam(args.dcbam, args.dobam, args.output, args.threads)
        print(f"replaced {n} internal records -> {args.output}")
    elif args.tool == "psl-top1":
        print(tools.psl_top1_summary(args.psl))
    elif args.tool == "blat-predictions":
        from .eval.blat import blat_predictions

        res = blat_predictions(
            list(args.predicts),
            prefix=args.prefix,
            selected_reads=args.selected_reads,
            fastq=args.fastq,
            smooth_window_size=args.smooth_window,
            min_interval_size=args.min_interval_size,
            approved_interval_number=args.approved_intervals,
            max_process_intervals=args.max_process_intervals,
            blat_cli=args.blat_cli,
            hg38_2bit=args.hg38_2bit,
        )
        print(res)
    elif args.tool == "encode-smoke":
        print(tools.encode_smoke(args.fq, args.max_reads))
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if getattr(args, "verbose", False) else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from .utils.pylogger import suppress_warnings

    suppress_warnings(verbose=getattr(args, "verbose", False))
    handlers = {
        "predict": cmd_predict,
        "chop": cmd_chop,
        "train": cmd_train,
        "eval": cmd_eval,
        "web": cmd_web,
        "encode": cmd_encode,
        "stat": cmd_stat,
        "eval-bam": cmd_eval_bam,
        "tools": cmd_tools,
    }
    return handlers[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
