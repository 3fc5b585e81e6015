"""Streaming chop stage (the port's `deepchopper-chop`)."""

from .pipeline import (
    ChopOptions,
    ChopStats,
    multihost_stream_chop,
    predict_cli,
    process_chunk,
    run_chop,
    stream_chop_with_predicts,
)

__all__ = [
    "ChopOptions",
    "ChopStats",
    "multihost_stream_chop",
    "predict_cli",
    "process_chunk",
    "run_chop",
    "stream_chop_with_predicts",
]
