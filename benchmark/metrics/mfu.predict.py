"""The whole step's share of the card's bf16 peak, predict cells."""

from benchmark.metrics._shares import mfu


def read(run):
    return mfu(run, "predict")
