"""Share of device kernel time in PyTorch's own kernels, predict cells."""

from benchmark.metrics._shares import torch_ops_share


def read(run):
    return torch_ops_share(run, "predict")
