"""deepchopper_tpu_torch — DeepChopper in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of `deepchopper_tpu` (JAX/Pallas) that keeps its module names, its
file contracts and its numerics. It imports nothing of the JAX package: the
host-side pieces it needs are trimmed copies. It covers `predict`, `train`
and `eval` on the Hyena token classifiers.

Importing the package starts nothing and builds nothing: CUDA kernels are
compiled with `nvcc` on their first launch (see `ops/_build.py`).
"""

from __future__ import annotations

__version__ = "0.1.0"
