"""How the port's selective scan takes every shape on the card, vs the JAX package.

The CUDA kernels take N in {8, 16} and Din a multiple of 256 / N. The JAX
package computes every shape (`models/caduceus.py:96`,
`dispatch_selective_scan`; its TPU kernel pads L and the batch), so the
port's wrapper brings any other shape to launches the kernels take
(`ops/scan.scan_kernel_groups`): Din padded with idle channels, N padded to
8 or 16 with idle states, N above 16 split into groups of 16 states. Here,
on the CPU, the rule's table is checked, every registry Caduceus model is
shown to need no padding, and the kernel path (`scan_fwd_kernels`,
`scan_bwd_kernels`) is run forward and backward with the CUDA entries
stubbed by the plain versions: each stub must be called once per state
group with a shape the kernels take, and y and the six gradients must agree
with the JAX package's scan and its autograd within 1e-5 of each one's
max|ref| (float32 sums in another order, as tests/test_torch_port_scan.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.caduceus import dispatch_selective_scan
from deepchopper_tpu_torch.models.registry import MODEL_REGISTRY, build_model
from deepchopper_tpu_torch.ops import scan

TOL = 1e-5


@pytest.mark.parametrize(
    "n,d_in,want",
    [(16, 512, (16, 1, 512)), (8, 128, (8, 1, 128)), (16, 48, (16, 1, 48)), (8, 96, (8, 1, 96)),
     (32, 128, (16, 2, 128)), (16, 72, (16, 1, 80)), (8, 72, (8, 1, 96)), (4, 64, (8, 1, 64)),
     (16, 40, (16, 1, 48)), (24, 96, (16, 2, 96)), (33, 20, (16, 3, 32)), (1, 1, (8, 1, 32))],
)  # fmt: skip
def test_scan_route_table(n, d_in, want):
    assert scan.scan_kernel_groups(n, d_in) == want
    assert scan.scan_kernel_shape(n, d_in) == (n in (8, 16) and d_in % (256 // n) == 0)
    assert scan.scan_kernel_shape(n, d_in) == (want == (n, 1, d_in))


def test_registry_caduceus_models_stay_on_the_kernels():
    names = [name for name in MODEL_REGISTRY if name.startswith("caduceus")]
    assert len(names) == 4
    for name in names:
        cfg = build_model(name).backbone_config
        d_in = cfg.expand * cfg.d_model
        assert scan.scan_kernel_groups(cfg.d_state, d_in) == (cfg.d_state, 1, d_in), name


def _inputs(batch, seq_len, d_in, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((batch, seq_len, d_in)).astype(np.float32)
    delta = rng.uniform(0.01, 0.3, (batch, seq_len, d_in)).astype(np.float32)
    A = -rng.uniform(0.1, 2.0, (d_in, n)).astype(np.float32)
    Bp = rng.standard_normal((batch, seq_len, n)).astype(np.float32)
    Cp = rng.standard_normal((batch, seq_len, n)).astype(np.float32)
    D = rng.standard_normal(d_in).astype(np.float32)
    dy = rng.standard_normal((batch, seq_len, d_in)).astype(np.float32)
    return u, delta, A, Bp, Cp, D, dy


def _jax_scan(inputs, d_model: int, d_state: int, reverse: bool):
    """y and the six input gradients of the JAX package's own scan (off the
    TPU: its chunked associative scan) under the cotangent dy."""
    u, delta, A, Bp, Cp, D, dy = (jnp.asarray(x) for x in inputs)
    cfg = jax_config.CaduceusConfig(d_model=d_model, d_state=d_state)
    y, vjp = jax.vjp(lambda *a: dispatch_selective_scan(*a, cfg, reverse=reverse), u, delta, A, Bp, Cp, D)
    return np.asarray(y), [np.asarray(g) for g in vjp(dy)]


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize(
    "d_model,d_state",
    # Din 128 N 32 (two groups); Din 72 (padded to 80); Din 64 N 8 and Din 128 N 16 (as they are);
    # Din 40 N 4 (both padded); Din 96 N 24 (two groups, the second half idle)
    [(64, 32), (36, 16), (32, 8), (64, 16), (20, 4), (48, 24)],
)
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_dispatch_follows_the_shape(d_model, d_state, reverse, monkeypatch):
    calls = []

    def stub(name, plain):
        def fn(u, delta, A, Bp, *rest):
            assert scan.scan_kernel_shape(A.shape[1], u.shape[2]), (name, tuple(A.shape), tuple(u.shape))
            assert u.is_contiguous() and delta.is_contiguous() and Bp.stride(2) == 1, name
            calls.append(name)
            return plain(u, delta, A, Bp, *rest)

        return fn

    monkeypatch.setattr(scan, "scan_fwd_cuda", stub("scan_fwd", scan.selective_scan_reference))
    monkeypatch.setattr(scan, "scan_ckpt_cuda", stub("scan_ckpt", lambda u, delta, A, Bp, rev: None))
    monkeypatch.setattr(scan, "scan_bwd_cuda", stub("scan_bwd", lambda u, delta, A, Bp, Cp, D, dy, _ckpt, rev:
                                                    scan.scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, rev)))  # fmt: skip
    inputs = _inputs(2, 70, 2 * d_model, d_state, seed=d_model + d_state)
    u, delta, A, Bp, Cp, D, dy = (torch.from_numpy(x) for x in inputs)
    y = scan.scan_fwd_kernels(u, delta, A, Bp, Cp, D, reverse)
    grads = scan.scan_bwd_kernels(u, delta, A, Bp, Cp, D, dy, reverse)
    groups = scan.scan_kernel_groups(d_state, 2 * d_model)[1]
    assert calls == ["scan_fwd"] * groups + ["scan_ckpt", "scan_bwd"] * groups
    want_y, want_grads = _jax_scan(inputs, d_model, d_state, reverse)
    assert tuple(y.shape) == want_y.shape and _rel(y, want_y) <= TOL
    for name, got, want in zip(("du", "ddelta", "dA", "dBp", "dCp", "dD"), grads, want_grads):
        assert tuple(got.shape) == want.shape, name
        assert _rel(got, want) <= TOL, name


@pytest.mark.parametrize("d_model,d_state", [(64, 32), (36, 16)])
def test_selective_scan_on_cpu_runs_the_plain_versions(d_model, d_state, monkeypatch):
    """CPU tensors never reach the kernel path, whatever their shape."""
    for name in ("scan_fwd_kernels", "scan_bwd_kernels"):
        monkeypatch.setattr(scan, name, lambda *a, _n=name: pytest.fail(f"{_n} on CPU tensors"))
    inputs = _inputs(1, 40, 2 * d_model, d_state, seed=3)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs[:6]]
    y = scan.selective_scan(*leaves)
    y.backward(torch.from_numpy(inputs[6]))
    want_y, want_grads = _jax_scan(inputs, d_model, d_state, False)
    assert _rel(y.detach(), want_y) <= TOL
    for name, leaf, want in zip(("du", "ddelta", "dA", "dBp", "dCp", "dD"), leaves, want_grads):
        assert _rel(leaf.grad, want) <= TOL, name
