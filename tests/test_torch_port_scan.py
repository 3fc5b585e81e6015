"""Port selective scan (deepchopper_tpu_torch.ops.scan) vs the JAX package's
Pallas scan in interpret mode, on the CPU.

Inputs are made by numpy from a seed and handed to both packages. The port's
plain versions run here (the CUDA kernels are held to them on the card by
`tests/test_torch_port_cuda.py` and `chip_smoke.py`). Tolerances: the forward
and all six gradients within 1e-5 of the reference's max|.|: float32 sums
taken in another order over a contracting recurrence (measured <= 4.9e-7).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu.ops.pallas_scan import selective_scan_pallas, selective_scan_pallas_bwd
from deepchopper_tpu_torch.ops import scan

TOL = 1e-5


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


def _sequential(u, delta, A, Bp, Cp, D, reverse):
    """The literal recurrence in float64: y and the state after every step."""
    batch, seq_len, d_in = u.shape
    h = np.zeros((batch, d_in, A.shape[1]))
    y, states = np.zeros(u.shape), np.zeros((batch, seq_len, d_in, A.shape[1]))
    for t in range(seq_len - 1, -1, -1) if reverse else range(seq_len):
        h = np.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * u[:, t])[:, :, None] * Bp[:, t, None, :]
        y[:, t] = (h * Cp[:, t, None, :]).sum(-1) + D * u[:, t]
        states[:, t] = h
    return y, states


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("shape", [(2, 96, 8, 4), (1, 256, 16, 8), (3, 130, 8, 4)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("jax_chunk", [32, 64])
def test_plain_scan_matches_pallas_interpret(shape, reverse, jax_chunk):
    u, delta, A, Bp, Cp, D, _dy = _inputs(*shape, seed=shape[1])
    want = np.asarray(selective_scan_pallas(*(jnp.asarray(x) for x in (u, delta, A, Bp, Cp, D)),
                                            chunk=jax_chunk, reverse=reverse, interpret=True))  # fmt: skip
    for chunk in (None, 7, jax_chunk):
        got = scan.selective_scan_reference(*(torch.from_numpy(x) for x in (u, delta, A, Bp, Cp, D)), reverse, chunk)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape[:3]
        assert _rel(got, want) <= TOL, (chunk, _rel(got, want))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(3, 200, 12, 4), (2, 64, 16, 8)])
def test_plain_backward_matches_pallas_bwd_interpret(shape, reverse):
    """L = 200 is ragged against the JAX kernel's chunk 64 and the port's 32."""
    args = _inputs(*shape, seed=7)
    want = selective_scan_pallas_bwd(*(jnp.asarray(x) for x in args), chunk=64, reverse=reverse, interpret=True)
    for chunk in (None, 24):
        got = scan.scan_bwd_reference(*(torch.from_numpy(x) for x in args), reverse, chunk)
        for name, g, w in zip(("du", "ddelta", "dA", "dBp", "dCp", "dD"), got, want):
            assert tuple(g.shape) == tuple(w.shape), name
            assert _rel(g, w) <= TOL, (name, chunk, _rel(g, w))


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_checkpoints_are_the_chunk_entry_states(reverse):
    u, delta, A, Bp, Cp, D, _dy = _inputs(2, 75, 8, 4, seed=3)
    _y, states = _sequential(u, delta, A, Bp, Cp, D, reverse)
    ck = scan.scan_ckpt_reference(*(torch.from_numpy(x) for x in (u, delta, A, Bp)), reverse).numpy()
    nl = -(-75 // scan.CKPT_CHUNK)
    assert ck.shape == (2, nl, 4, 8)
    for c in range(nl):
        # Entering chunk c forward: the state after t = 32c - 1; reverse: after t = 32(c+1).
        t = (c + 1) * scan.CKPT_CHUNK if reverse else c * scan.CKPT_CHUNK - 1
        want = states[:, t].transpose(0, 2, 1) if 0 <= t < 75 else np.zeros((2, 4, 8))
        np.testing.assert_allclose(ck[:, c], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_fn_is_differentiable_on_the_cpu_without_launches(reverse):
    args = [torch.from_numpy(x) for x in _inputs(2, 50, 8, 4, seed=11)]
    leaves = [t.clone().requires_grad_(True) for t in args[:6]]
    scan.reset_launch_counts()
    y = scan.selective_scan(*leaves, reverse=reverse)
    assert y.grad_fn is not None
    y.backward(args[6])
    assert scan.launch_counts == {"scan_fwd": 0, "scan_ckpt": 0, "scan_bwd": 0}
    want_y, _states = _sequential(*(a.numpy() for a in args[:6]), reverse)
    assert _rel(y.detach(), want_y) <= TOL
    for leaf, want in zip(leaves, scan.scan_bwd_reference(*args, reverse)):
        torch.testing.assert_close(leaf.grad, want, rtol=0, atol=0)


def test_scan_refuses_other_devices_and_the_wrappers_refuse_cpu_tensors():
    meta = [torch.empty(1, 4, 8, device="meta"), torch.empty(1, 4, 8, device="meta"), torch.empty(8, 4, device="meta"),
            torch.empty(1, 4, 4, device="meta"), torch.empty(1, 4, 4, device="meta"), torch.empty(8, device="meta")]  # fmt: skip
    with pytest.raises(ValueError, match="no implementation"):
        scan.selective_scan(*meta)
    u, delta, A, Bp, Cp, D, _dy = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 4, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D)
    with pytest.raises(ValueError, match="CUDA"):
        scan.scan_ckpt_cuda(u, delta, A, Bp)
