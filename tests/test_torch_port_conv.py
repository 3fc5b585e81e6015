"""Port causal conv (deepchopper_tpu_torch.ops.conv) vs the JAX causal conv.

On CPU tensors the port's `fft_causal_conv` runs its plain PyTorch version;
it is held to the JAX op `fft_causal_conv_pallas` (interpret mode, float32
DFT precision; its backward is XLA's `_conv_bwd`) and to the stock-FFT
`models.hyena.fft_causal_conv`. Widths 256, 768 and 1280 give the JAX side
N = 512 (pow2), 1536 (radix 3) and 2560 (radix 5). Tolerance: forward and
gradients within 1e-5 of max|ref| (FFT rounding only).

The CUDA kernel itself runs only on the card (tests/test_torch_port_cuda.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu.models.hyena import fft_causal_conv as jax_fft_causal_conv
from deepchopper_tpu.ops.pallas_fft import fft_causal_conv_pallas
from deepchopper_tpu_torch.models import hyena as port_hyena
from deepchopper_tpu_torch.ops import conv as port

REL_TOL = 1e-5


def _inputs(batch: int, seq_len: int, d_model: int, seed: int):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((batch, seq_len, d_model)).astype(np.float32)
    k = (rng.standard_normal((seq_len, d_model)) * np.exp(-np.arange(seq_len) / 40.0)[:, None]).astype(np.float32)
    bias = rng.standard_normal(d_model).astype(np.float32)
    dy = rng.standard_normal((batch, seq_len, d_model)).astype(np.float32)
    return v, k, bias, dy


def _jax_conv(v, k, bias):
    return fft_causal_conv_pallas(v, k, bias, interpret=True, precision="float32")


def _assert_close(got: np.ndarray, ref: np.ndarray, what: str = "") -> None:
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), f"{what} max-abs err {err:.3e} vs max|ref| {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("seq_len", [256, 768, 1280])
def test_port_conv_matches_jax_pallas_interpret(seq_len):
    v, k, bias, _dy = _inputs(2, seq_len, 8, seed=seq_len)
    ref = np.asarray(_jax_conv(jnp.asarray(v), jnp.asarray(k), jnp.asarray(bias)))
    got = port.fft_causal_conv(*(torch.from_numpy(a) for a in (v, k, bias)))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("seq_len", [256, 300])
def test_port_conv_matches_jax_stock_fft(seq_len):
    v, k, bias, _dy = _inputs(3, seq_len, 16, seed=seq_len + 1)
    ref = np.asarray(jax_fft_causal_conv(jnp.asarray(v), jnp.asarray(k), jnp.asarray(bias)))
    _assert_close(port.fft_causal_conv(*(torch.from_numpy(a) for a in (v, k, bias))).numpy(), ref)


@pytest.mark.parametrize("seq_len", [256, 768])
def test_port_conv_gradients_match_jax_vjp(seq_len):
    v, k, bias, dy = _inputs(2, seq_len, 4, seed=seq_len + 2)
    _, vjp = jax.vjp(_jax_conv, jnp.asarray(v), jnp.asarray(k), jnp.asarray(bias))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (v, k, bias)]
    out = port.fft_causal_conv(*leaves)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(dy))
    for name, leaf, w in zip(("dv", "dk", "dbias"), leaves, want):
        _assert_close(leaf.grad.numpy(), w, what=name)


def test_conv_bwd_reference_matches_autograd_of_plain_forward():
    v, k, bias, dy = (torch.from_numpy(a) for a in _inputs(2, 300, 4, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (v, k, bias)]
    port.conv_reference(*leaves).backward(dy)
    for leaf, g in zip(leaves, port.conv_bwd_reference(v, dy, k, bias)):
        assert g.dtype == leaf.grad.dtype and g.shape == leaf.grad.shape
        assert (g - leaf.grad).abs().max() <= 1e-5 * leaf.grad.abs().max()


def test_causal_conv_op_is_the_ungated_gated_conv():
    """`models.hyena.causal_conv` is the public op; with both gates at one the
    gated conv computes the same function."""
    from deepchopper_tpu_torch.ops import gated

    v, k, bias, _dy = (torch.from_numpy(a) for a in _inputs(2, 300, 4, seed=6))
    y = port_hyena.causal_conv(v, k, bias)
    ones = torch.ones(2, 4, 300)
    via_gated = gated.gated_fft_conv_bm(torch.cat([ones, ones, v.transpose(1, 2)], dim=1), k, bias).transpose(1, 2)
    assert (y - via_gated).abs().max() <= REL_TOL * via_gated.abs().max()
    assert port_hyena.causal_conv(v.double(), k, bias).dtype == torch.float32


def test_wrapper_takes_plain_version_only_on_cpu():
    v, k, bias = (torch.from_numpy(a) for a in _inputs(1, 256, 4, seed=0)[:3])
    port.reset_launch_counts()
    out = port.fft_causal_conv(v, k, bias)
    assert out.shape == (1, 256, 4) and port.launch_counts["conv_fwd"] == 0
    with pytest.raises(ValueError, match="no implementation"):
        port.fft_causal_conv(v.to("meta"), k, bias)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.conv_fwd_cuda(v, k, bias)
