"""Port mixer (deepchopper_tpu_torch.ops.mixer) vs the JAX mixer.

On CPU tensors the port's `mixer_fft_conv_bm` runs its plain PyTorch
version; it is held to the JAX Pallas kernel (interpret mode, float32 DFT
precision) and to `mixer_reference_xla`. Widths 256, 768 and 1280 give the
JAX side N = 512 (pow2), 1536 (radix 3) and 2560 (radix 5). Tolerance: f32
max-abs error <= 1e-5 * max|ref| (FFT rounding only).

The CUDA kernel itself runs only on the card (tests/test_torch_port_cuda.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepchopper_tpu.ops.pallas_fft import mixer_fft_conv_bm as jax_mixer_bm
from deepchopper_tpu.ops.pallas_fft import mixer_reference_xla
from deepchopper_tpu_torch.ops import mixer as port

REL_TOL = 1e-5


def _inputs(batch: int, d_model: int, seq_len: int, seed: int):
    rng = np.random.default_rng(seed)
    proj_bm = rng.standard_normal((batch, 3 * d_model, seq_len)).astype(np.float32)
    k_short = rng.standard_normal((3, 1, 3 * d_model)).astype(np.float32)
    b_short = rng.standard_normal(3 * d_model).astype(np.float32)
    k_long = (
        rng.standard_normal((seq_len, d_model)) * np.exp(-np.arange(seq_len) / 40.0)[:, None]
    ).astype(np.float32)
    bias = rng.standard_normal(d_model).astype(np.float32)
    return proj_bm, k_short, b_short, k_long, bias


def _port(args) -> np.ndarray:
    return port.mixer_fft_conv_bm(*(torch.from_numpy(a) for a in args)).numpy()


def _assert_close(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), f"max-abs err {err:.3e} vs max|ref| {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("seq_len", [256, 768, 1280])
def test_port_mixer_matches_jax_pallas_interpret(seq_len):
    args = _inputs(batch=2, d_model=8, seq_len=seq_len, seed=seq_len)
    ref = np.asarray(
        jax_mixer_bm(*(jnp.asarray(a) for a in args), interpret=True, precision="float32")
    )
    _assert_close(_port(args), ref)


@pytest.mark.parametrize("seq_len", [256, 768, 1280])
def test_port_mixer_matches_jax_reference(seq_len):
    args = _inputs(batch=2, d_model=64, seq_len=seq_len, seed=seq_len + 1)
    proj_cm = jnp.transpose(jnp.asarray(args[0]), (1, 0, 2))
    ref = np.asarray(mixer_reference_xla(proj_cm, *(jnp.asarray(a) for a in args[1:])))
    _assert_close(_port(args), ref.transpose(1, 0, 2))


@pytest.mark.parametrize("seq_len", [256, 768])
def test_plain_mixer_ignores_trailing_zeros(seq_len):
    """Causal: zeros appended after the sequence (FFT at 4L) change only
    rounding before it."""
    proj, ks, bs, k_long, bias = (torch.from_numpy(a) for a in _inputs(2, 8, seq_len, seed=seq_len + 2))
    at_2l = port.mixer_reference(proj, ks, bs, k_long, bias).numpy()
    padded = port.mixer_reference(
        F.pad(proj, (0, seq_len)), ks, bs, F.pad(k_long, (0, 0, 0, seq_len)), bias
    )
    _assert_close(padded[..., :seq_len].numpy(), at_2l)


@pytest.mark.parametrize("seq_len", [2, 3, 256, 300, 1024])
def test_fft_size_is_pow2_and_holds_linear_conv(seq_len):
    n = port.fft_size(seq_len)
    assert n & (n - 1) == 0 and n >= 2 * seq_len and n >= 8
    assert n < 4 * seq_len or n == 8


def test_filter_spectrum_folds_bias_and_scale():
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    n = port.fft_size(16)
    spec = port.filter_spectrum(k, b, n)
    assert spec.shape == (4, n // 2 + 1) and spec.dtype == torch.complex64
    back = torch.fft.irfft(spec * n, n=n, dim=-1)
    want = k.T.clone()
    want[:, 0] += b
    np.testing.assert_allclose(back[:, :16].numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(back[:, 16:].numpy(), 0.0, atol=1e-5)


def test_wrapper_takes_plain_version_only_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(1, 4, 256, 0)]
    port.reset_launch_counts()
    out = port.mixer_fft_conv_bm(*args)
    assert out.shape == (1, 4, 256) and port.launch_counts["mixer_fwd"] == 0
    with pytest.raises(ValueError, match="no implementation"):
        port.mixer_fft_conv_bm(args[0].to("meta"), *args[1:])
