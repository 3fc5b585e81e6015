"""Port gated conv (deepchopper_tpu_torch.ops.gated) vs the JAX gated conv.

On CPU tensors the port's `gated_fft_conv_bm` runs its plain PyTorch version;
it is held to the JAX op `gated_fft_conv_cm` in interpret mode at float32
DFT precision, on both Pallas twins: `_gated_kernel` (the default layout)
and `_gated_kernel_v2` (DEEPCHOPPER_FFT_LAYOUT=v2, which needs 8 batch rows
a block). The port is batch-major, the JAX op channel-major: outputs are
compared transposed. Widths 256, 768 and 1280 give the JAX side N = 512
(pow2), 1536 (radix 3) and 2560 (radix 5). Tolerances: f32 forward and
gradients (against `jax.vjp`, whose backward is XLA's `_gated_bwd`) within
1e-5 of max|ref| (FFT rounding only); bfloat16 I/O within 1e-2 of max|ref|
(the output rounds to bf16, 2^-8 relative, and JAX's Pallas kernels also
round v * x1 to bf16 before the conv, which the port does not).

The CUDA kernel itself runs only on the card (tests/test_torch_port_cuda.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu.ops import pallas_fft
from deepchopper_tpu_torch.ops import gated as port

REL_TOL = 1e-5


def _inputs(batch: int, d_model: int, seq_len: int, seed: int):
    """uc (B, 3D, L) batch-major, k_long (L, D), bias (D,), dy (B, D, L)."""
    rng = np.random.default_rng(seed)
    uc = rng.standard_normal((batch, 3 * d_model, seq_len)).astype(np.float32)
    k_long = (rng.standard_normal((seq_len, d_model)) * np.exp(-np.arange(seq_len) / 40.0)[:, None]).astype(np.float32)
    bias = rng.standard_normal(d_model).astype(np.float32)
    dy = rng.standard_normal((batch, d_model, seq_len)).astype(np.float32)
    return uc, k_long, bias, dy


def _jax_gated(uc_bm, k_long, bias):
    """JAX gated conv on a batch-major uc; returns batch-major (B, D, L)."""
    uc_cm = jnp.transpose(jnp.asarray(uc_bm), (1, 0, 2))
    k, b = jnp.asarray(k_long), jnp.asarray(bias)
    out = pallas_fft.gated_fft_conv_cm(uc_cm, k, b, interpret=True, precision="float32")
    return jnp.transpose(out, (1, 0, 2))


def _assert_close(got: np.ndarray, ref: np.ndarray, tol: float = REL_TOL, what: str = "") -> None:
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{what} max-abs err {err:.3e} vs max|ref| {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("seq_len", [256, 768, 1280])
def test_port_gated_matches_jax_v1(seq_len):
    uc, k_long, bias, _dy = _inputs(2, 8, seq_len, seed=seq_len)
    ref = np.asarray(_jax_gated(uc, k_long, bias))
    got = port.gated_fft_conv_bm(*(torch.from_numpy(a) for a in (uc, k_long, bias)))
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("seq_len", [256, 768, 1280])
def test_port_gated_matches_jax_v2(seq_len, monkeypatch):
    """The v2 block layout computes the same function: the port's one kernel
    stands for both twins."""
    monkeypatch.setenv("DEEPCHOPPER_FFT_LAYOUT", "v2")
    calls = []
    v2 = pallas_fft._gated_conv_cm_impl_v2

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return v2(*args, **kwargs)

    monkeypatch.setattr(pallas_fft, "_gated_conv_cm_impl_v2", spy)
    uc, k_long, bias, _dy = _inputs(8, 4, seq_len, seed=seq_len + 1)
    ref = np.asarray(_jax_gated(uc, k_long, bias))
    assert calls, "the JAX op did not take the v2 layout"
    got = port.gated_fft_conv_bm(*(torch.from_numpy(a) for a in (uc, k_long, bias)))
    _assert_close(got.numpy(), ref)


def test_port_gated_bf16_io_matches_jax():
    uc, k_long, bias, _dy = _inputs(2, 4, 512, seed=7)
    uc16 = jnp.asarray(uc, jnp.bfloat16)
    ref = _jax_gated(uc16, k_long, bias)
    assert ref.dtype == jnp.bfloat16
    got = port.gated_fft_conv_bm(torch.from_numpy(np.array(uc16.astype(jnp.float32))).bfloat16(),
                                 torch.from_numpy(k_long), torch.from_numpy(bias))  # fmt: skip
    assert got.dtype == torch.bfloat16
    _assert_close(got.float().numpy(), np.asarray(ref, np.float32), tol=1e-2)


@pytest.mark.parametrize("seq_len", [256, 768])
def test_port_gated_gradients_match_jax_vjp(seq_len):
    uc, k_long, bias, dy = _inputs(2, 4, seq_len, seed=seq_len + 2)
    _, vjp = jax.vjp(_jax_gated, jnp.asarray(uc), jnp.asarray(k_long), jnp.asarray(bias))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (uc, k_long, bias)]
    out = port.gated_fft_conv_bm(*leaves)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(dy))
    for name, leaf, w in zip(("duc", "dk_long", "dbias"), leaves, want):
        _assert_close(leaf.grad.numpy(), w, what=name)


def test_gated_bwd_reference_matches_autograd_of_plain_forward():
    uc, k_long, bias, dy = (torch.from_numpy(a) for a in _inputs(2, 4, 300, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (uc, k_long, bias)]
    port.gated_reference(*leaves).backward(dy)
    got = port.gated_bwd_reference(uc, dy, k_long, bias)
    for leaf, g in zip(leaves, got):
        assert g.dtype == leaf.grad.dtype and g.shape == leaf.grad.shape
        assert (g - leaf.grad).abs().max() <= 1e-5 * leaf.grad.abs().max()


def test_wrapper_takes_plain_version_only_on_cpu():
    uc, k_long, bias = (torch.from_numpy(a) for a in _inputs(1, 4, 256, seed=0)[:3])
    port.reset_launch_counts()
    out = port.gated_fft_conv_bm(uc, k_long, bias)
    assert out.shape == (1, 4, 256) and port.launch_counts["gated_fwd"] == 0
    with pytest.raises(ValueError, match="no implementation"):
        port.gated_fft_conv_bm(uc.to("meta"), k_long, bias)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.gated_fwd_cuda(uc, k_long, bias)
