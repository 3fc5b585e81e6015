"""Card-only tests of the port's CUDA kernels (skip without a CUDA device).

This file imports no JAX, so it also runs where only PyTorch is installed:
    python -m pytest --noconftest tests/test_torch_port_cuda.py
Each kernel is held to its plain PyTorch version on the same inputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepchopper_tpu_torch.ops import mixer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(batch, d_model, seq_len, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.standard_normal((batch, 3 * d_model, seq_len)).astype(np.float32))
    k_short = torch.from_numpy(rng.standard_normal((3, 1, 3 * d_model)).astype(np.float32))
    b_short = torch.from_numpy(rng.standard_normal(3 * d_model).astype(np.float32))
    decay = np.exp(-np.arange(seq_len) / 40.0)[:, None]
    k_long = torch.from_numpy((rng.standard_normal((seq_len, d_model)) * decay).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(d_model).astype(np.float32))
    return proj.to(device, dtype), k_short.to(device), b_short.to(device), k_long.to(device), bias.to(device)


# 256..16384 run the shared-memory branch, 24576 and 32768 the global-scratch
# branch; 300 and 1000 are off-ladder widths (odd half-lengths).
@pytest.mark.parametrize("seq_len", [256, 300, 1000, 1280, 16384, 24576, 32768])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_mixer_kernel_matches_plain(cuda, seq_len, dtype, tol):
    args = _inputs(2, 8, seq_len, dtype, cuda, seed=seq_len)
    mixer.reset_launch_counts()
    got = mixer.mixer_fft_conv_bm(*args)
    torch.cuda.synchronize()
    assert mixer.launch_counts["mixer_fwd"] == 1
    ref = mixer.mixer_reference(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


def test_mixer_kernel_rejects_bad_shapes(cuda):
    proj, ks, bs, kl, bias = _inputs(1, 8, 256, torch.float32, cuda)
    with pytest.raises(ValueError):
        mixer.mixer_fft_conv_bm(proj[:, :20], ks, bs, kl, bias)
    with pytest.raises(ValueError):
        mixer.mixer_fft_conv_bm(proj.half(), ks, bs, kl, bias)


def _bwd_inputs(batch, d_model, seq_len, dtype, device, seed=0):
    proj, k_short, b_short, k_long, bias = _inputs(batch, d_model, seq_len, dtype, device, seed)
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((batch, d_model, seq_len)).astype(np.float32))
    return proj, dy.to(device, dtype), k_short, b_short, k_long, bias


# Same widths as the forward; B = 3 is odd, so the batch groups are uneven.
@pytest.mark.parametrize("seq_len", [256, 300, 1000, 1280, 16384, 24576, 32768])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_mixer_bwd_kernel_matches_plain(cuda, seq_len, dtype, tol):
    args = _bwd_inputs(3, 8, seq_len, dtype, cuda, seed=seq_len)
    mixer.reset_launch_counts()
    got = mixer.mixer_bwd_cuda(*args)
    again = mixer.mixer_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert mixer.launch_counts["mixer_bwd"] == 2
    ref = mixer.mixer_bwd_reference(*args)
    for g, a, r in zip(got, again, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, a)  # no atomics: bitwise repeatable
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


def test_gradient_through_mixer_fn_on_the_card(cuda):
    proj, dy, *params = _bwd_inputs(2, 16, 1024, torch.float32, cuda, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (proj, *params)]
    mixer.reset_launch_counts()
    out = mixer.mixer_fft_conv_bm(*leaves)
    assert out.grad_fn is not None
    out.backward(dy)
    torch.cuda.synchronize()
    assert mixer.launch_counts == {"mixer_fwd": 1, "mixer_bwd": 1}
    plain = [t.clone().requires_grad_(True) for t in (proj, *params)]
    mixer.mixer_reference(*plain).backward(dy)
    for leaf, want in zip(leaves, plain):
        assert (leaf.grad - want.grad).abs().max().item() <= 1e-4 * want.grad.abs().max().item()
