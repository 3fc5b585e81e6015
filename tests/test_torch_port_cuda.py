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


# -- selective scan (Caduceus) ------------------------------------------------------


def _scan_inputs(batch, seq_len, d_in, n, device, seed=0):
    """u, delta, A, Bp, Cp, D, dy; Bp and Cp sliced from one projection, as
    the mixer makes them."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    proj = f32(rng.standard_normal((batch, seq_len, 4 + 2 * n)))
    return (f32(rng.standard_normal((batch, seq_len, d_in))), f32(rng.uniform(0.01, 1.0, (batch, seq_len, d_in))),
            f32(-rng.uniform(0.1, 4.0, (d_in, n))), proj[..., 4 : 4 + n], proj[..., 4 + n :],
            f32(rng.standard_normal(d_in)), f32(rng.standard_normal((batch, seq_len, d_in))))  # fmt: skip


def _rel(got, want):
    """Max-abs error of max|want| (an all-zero want, as the checkpoints of a
    one-tile scan are, asks for an exact zero)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# (B, L, Din, N): N = 16 at the flagship's Din; N = 8 (the tiny configs);
# L = 1, 31, 33 and 1000 are ragged against the 32-step tiles.
SCAN_SHAPES = [(2, 1000, 512, 16), (3, 33, 64, 8), (1, 31, 128, 8), (2, 1, 64, 16), (4, 4096, 512, 16)]


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernels_match_plain(cuda, shape, reverse):
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, dy = _scan_inputs(*shape, cuda, seed=shape[1])
    scan.reset_launch_counts()
    y = scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse)
    ckpt = scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)
    grads = scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse)
    again = scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse)
    torch.cuda.synchronize()
    assert scan.launch_counts == {"scan_fwd": 1, "scan_ckpt": 1, "scan_bwd": 2}
    assert _rel(y, scan.selective_scan_reference(u, delta, A, Bp, Cp, D, reverse)) <= 1e-5
    assert _rel(ckpt, scan.scan_ckpt_reference(u, delta, A, Bp, reverse)) <= 1e-5
    want = scan.scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, reverse)
    for name, tol, g, a, w in zip(("du", "ddelta", "dA", "dBp", "dCp", "dD"), (1e-5, 1e-5, 1e-4, 1e-5, 1e-5, 1e-4),
                                  grads, again, want):  # fmt: skip
        assert torch.equal(g, a), name  # no atomics: bitwise repeatable
        assert _rel(g, w) <= tol, name


@pytest.mark.parametrize("reverse", [False, True])
def test_gradient_through_scan_fn_on_the_card(cuda, reverse):
    from deepchopper_tpu_torch.ops import scan

    *args, dy = _scan_inputs(2, 300, 64, 16, cuda, seed=5)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    scan.reset_launch_counts()
    y = scan.selective_scan(*leaves, reverse=reverse)
    assert y.grad_fn is not None
    y.backward(dy)
    torch.cuda.synchronize()
    assert scan.launch_counts == {"scan_fwd": 1, "scan_ckpt": 1, "scan_bwd": 1}
    for leaf, want in zip(leaves, scan.scan_bwd_reference(*args, dy, reverse)):
        assert _rel(leaf.grad, want) <= 1e-4


def test_scan_kernels_refuse_what_they_do_not_take(cuda):
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, _dy = _scan_inputs(1, 64, 64, 16, cuda)
    bad = {
        "d_state 4": (u, delta, A[:, :4], Bp[..., :4], Cp[..., :4], D),
        "Din not a multiple of 16": (u[..., :40], delta[..., :40], A[:40], Bp, Cp, D[:40]),
        "float64": (u.double(), delta, A, Bp, Cp, D),
        "non-contiguous u": (u[:, ::2], delta[:, ::2], A, Bp[:, ::2], Cp[:, ::2], D),
        "strided N": (u, delta, A, Bp.transpose(1, 2).contiguous().transpose(1, 2), Cp, D),
        "D on the CPU": (u, delta, A, Bp, Cp, D.cpu()),
    }
    for why, args in bad.items():
        with pytest.raises(ValueError):
            scan.scan_fwd_cuda(*args)
            pytest.fail(why)
