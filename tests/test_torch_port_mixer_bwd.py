"""Port mixer backward (deepchopper_tpu_torch.ops.mixer) vs the JAX backward.

`mixer_bwd_reference`, the plain version the CUDA kernel `csrc/mixer_bwd.cu`
is held to on the card, against the JAX Pallas backward `mixer_bwd_pallas`
(interpret mode, float32 DFT precision) at B = 3, D = 8 and L in {256, 768,
1280} (768 and 1280 give the JAX side mixed-radix N): every one of the five
gradients within 5e-5 * max(1, max|ref|), as tests/test_pallas_fft.py holds
the JAX kernel (measured: <= 7e-7). Against autograd of `mixer_reference`:
1e-5 (measured: <= 6e-7). dk_long and dbias are compared on their own, so a
slip in the half-spectrum cotangent cannot hide behind a right dproj.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu.ops.pallas_fft import mixer_bwd_pallas
from deepchopper_tpu_torch.ops import mixer as port

NAMES = ("dproj", "dk_short", "db_short", "dk_long", "dbias")


def _inputs(batch: int, d_model: int, seq_len: int, seed: int):
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((batch, 3 * d_model, seq_len)).astype(np.float32)
    dy = rng.standard_normal((batch, d_model, seq_len)).astype(np.float32)
    k_short = rng.standard_normal((3, 1, 3 * d_model)).astype(np.float32)
    b_short = rng.standard_normal(3 * d_model).astype(np.float32)
    k_long = (rng.standard_normal((seq_len, d_model)) * np.exp(-np.arange(seq_len) / 40.0)[:, None]).astype(
        np.float32
    )
    bias = rng.standard_normal(d_model).astype(np.float32)
    return proj, dy, k_short, b_short, k_long, bias


def _autograd_of_plain(proj, dy, *params):
    leaves = [t.clone().requires_grad_(True) for t in (proj, *params)]
    port.mixer_reference(*leaves).backward(dy)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("seq_len", [256, 768, 1280])
def test_bwd_reference_matches_jax_pallas_interpret(seq_len):
    args = _inputs(3, 8, seq_len, seed=seq_len)
    ref = mixer_bwd_pallas(*(jnp.asarray(a) for a in args), precision="float32", interpret=True)
    got = port.mixer_bwd_reference(*(torch.from_numpy(a) for a in args))
    for name, g, r in zip(NAMES, got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        err = np.abs(g.numpy() - r).max()
        assert err <= 5e-5 * max(1.0, np.abs(r).max()), f"{name}: err {err:.3e}, max|ref| {np.abs(r).max():.3e}"


@pytest.mark.parametrize("seq_len", [256, 300, 1280])
def test_bwd_reference_matches_autograd_of_plain_forward(seq_len):
    proj, dy, *params = (torch.from_numpy(a) for a in _inputs(2, 4, seq_len, seed=seq_len + 1))
    want = _autograd_of_plain(proj, dy, *params)
    got = port.mixer_bwd_reference(proj, dy, *params)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), name


@pytest.mark.parametrize("pow2", [False, True])
def test_gate_cotangents_hold_at_the_kernel_fft_size(pow2):
    """The kernel runs at N = nextpow2(2L), the plain version at 2L: the
    cotangents and the filter gradients agree at both sizes (a correlation
    is exact for any N >= 2L - 1)."""
    proj, dy, *params = (torch.from_numpy(a) for a in _inputs(2, 4, 300, seed=7))
    n = port.fft_size(300) if pow2 else 600
    dgates, dkhat = port._gate_cotangents_reference(proj, dy, *params, n)
    assert dgates.shape == (2, 12, 300) and dgates.dtype == torch.float32
    assert dkhat.shape == (4, n // 2 + 1) and dkhat.dtype == torch.complex64
    got = port._grads_from_cotangents(proj, dgates, dkhat, *params, n)
    want = _autograd_of_plain(proj, dy, *params)
    for name, g, w in zip(NAMES, got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), name


def test_mixer_fn_on_cpu_has_grad_fn_and_matches_autograd():
    """Regression: the mixer's output must stay on the autograd graph, so
    in_proj, the short-conv taps and the implicit filter get gradients."""
    proj, dy, *params = (torch.from_numpy(a) for a in _inputs(2, 4, 256, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (proj, *params)]
    port.reset_launch_counts()
    out = port.mixer_fft_conv_bm(*leaves)
    assert out.grad_fn is not None
    out.backward(dy)
    assert port.launch_counts == {"mixer_fwd": 0, "mixer_bwd": 0}
    want = _autograd_of_plain(proj, dy, *params)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert leaf.grad is not None, name
        assert (leaf.grad - w).abs().max() <= 1e-5 * w.abs().max(), name


def test_hyena_operator_gradients_reach_every_parameter():
    from deepchopper_tpu_torch.models.config import HyenaConfig
    from deepchopper_tpu_torch.models.hyena import HyenaOperator

    cfg = HyenaConfig(d_model=8, n_layer=1, max_seq_len=130, compute_dtype="float32")
    op = HyenaOperator(cfg)
    op.reset_parameters(torch.Generator().manual_seed(0))
    op(torch.randn(2, 8, 128, generator=torch.Generator().manual_seed(1))).square().sum().backward()
    missing = [name for name, p in op.named_parameters() if p.grad is None or not p.grad.abs().sum() > 0]
    assert not missing, missing


def test_bwd_wrapper_refuses_cpu_tensors():
    proj, dy, *params = (torch.from_numpy(a) for a in _inputs(1, 4, 256, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.mixer_bwd_cuda(proj, dy, *params)
