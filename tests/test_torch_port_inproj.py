"""Port in_proj-fused mixer (deepchopper_tpu_torch.ops.inproj) vs the JAX one.

On CPU tensors the port's `mixer_fft_conv_inproj` runs its plain PyTorch
version (and, in its backward, `ops.mixer.mixer_bwd_reference`); it is held
to the JAX op `mixer_fft_conv_inproj` in interpret mode at float32 DFT
precision, forward and `jax.vjp` (whose backward is `_mixer_inproj_bwd`:
the VJP of `_inproj_composed`, through the Pallas mixer backward). The JAX
op takes the flax kernel w (D, 3D); the port takes the nn.Linear weight
w.T (3D, D). Widths 256, 768 and 1280 give the JAX side N = 512, 1536 and
2560. Tolerance: forward and all seven gradients within 1e-5 of
max(1, max|ref|) (FFT and matmul rounding only; the gradients of b_short
and the filter bias are sums over B * L terms).

The CUDA kernel itself runs only on the card (tests/test_torch_port_cuda.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu.ops.pallas_fft import mixer_fft_conv_inproj as jax_inproj
from deepchopper_tpu_torch.ops import inproj as port
from deepchopper_tpu_torch.ops import mixer as port_mixer

REL_TOL = 1e-5
NAMES = ("dx", "dw_in", "db_in", "dk_short", "db_short", "dk_long", "dbias")


def _inputs(batch: int, d_model: int, seq_len: int, seed: int):
    """x, w (flax layout (D, 3D)), b_in, k_short, b_short, k_long, bias, dy."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (
        f32(rng.standard_normal((batch, d_model, seq_len))),
        f32(rng.standard_normal((d_model, 3 * d_model)) * 0.3),
        f32(rng.standard_normal(3 * d_model) * 0.1),
        f32(rng.standard_normal((3, 1, 3 * d_model))),
        f32(rng.standard_normal(3 * d_model)),
        f32(rng.standard_normal((seq_len, d_model)) * np.exp(-np.arange(seq_len) / 40.0)[:, None]),
        f32(rng.standard_normal(d_model)),
        f32(rng.standard_normal((batch, d_model, seq_len))),
    )


def _jax(*args):
    return jax_inproj(*args, interpret=True, precision="float32")


def _port_args(args):
    x, w, *rest = (torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    return [x, w.T.contiguous(), *rest]


def _assert_close(got: np.ndarray, ref: np.ndarray, what: str = "") -> None:
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * max(1.0, np.abs(ref).max()), f"{what} err {err:.3e}, max|ref| {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("seq_len", [256, 768, 1280])
def test_port_inproj_matches_jax_pallas_interpret(seq_len):
    *args, _dy = _inputs(2, 8, seq_len, seed=seq_len)
    ref = np.asarray(_jax(*(jnp.asarray(a) for a in args)))
    got = port.mixer_fft_conv_inproj(*_port_args(args))
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("seq_len", [256, 768])
def test_port_inproj_gradients_match_jax_vjp(seq_len):
    *args, dy = _inputs(2, 4, seq_len, seed=seq_len + 1)
    _, vjp = jax.vjp(_jax, *(jnp.asarray(a) for a in args))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    want[1] = want[1].T  # flax (D, 3D) -> nn.Linear (3D, D)
    leaves = [t.requires_grad_(True) for t in _port_args(args)]
    port_mixer.reset_launch_counts()
    out = port.mixer_fft_conv_inproj(*leaves)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(dy))
    assert port_mixer.launch_counts == {"mixer_fwd": 0, "mixer_bwd": 0}
    for name, leaf, w in zip(NAMES, leaves, want):
        _assert_close(leaf.grad.numpy(), w, what=name)


def test_inproj_is_the_mixer_of_the_projection():
    """In float32 the fused op computes ops.mixer's mixer of w x + b."""
    *args, _dy = _inputs(2, 4, 300, seed=3)
    x, w, b_in, *mix = _port_args(args)
    want = port_mixer.mixer_fft_conv_bm(torch.matmul(w, x) + b_in[:, None], *mix)
    got = port.mixer_fft_conv_inproj(x, w, b_in, *mix)
    assert (got - want).abs().max() <= REL_TOL * want.abs().max()


def test_bf16_forward_keeps_the_projection_in_float32():
    """bfloat16 x: the forward rounds x and w to bf16 but never the
    projection; the backward's recompute rounds it, as DenseCM does."""
    *args, _dy = _inputs(2, 4, 256, seed=4)
    x, w, b_in, *mix = _port_args(args)
    x16 = x.bfloat16()
    got = port.mixer_fft_conv_inproj(x16, w, b_in, *mix)
    assert got.dtype == torch.bfloat16
    proj32 = torch.matmul(w.bfloat16().float(), x16.float()) + b_in[:, None]
    want = port_mixer.mixer_reference(proj32, *mix).bfloat16()
    assert torch.equal(got, want)
    composed = torch.matmul(w.bfloat16(), x16) + b_in.bfloat16()[:, None]
    assert torch.equal(port.projection_composed(x16, w, b_in), composed)


def test_wrapper_takes_plain_version_only_on_cpu():
    *args, _dy = _inputs(1, 4, 256, seed=0)
    targs = _port_args(args)
    port.reset_launch_counts()
    out = port.mixer_fft_conv_inproj(*targs)
    assert out.shape == (1, 4, 256) and port.launch_counts["mixer_inproj_fwd"] == 0
    with pytest.raises(ValueError, match="no implementation"):
        port.mixer_fft_conv_inproj(targs[0].to("meta"), *targs[1:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.mixer_inproj_fwd_cuda(*targs)
