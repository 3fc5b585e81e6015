"""Hyena's three mixer routes in the port vs the JAX package.

The port's `HyenaOperator` picks its route as the JAX one does
(`deepchopper_tpu/models/hyena.py:339-386`): DEEPCHOPPER_FUSE_SHORT (default
"1"), DEEPCHOPPER_FUSE_INPROJ (default "0"), d_model % 8 and the width L
(512 <= 2L <= 65536, 2L % 512 == 0). The fused route runs `ops.mixer`, the
unfused one `short_depthwise_conv_cf` + `ops.gated` (its plain float32
composition outside the width rule), the in_proj-fused one `ops.inproj`. On
the CPU the JAX model always runs its unfused XLA math (its Pallas routes
need a TPU), so every port route is held to the same JAX model: in float32
the three compute the same function.

Tolerances, as tests/test_torch_port_model.py and test_torch_port_train.py:
logits within 1e-4 of max|logit| with identical argmax beyond a 1e-4 margin;
one train step's loss within 1e-5 relative and every gradient leaf within
1e-4 of its max, on the fixed batch seed of test_torch_port_train.py (a head
ReLU pre-activation within rounding of 0 is a tie between the packages, not
a fault; see there).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import _check_logits
from test_torch_port_model import _inputs as _logit_inputs
from test_torch_port_model import _pair as _eval_pair
from test_torch_port_model import _port_config
from test_torch_port_train import GRAD_TOL, _batch, _flagship, _jax_loss_fn, _narrow, _torch_batch
from test_torch_port_train import _pair as _train_pair

from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models import hyena as jax_hyena
from deepchopper_tpu.models.classifier import HyenaTokenClassifier as JaxClassifier
from deepchopper_tpu.models.hyena import HyenaOperator as JaxHyenaOperator
from deepchopper_tpu.models.registry import init_params
from deepchopper_tpu.ops import pallas_fft
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models import hyena as port_hyena
from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
from deepchopper_tpu_torch.models.config import HeadConfig, HyenaConfig
from deepchopper_tpu_torch.ops import gated, inproj, mixer
from deepchopper_tpu_torch.train.step import make_optimizer, train_step

ROUTES = {
    "fused": {},
    "unfused": {"DEEPCHOPPER_FUSE_SHORT": "0"},
    "inproj": {"DEEPCHOPPER_FUSE_INPROJ": "1"},
}
ENV_KEYS = ("DEEPCHOPPER_FUSE_SHORT", "DEEPCHOPPER_FUSE_INPROJ")


def _set_env(monkeypatch, env: dict) -> None:
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


@functools.lru_cache(maxsize=None)
def _models(name: str):
    """(backbone, head, params) of the JAX model, built once per module."""
    return _narrow() if name == "narrow" else _flagship()


def _port_route_calls(monkeypatch) -> list[str]:
    """Record which op each port HyenaOperator forward calls."""
    calls: list[str] = []
    for attr, route in (("mixer_fft_conv_bm", "fused"), ("gated_fft_conv_bm", "unfused"),
                        ("gated_reference", "unfused-xla"), ("mixer_fft_conv_inproj", "inproj")):  # fmt: skip
        fn = getattr(port_hyena, attr)

        def spy(*args, _fn=fn, _route=route):
            calls.append(_route)
            return _fn(*args)

        monkeypatch.setattr(port_hyena, attr, spy)
    return calls


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("model", ["narrow", "flagship"])
def test_classifier_on_each_route_matches_jax(model, route, monkeypatch):
    _set_env(monkeypatch, ROUTES[route])
    backbone, head, params = _models(model)
    jax_mod, port = _eval_pair(backbone, head, params)
    calls = _port_route_calls(monkeypatch)
    ids, quals = _logit_inputs(2, 256, seed=29)
    _check_logits(jax_mod, params, port, ids, quals)
    assert calls == [route] * backbone.n_layer


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_step_on_each_route_matches_jax(route, monkeypatch):
    _set_env(monkeypatch, ROUTES[route])
    backbone, head, params = _models("narrow")
    jax_mod, port = _train_pair(backbone, head, params)
    ids, quals, labels = _batch(2, 256, seed=11)
    (loss, _logits), grads = jax.value_and_grad(_jax_loss_fn(jax_mod, ids, quals, labels, 0.5), has_aux=True)(params)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    calls = _port_route_calls(monkeypatch)
    aux = train_step(port, make_optimizer(port.parameters(), 1e-3), _torch_batch(ids, quals, labels), 0.5)
    assert calls == [route] * backbone.n_layer
    assert abs(float(aux["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    named = dict(port.named_parameters())
    assert named.keys() == want.keys()
    for name, w in want.items():
        got = named[name].grad
        assert got is not None, name
        err = float((got - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()), f"{name}: err {err:.3e}, max|g| {float(w.abs().max()):.3e}"


def _jax_route(d_model: int, seq_len: int, monkeypatch) -> str:
    """The route the JAX HyenaOperator takes where it runs on a TPU: its
    backend query answers "tpu", and each Pallas entry it may call, and the
    XLA long conv of its unfused route ("unfused-xla"), records itself and
    returns zeros of its output's shape."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    calls: list[str] = []

    def spy(route, out_shape):
        def fn(first, *args, **kwargs):
            calls.append(route)
            return jnp.zeros(out_shape(first.shape), jnp.float32 if route == "unfused-xla" else first.dtype)

        return fn

    monkeypatch.setattr(pallas_fft, "mixer_fft_conv_bm", spy("fused", lambda s: (s[0], s[1] // 3, s[2])))
    monkeypatch.setattr(pallas_fft, "mixer_fft_conv_cm", spy("fused", lambda s: (s[0] // 3, s[1], s[2])))
    monkeypatch.setattr(pallas_fft, "mixer_fft_conv_inproj", spy("inproj", lambda s: s))
    monkeypatch.setattr(pallas_fft, "gated_fft_conv_cm", spy("unfused", lambda s: (s[0] // 3, s[1], s[2])))
    monkeypatch.setattr(jax_hyena, "causal_conv", spy("unfused-xla", lambda s: s))
    cfg = jax_config.HyenaConfig(d_model=d_model, n_layer=1, max_seq_len=seq_len + 2)
    JaxHyenaOperator(cfg).init(jax.random.PRNGKey(0), jnp.zeros((d_model, 1, seq_len), jnp.float32))
    assert len(calls) == 1, calls
    return calls[0]


@pytest.mark.parametrize(
    "env,d_model,seq_len",
    [({}, 16, 256), ({"DEEPCHOPPER_FUSE_SHORT": "0"}, 16, 256), ({"DEEPCHOPPER_FUSE_INPROJ": "1"}, 16, 256),
     ({"DEEPCHOPPER_FUSE_SHORT": "0", "DEEPCHOPPER_FUSE_INPROJ": "1"}, 16, 256),
     ({}, 12, 256), ({"DEEPCHOPPER_FUSE_INPROJ": "1"}, 12, 256),
     ({}, 16, 300), ({"DEEPCHOPPER_FUSE_INPROJ": "1"}, 16, 300), ({}, 16, 40000),
     ({"DEEPCHOPPER_FUSE_SHORT": "0"}, 16, 40000)],
)  # fmt: skip
def test_route_dispatch_follows_jax(env, d_model, seq_len, monkeypatch):
    """Each environment setting, a d_model that is not a multiple of 8, and
    widths outside the kernels' rule (L = 300: 2L % 512 != 0; L = 40000:
    2L > 65536) take the route the JAX package takes on a TPU; outside the
    rule the port computes with the plain gated conv, where its kernels
    would raise."""
    _set_env(monkeypatch, env)
    want = _jax_route(d_model, seq_len, monkeypatch)
    assert port_hyena.mixer_route(d_model, seq_len) == want.removesuffix("-xla")
    cfg = HyenaConfig(d_model=d_model, n_layer=1, max_seq_len=seq_len + 2, compute_dtype="float32")
    op = port_hyena.HyenaOperator(cfg)
    op.reset_parameters(torch.Generator().manual_seed(0))
    calls = _port_route_calls(monkeypatch)
    for module in (mixer, gated, inproj):
        module.reset_launch_counts()
    with torch.no_grad():
        y = op(torch.randn(1, d_model, seq_len))
    assert calls == [want]
    assert y.shape == (1, d_model, seq_len) and torch.isfinite(y).all()


# bf16 logits, port vs JAX at L = 300 (both on the unfused route with the
# plain float32 gated conv), of max|logit|: the short conv, the projections
# and the head round to bf16 at the same places in both, but not always to the
# same side (the two frameworks sum a bf16 matmul in different orders). The
# bf16-I/O limit of the kernel tests; measured 5.9e-3 here.
BF16_LOGIT_TOL = 1e-2


def test_narrow_bf16_classifier_at_l300_matches_jax_unfused_route():
    backbone = jax_config.HyenaConfig(d_model=64, n_layer=2, d_inner=128, max_seq_len=1026, compute_dtype="bfloat16")
    head = jax_config.HeadConfig(input_size=64, lin1_size=128, lin2_size=128, compute_dtype="bfloat16")
    jax_mod = JaxClassifier(backbone_config=backbone, head_config=head)
    params = init_params(jax_mod, seed=5)
    port = HyenaTokenClassifier(_port_config(HyenaConfig, backbone), _port_config(HeadConfig, head)).eval()
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    assert port_hyena.mixer_route(64, 300) == "unfused"
    ids, quals = _logit_inputs(2, 300, seed=300)
    ref = np.asarray(jax_mod.apply({"params": params}, jnp.asarray(ids), jnp.asarray(quals)), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(quals)).float().numpy()
    assert got.shape == ref.shape == (2, 300, 2)
    err = np.abs(got - ref).max()
    assert err <= BF16_LOGIT_TOL * np.abs(ref).max(), f"bf16 logits err {err:.3e} vs max|ref| {np.abs(ref).max():.3e}"


def test_short_depthwise_conv_cf_runs_in_the_compute_dtype():
    """The unfused short conv casts its taps to x's dtype, as
    `short_depthwise_conv_cm` does; in float32 it is the fused mixer's."""
    from deepchopper_tpu.models.hyena import short_depthwise_conv_cm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    k = rng.standard_normal((3, 1, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(short_depthwise_conv_cm(jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(k), jnp.asarray(b)))
    got = port_hyena.short_depthwise_conv_cf(*(torch.from_numpy(a) for a in (x, k, b)))
    np.testing.assert_allclose(got.numpy(), want.transpose(1, 0, 2), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), mixer._short_conv_gates(*(torch.from_numpy(a) for a in (x, k, b))).numpy(),
                               rtol=0, atol=1e-6)  # fmt: skip
    x16 = torch.from_numpy(x).bfloat16()
    assert port_hyena.short_depthwise_conv_cf(x16, torch.from_numpy(k), torch.from_numpy(b)).dtype == torch.bfloat16
