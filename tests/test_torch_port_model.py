"""Port Hyena classifier vs the JAX classifier on the same weights.

JAX parameters from `DeepChopper.new(name, seed=0)` go through
`deepchopper_tpu_torch.models.bridge` into the port; both run at
compute_dtype float32 on the CPU. Tolerances: logits max-abs error
<= 1e-4 * max|ref| (f32 rounding through 4 layers of FFT conv and matmuls),
identical argmax wherever the JAX logit margin exceeds 1e-4. The implicit
filter alone is held to 5e-5 relative: its three sin(10 x) layers amplify
f32 rounding, and at L = 1280 the JAX filter itself lies 3.3e-5 relative
from a float64 evaluation of the same weights.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.classifier import HyenaTokenClassifier as JaxClassifier
from deepchopper_tpu.models.hyena import HyenaFilter as JaxHyenaFilter
from deepchopper_tpu.models.hyena import positional_features as jax_positional_features
from deepchopper_tpu.models.registry import DeepChopper as JaxDeepChopper
from deepchopper_tpu.models.registry import init_params
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
from deepchopper_tpu_torch.models.config import HeadConfig, HyenaConfig
from deepchopper_tpu_torch.models.hyena import HyenaFilter, positional_features

LOGIT_TOL = 1e-4
MARGIN = 1e-4


def _port_config(cls, jax_cfg):
    """The port's config with the JAX config's values, field by field."""
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


def _pair(backbone: jax_config.HyenaConfig, head: jax_config.HeadConfig, params):
    """(JAX module, port module) at float32 with the same weights."""
    bb32 = dataclasses.replace(backbone, compute_dtype="float32")
    hd32 = dataclasses.replace(head, compute_dtype="float32")
    jax_mod = JaxClassifier(backbone_config=bb32, head_config=hd32)
    port = HyenaTokenClassifier(_port_config(HyenaConfig, bb32), _port_config(HeadConfig, hd32))
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    return jax_mod, port.eval()


def _inputs(batch: int, seq_len: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 12, (batch, seq_len)).astype(np.int32)
    quals = rng.integers(5, 40, (batch, seq_len)).astype(np.float32)
    # Right padding on the second row, as a bucketed batch has.
    ids[-1, seq_len // 2 :] = 4
    quals[-1, seq_len // 2 :] = 0
    quals /= np.sqrt((quals * quals).sum(-1, keepdims=True))
    return ids, quals


def _check_logits(jax_mod, params, port, ids, quals):
    ref = np.asarray(jax_mod.apply({"params": params}, jnp.asarray(ids), jnp.asarray(quals)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(quals)).numpy()
    assert got.shape == ref.shape == (*ids.shape, 2)
    err = np.abs(got - ref).max()
    assert err <= LOGIT_TOL * np.abs(ref).max(), f"logits err {err:.3e} vs max|ref| {np.abs(ref).max():.3e}"
    margin = np.abs(ref[..., 1] - ref[..., 0])
    sure = margin > MARGIN
    assert (got.argmax(-1)[sure] == ref.argmax(-1)[sure]).all()


@pytest.mark.parametrize("seq_len", [256, 768])
def test_narrow_classifier_matches_jax(seq_len):
    backbone = jax_config.HyenaConfig(d_model=64, n_layer=2, d_inner=128, max_seq_len=1026)
    head = jax_config.HeadConfig(input_size=64, lin1_size=128, lin2_size=128)
    params = init_params(JaxClassifier(backbone_config=backbone, head_config=head), seed=1)
    jax_mod, port = _pair(backbone, head, params)
    ids, quals = _inputs(2, seq_len, seed=seq_len)
    _check_logits(jax_mod, params, port, ids, quals)


@pytest.mark.parametrize("seq_len", [256, 768])
def test_flagship_classifier_matches_jax(seq_len):
    bundle = JaxDeepChopper.new("hyenadna-small-32k-seqlen", seed=0)
    jax_mod, port = _pair(bundle.module.backbone_config, bundle.module.head_config, bundle.params)
    assert port.backbone_config.d_model == 256 and port.backbone_config.n_layer == 4
    ids, quals = _inputs(2, seq_len, seed=seq_len + 7)
    _check_logits(jax_mod, bundle.params, port, ids, quals)


def test_positional_features_match_jax():
    z, t = positional_features(5, 32770)
    zj, tj = jax_positional_features(32770, 5, 32770)
    # XLA may round the linspace division differently from numpy: 1 ulp.
    np.testing.assert_allclose(t, np.asarray(tj), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(z, np.asarray(zj), rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("seq_len", [256, 1280])
def test_hyena_filter_matches_jax(seq_len):
    cfg = jax_config.HyenaConfig(d_model=32)
    jax_filter = JaxHyenaFilter(cfg)
    params = jax_filter.init(jax.random.PRNGKey(seq_len), seq_len)["params"]
    k_ref, b_ref = (np.asarray(a) for a in jax_filter.apply({"params": params}, seq_len))
    port = HyenaFilter(_port_config(HyenaConfig, cfg))
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        k, b = (a.numpy() for a in port(seq_len))
    np.testing.assert_array_equal(b, b_ref)
    assert k.shape == k_ref.shape == (seq_len, 32)
    assert np.abs(k - k_ref).max() <= 5e-5 * np.abs(k_ref).max()


def test_port_init_follows_flax_distributions():
    from deepchopper_tpu_torch.models.registry import DeepChopper

    a = DeepChopper.new("hyenadna-small-32k-seqlen", seed=0, device="cpu")
    b = DeepChopper.new("hyenadna-small-32k-seqlen", seed=0, device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    jparams = JaxDeepChopper.new("hyenadna-small-32k-seqlen", seed=0).params
    ours = a.state_dict()
    for name, arr in bridge.flax_to_state_dict(jax.tree.map(np.asarray, jparams)).items():
        assert tuple(ours[name].shape) == tuple(arr.shape), name
        want, got = float(arr.std()), float(ours[name].float().std())
        # Two independent sample stds differ by about std / sqrt(n): allow 5x.
        assert abs(got - want) <= 5 * want / np.sqrt(arr.numel()) + 1e-6, (name, got, want)


def test_from_checkpoint_loads_a_saved_state_dict(tmp_path):
    from deepchopper_tpu_torch.models.registry import DeepChopper

    model = DeepChopper.new("hyenadna-tiny-1k-seqlen", seed=3, device="cpu")
    torch.save(model.state_dict(), tmp_path / "port.pt")
    loaded = DeepChopper.from_checkpoint(tmp_path / "port.pt", "hyenadna-tiny-1k-seqlen", device="cpu")
    for (name, want), got in zip(model.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(got, want), name


def test_bridge_transposes_dense_kernels():
    params = {"head": {"linear1": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3), "bias": np.zeros(3)}}}
    sd = bridge.flax_to_state_dict(params)
    assert sd["head.linear1.weight"].shape == (3, 2)
    np.testing.assert_array_equal(sd["head.linear1.weight"].numpy(), params["head"]["linear1"]["kernel"].T)


def test_reference_checkpoint_converts_as_jax_does(tmp_path):
    """`--torch-checkpoint`: a reference-layout (Lightning/HF) checkpoint
    loads into the port with the same weights the JAX converter finds, and
    the port then computes the reference torch model's logits."""
    from test_torch_parity import TorchTokenClassifier, _configs

    from deepchopper_tpu.models.convert import convert_torch_state_dict
    from deepchopper_tpu_torch.models.convert import load_reference_state_dict

    backbone, head = _configs()
    torch.manual_seed(0)
    oracle = TorchTokenClassifier(backbone, head).eval()
    ckpt = tmp_path / "oracle.pt"
    torch.save({"state_dict": {f"net.{k}": v for k, v in oracle.state_dict().items()}}, ckpt)

    template = init_params(JaxClassifier(backbone_config=backbone, head_config=head), seed=0, seq_len=64)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, convert_torch_state_dict(ckpt, template)))
    port = HyenaTokenClassifier(_port_config(HyenaConfig, backbone), _port_config(HeadConfig, head))
    got = load_reference_state_dict(port, ckpt).state_dict()
    assert got.keys() == want.keys()
    for name, arr in want.items():
        assert torch.equal(got[name], arr), name

    ids, quals = _inputs(2, 256, seed=5)
    with torch.no_grad():
        ref = oracle(torch.from_numpy(ids).long(), torch.from_numpy(quals)).numpy()
        out = port.eval()(torch.from_numpy(ids).long(), torch.from_numpy(quals)).numpy()
    assert np.abs(out - ref).max() <= LOGIT_TOL * np.abs(ref).max()
