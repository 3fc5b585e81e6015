"""Port Caduceus classifiers (deepchopper_tpu_torch.models.caduceus) vs the JAX
package, on the CPU.

JAX parameters from `init_params` go through `models/bridge.py` into the
port; both run at compute_dtype float32 (the JAX scan is its chunked
associative scan off the TPU, the port's its plain version on CPU tensors).
Tolerances: logits within 1e-4 of max|logit| with the same argmax (float32
rounding through two bidirectional layers; measured <= 2.3e-6); one train
step: loss within 1e-5 relative, every gradient leaf within 1e-4 of its own
max|g| (measured: loss 1.2e-7, leaves <= 2.1e-6).
The train-step batch seed is fixed: a gradient comparison is void on a batch
where a head ReLU's pre-activation lies within rounding of its kink, where the
packages can disagree on the mask (see tests/test_torch_port_train.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.caduceus import MambaMixer as JaxMambaMixer
from deepchopper_tpu.models.caduceus import short_depthwise_conv_rev as jax_conv_rev
from deepchopper_tpu.models.classifier import CaduceusTokenClassifier as JaxClassifier
from deepchopper_tpu.models.registry import init_params
from deepchopper_tpu.train import loss as jax_loss
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models.caduceus import MambaMixer, short_depthwise_conv, short_depthwise_conv_rev
from deepchopper_tpu_torch.models.classifier import CaduceusTokenClassifier, HyenaTokenClassifier
from deepchopper_tpu_torch.models.config import CaduceusConfig, HeadConfig
from deepchopper_tpu_torch.models.registry import DeepChopper, build_model
from deepchopper_tpu_torch.ops import scan
from deepchopper_tpu_torch.train.step import make_optimizer, train_step

LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4


def _port_config(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


def _tiny(tied: bool):
    backbone = jax_config.CADUCEUS_TINY if tied else jax_config.CADUCEUS_TINY_PS
    head = jax_config.HeadConfig(input_size=64, lin1_size=128, lin2_size=128)
    return backbone, head, init_params(JaxClassifier(backbone_config=backbone, head_config=head), seed=1, seq_len=8)


def _pair(backbone, head, params):
    """(JAX module, port module) at float32 with the same weights."""
    bb32 = dataclasses.replace(backbone, compute_dtype="float32")
    hd32 = dataclasses.replace(head, compute_dtype="float32")
    jax_mod = JaxClassifier(backbone_config=bb32, head_config=hd32)
    port = CaduceusTokenClassifier(_port_config(CaduceusConfig, bb32), _port_config(HeadConfig, hd32))
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    return jax_mod, port


def _batch(batch: int, seq_len: int, seed: int):
    """ids, normalized quals and 0/1 labels; the last row right-padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 12, (batch, seq_len)).astype(np.int32)
    quals = rng.integers(5, 40, (batch, seq_len)).astype(np.float32)
    labels = (rng.random((batch, seq_len)) < 0.3).astype(np.int32)
    ids[-1, seq_len // 2 :] = 4
    quals[-1, seq_len // 2 :] = 0
    labels[-1, seq_len // 2 :] = -100
    quals /= np.sqrt((quals * quals).sum(-1, keepdims=True))
    return ids, quals, labels


# -- the mixer's pieces ---------------------------------------------------------


def test_mirrored_conv_matches_jax_and_the_flip_formulation():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 19, 8)).astype(np.float32)
    k = rng.standard_normal((4, 1, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    xt, kt, bt = (torch.from_numpy(a) for a in (x, k, b))
    got = short_depthwise_conv_rev(xt, kt, bt)
    flipped = short_depthwise_conv(xt.flip(1), kt, bt).flip(1)
    torch.testing.assert_close(got, flipped, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_conv_rev(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))),
                               rtol=0, atol=1e-6)  # fmt: skip


def test_reverse_mixer_matches_flip_formulation_and_jax():
    cfg = dataclasses.replace(jax_config.CADUCEUS_TINY, compute_dtype="float32")
    x = np.random.default_rng(5).standard_normal((2, 33, cfg.d_model)).astype(np.float32)
    jax_mixer = JaxMambaMixer(cfg)
    params = jax_mixer.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :8]))["params"]
    mixer = MambaMixer(_port_config(CaduceusConfig, cfg))
    bridge.load_flax_params(mixer, jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = mixer(xt, reverse=True)
        flipped = mixer(xt.flip(1)).flip(1)
    assert (got - flipped).abs().max() <= 2e-5 * flipped.abs().max()
    want = np.asarray(jax.jit(jax_mixer.apply, static_argnames="reverse")({"params": params}, jnp.asarray(x), reverse=True))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# -- whole classifiers ------------------------------------------------------------


@pytest.mark.parametrize("tied", [True, False], ids=["ph", "ps"])
@pytest.mark.parametrize("seq_len", [100, 256])
def test_tiny_classifier_matches_jax(tied, seq_len):
    backbone, head, params = _tiny(tied)
    jax_mod, port = _pair(backbone, head, params)
    assert ("backbone.block_0.bimamba.mixer_rev.A_log" in port.state_dict()) == (not tied)
    ids, quals, _labels = _batch(2, seq_len, seed=seq_len + int(tied))
    ref = np.asarray(jax.jit(jax_mod.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(quals)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(ids).long(), torch.from_numpy(quals)).numpy()
    assert got.shape == ref.shape == (2, seq_len, 2) and got.dtype == np.float32
    err = np.abs(got - ref).max()
    assert err <= LOGIT_TOL * np.abs(ref).max(), f"logits err {err:.3e} vs max|ref| {np.abs(ref).max():.3e}"
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("tied", [True, False], ids=["ph", "ps"])
def test_train_step_matches_jax_value_and_grad(tied):
    backbone, head, params = _tiny(tied)
    jax_mod, port = _pair(backbone, head, params)
    ids, quals, labels = _batch(2, 128, seed=11)
    lam = 0.5

    def loss_fn(p):
        logits = jax_mod.apply({"params": p}, jnp.asarray(ids), jnp.asarray(quals))
        return jax_loss.continuous_interval_loss(logits, jnp.asarray(labels), lam)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    batch = {"input_ids": torch.from_numpy(ids).long(), "input_quals": torch.from_numpy(quals),
             "labels": torch.from_numpy(labels).long()}  # fmt: skip
    out = train_step(port.train(), make_optimizer(port.parameters(), 1e-3), batch, lam)
    assert abs(float(out["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    named = dict(port.named_parameters())
    assert named.keys() == want.keys()
    for name, w in want.items():
        g, scale = named[name].grad, float(w.abs().max())
        assert g is not None, name
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, (name, float((g - w).abs().max()), scale)


# -- registry, init, checkpoints ---------------------------------------------------


def test_registry_builds_every_caduceus_name_and_keeps_the_class_on_head_overrides():
    for name, tied in (("caduceus-ph_seqlen-131k_d_model-256_n_layer-16", True),
                       ("caduceus-ps_seqlen-131k_d_model-256_n_layer-16", False),
                       ("caduceus-tiny", True), ("caduceus-tiny-ps", False)):  # fmt: skip
        model = build_model(name)
        assert isinstance(model, CaduceusTokenClassifier) and model.backbone_config.bidirectional_weight_tie == tied
        over = build_model(name, head_overrides={"lin1_size": 64})
        assert type(over) is CaduceusTokenClassifier and over.name == name
        assert (over.head_config.lin1_size, over.head_config.lin2_size) == (64, 64)
        assert over.backbone_config == model.backbone_config
    assert type(build_model("hyenadna-tiny-1k-seqlen", head_overrides={"lin1_size": 64})) is HyenaTokenClassifier
    flagship = build_model("caduceus-ph_seqlen-131k_d_model-256_n_layer-16").backbone_config
    assert (flagship.d_model, flagship.n_layer, flagship.expand, flagship.d_state, flagship.dt_rank,
            flagship.d_conv) == (256, 16, 2, 16, 16, 4)  # fmt: skip


def test_port_config_is_the_jax_config_field_by_field():
    from deepchopper_tpu_torch.models import config as port_config

    for name, jax_cfg in jax_config.CADUCEUS_CONFIGS.items():
        port = port_config.CADUCEUS_CONFIGS[name]
        assert port == _port_config(CaduceusConfig, jax_cfg)
        assert port.padded_vocab_size == jax_cfg.padded_vocab_size
    assert port_config.CADUCEUS_TINY_PS == _port_config(CaduceusConfig, jax_config.CADUCEUS_TINY_PS)


@pytest.mark.parametrize("name", ["caduceus-ph_seqlen-131k_d_model-256_n_layer-16", "caduceus-tiny-ps"])
def test_port_init_follows_flax_distributions(name):
    from deepchopper_tpu.models.registry import build_model as jax_build_model

    a = DeepChopper.new(name, seed=0, device="cpu")
    b = DeepChopper.new(name, seed=0, device="cpu")
    for (key, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), key
    ours = a.state_dict()
    jparams = init_params(jax_build_model(name), seed=0, seq_len=8)  # shapes do not bind L
    for key, arr in bridge.flax_to_state_dict(jax.tree.map(np.asarray, jparams)).items():
        assert tuple(ours[key].shape) == tuple(arr.shape), key
        if key.endswith(("A_log", ".D", "conv1d_bias")):
            torch.testing.assert_close(ours[key], arr, rtol=0, atol=1e-6)  # deterministic initialisers
            continue
        want, got = float(arr.std()), float(ours[key].float().std())
        # Two independent sample stds differ by about std / sqrt(n): allow 5x.
        assert abs(got - want) <= 5 * want / np.sqrt(arr.numel()) + 1e-6, (key, got, want)


def _reference_classifier(tied: bool):
    """The reference torch classifier (HF Caduceus backbone + head) of
    tests/test_torch_parity.py, tiny, random weights."""
    from test_torch_parity import Head, TorchBiMambaUntied, TorchCaduceusBackbone

    cfg = dataclasses.replace(jax_config.CADUCEUS_TINY if tied else jax_config.CADUCEUS_TINY_PS, compute_dtype="float32")
    head = jax_config.HeadConfig(input_size=cfg.d_model, lin1_size=96, lin2_size=96, compute_dtype="float32")
    torch.manual_seed(2)
    net = torch.nn.Module()
    net.backbone = torch.nn.Module()
    net.backbone.backbone = TorchCaduceusBackbone(dataclasses.replace(cfg, bidirectional_weight_tie=True))
    if not tied:
        for blk in net.backbone.backbone.layers:
            blk.mixer = TorchBiMambaUntied(cfg.d_model, cfg.d_state, cfg.d_conv, cfg.expand, cfg.dt_rank)
    net.head = Head(head)
    return cfg, head, net


@pytest.mark.parametrize("tied", [True, False], ids=["ph", "ps"])
def test_reference_checkpoint_converts_as_jax_does(tmp_path, tied):
    from deepchopper_tpu.models.convert import convert_torch_state_dict
    from deepchopper_tpu_torch.models.convert import load_reference_state_dict

    cfg, head, net = _reference_classifier(tied)
    ckpt = tmp_path / "reference.pt"
    torch.save({"state_dict": {f"net.{k}": v for k, v in net.state_dict().items()}}, ckpt)
    template = init_params(JaxClassifier(backbone_config=cfg, head_config=head), seed=0, seq_len=32)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, convert_torch_state_dict(ckpt, template)))
    port = CaduceusTokenClassifier(_port_config(CaduceusConfig, cfg), _port_config(HeadConfig, head))
    got = load_reference_state_dict(port, ckpt).state_dict()
    assert got.keys() == want.keys()
    for key, arr in want.items():
        assert torch.equal(got[key], arr), key
    ids, quals, _labels = _batch(2, 80, seed=5)
    with torch.no_grad():
        ref = net.head(net.backbone.backbone(torch.from_numpy(ids).long()), torch.from_numpy(quals)).numpy()
        out = port.eval()(torch.from_numpy(ids).long(), torch.from_numpy(quals)).numpy()
    assert np.abs(out - ref).max() <= LOGIT_TOL * np.abs(ref).max()


def test_ps_model_refuses_a_checkpoint_without_reverse_mixer_keys(tmp_path):
    from deepchopper_tpu_torch.models.convert import load_reference_state_dict

    _cfg, _head, net = _reference_classifier(tied=True)
    ckpt = tmp_path / "ph_only.pt"
    torch.save({f"net.{k}": v for k, v in net.state_dict().items()}, ckpt)
    cfg_ps = dataclasses.replace(jax_config.CADUCEUS_TINY_PS, compute_dtype="float32")
    port = CaduceusTokenClassifier(_port_config(CaduceusConfig, cfg_ps), HeadConfig(input_size=64, lin1_size=96,
                                                                                     lin2_size=96))  # fmt: skip
    with pytest.raises(KeyError, match="mamba_rev"):
        load_reference_state_dict(port, ckpt)


def test_cli_predict_train_and_predict_from_the_checkpoint(tmp_path):
    """`predict --random-init`, `train` and `predict --checkpoint` on
    caduceus-tiny through the CLI on the CPU: every read gets finite logits
    and no kernel launches."""
    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.data.synth import synth_labelled_fastq

    fq = synth_labelled_fastq(tmp_path / "reads.fq", np.full(12, 150), seed=1)
    scan.reset_launch_counts()
    assert cli.main(["predict", str(fq), "--model", "caduceus-tiny", "--random-init", "--max-length", "256",
                     "--device", "cpu", "-o", str(tmp_path / "pred0")]) == 0  # fmt: skip
    over = [f"data.train_data_path={fq}", "data.max_length=256", "model.name=caduceus-tiny", "trainer.max_epochs=1",
            f"output_dir={tmp_path / 'runs'}"]  # fmt: skip
    assert cli.main(["train", *over, "--device", "cpu"]) == 0
    best = sorted((tmp_path / "runs" / "train" / "checkpoints").glob("epoch_*.ckpt"))
    assert best
    assert cli.main(["predict", str(fq), "--checkpoint", str(best[-1]), "--model", "caduceus-tiny", "--max-length",
                     "256", "--device", "cpu", "-o", str(tmp_path / "pred")]) == 0  # fmt: skip
    for out in ("pred0", "pred"):
        shards = sorted((tmp_path / out / "0").glob("*.npz"))
        assert sum(len(np.load(p)["id"]) for p in shards) == 12
        assert all(np.isfinite(np.load(p)["prediction"]).all() for p in shards)
    assert scan.launch_counts == {"scan_fwd": 0, "scan_ckpt": 0, "scan_bwd": 0}
