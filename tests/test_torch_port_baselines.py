"""Port transformer and CNN baselines vs the JAX modules, on the CPU.

JAX variables come from `module.init`; they go through
`deepchopper_tpu_torch.models.bridge` into the port (the CNN's `batch_stats`
into its BatchNorm buffers). Inputs are made by numpy from a seed.

Tolerances:
- compute_dtype float32 on both sides: max-abs error <= 1e-5 * max|ref|
  (measured: 3.4e-7 through two encoder layers and the head);
- bfloat16 (the transformer's default): the JAX package's own head band
  (tests/test_models.py:219), error <= 0.03 * max(1, max|ref|) and argmax
  agreement >= 99% (measured: 7.3e-3 of max|ref|, argmax all equal);
- the CNN computes in float32 in both packages whatever its compute_dtype,
  so it is held to the float32 rule in both BatchNorm modes, running
  statistics included: eval against `apply(variables)`, train against
  `apply(variables, train=True, mutable=["batch_stats"])`. A BatchNorm that
  keeps torch's unbiased running variance must fail that rule;
- train steps in float32: loss within 1e-5 relative, each gradient leaf
  within 1e-4 of its own max|g|.
The JAX registry cannot apply its own CNN (`init_params` keeps only
"params", and the BatchNorms need "batch_stats"), so the CNN is held to the
flax module applied with the full variables `module.init` returns.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.classifier import TransformerTokenClassifier as JaxTransformer
from deepchopper_tpu.models.head import BenchmarkCNN as JaxCNN
from deepchopper_tpu.models.head import TokenClassificationCnnHead as JaxCnnHead
from deepchopper_tpu.models.registry import DeepChopper as JaxDeepChopper
from deepchopper_tpu.models.registry import ModelBundle as JaxModelBundle
from deepchopper_tpu.models.registry import build_model as jax_build
from deepchopper_tpu.models.transformer import EncoderLayer as JaxEncoderLayer
from deepchopper_tpu.models.transformer import sinusoidal_positions as jax_positions
from deepchopper_tpu.train import loss as jax_loss
from deepchopper_tpu.train.step import TrainState, make_train_step
from deepchopper_tpu_torch import cli
from deepchopper_tpu_torch.data.synth import synth_fastq, synth_labelled_fastq
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models.classifier import TransformerTokenClassifier
from deepchopper_tpu_torch.models.config import CnnConfig, HeadConfig, TransformerConfig
from deepchopper_tpu_torch.models.head import BatchNorm, BenchmarkCNN, TokenClassificationCnnHead
from deepchopper_tpu_torch.models.registry import MODEL_REGISTRY, DeepChopper, build_model
from deepchopper_tpu_torch.models.transformer import EncoderLayer, sinusoidal_positions
from deepchopper_tpu_torch.train.config import load_config
from deepchopper_tpu_torch.train.loop import Trainer, evaluate
from deepchopper_tpu_torch.train.step import make_optimizer, train_step

F32_TOL = 1e-5
GRAD_TOL = 1e-4


def _port_config(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(batch: int, seq_len: int, seed: int):
    """ids over the whole vocabulary, L2-normalized quals, and a key mask
    with the last row all masked."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, (batch, seq_len)).astype(np.int32)
    quals = rng.integers(5, 40, (batch, seq_len)).astype(np.float32)
    quals /= np.sqrt((quals * quals).sum(-1, keepdims=True))
    mask = rng.random((batch, seq_len)) < 0.8
    mask[-1] = False
    return ids, quals, mask


def _assert_close(got: np.ndarray, ref: np.ndarray, dtype: str, where: str) -> None:
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    if dtype == "float32":
        assert err <= F32_TOL * scale, f"{where}: err {err:.3e} > {F32_TOL} x {scale:.3e}"
    else:
        assert err <= 0.03 * max(1.0, scale), f"{where}: err {err:.3e}, max|ref| {scale:.3e}"
        agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
        assert agree >= 0.99, f"{where}: argmax agreement {agree}"


def _transformer_cfgs(dtype: str):
    bb = jax_config.TransformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=128, compute_dtype=dtype)
    hd = jax_config.HeadConfig(input_size=32, lin1_size=64, lin2_size=64, compute_dtype=dtype)
    return bb, hd


@functools.cache
def _transformer_params(dtype: str, seed: int):
    """JAX parameters of the narrow transformer, made once a (dtype, seed)."""
    bb, hd = _transformer_cfgs(dtype)
    ids, quals, _ = _inputs(2, 16, 0)
    jax_mod = JaxTransformer(backbone_config=bb, head_config=hd)
    return jax.jit(jax_mod.init)(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(quals))["params"]


def _transformer_pair(dtype: str, seed: int = 0):
    bb, hd = _transformer_cfgs(dtype)
    jax_mod = JaxTransformer(backbone_config=bb, head_config=hd)
    params = _transformer_params(dtype, seed)
    port = TransformerTokenClassifier(_port_config(TransformerConfig, bb), _port_config(HeadConfig, hd))
    bridge.load_flax_params(port, _np(params))
    return jax_mod, params, port


# -- transformer ---------------------------------------------------------------


def test_sinusoidal_positions_equal_jax():
    np.testing.assert_array_equal(sinusoidal_positions(300, 32), jax_positions(300, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_encoder_layer_matches_jax(dtype, masked):
    bb, _ = _transformer_cfgs(dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 40, bb.d_model)).astype(np.float32)
    _, _, mask = _inputs(3, 40, 4)
    jmask = jnp.asarray(mask) if masked else None
    layer = JaxEncoderLayer(bb)
    params = jax.jit(layer.init)(jax.random.PRNGKey(2), jnp.asarray(x), jmask)["params"]
    ref = np.asarray(jax.jit(layer.apply)({"params": params}, jnp.asarray(x), jmask))
    port = EncoderLayer(_port_config(TransformerConfig, bb))
    bridge.load_flax_params(port, _np(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask) if masked else None).numpy()
    assert np.isfinite(got).all()
    _assert_close(got, ref, dtype, f"encoder layer {dtype} masked={masked}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_transformer_classifier_matches_jax(dtype, masked):
    """With a pad_mask, the last row's keys are all masked: flax attends
    uniformly there, and so must the port (finite, equal logits)."""
    jax_mod, params, port = _transformer_pair(dtype)
    ids, quals, mask = _inputs(3, 50, 5)
    jmask = jnp.asarray(mask) if masked else None
    ref = np.asarray(jax.jit(jax_mod.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(quals), jmask))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(quals),
                   pad_mask=torch.from_numpy(mask) if masked else None).numpy()  # fmt: skip
    assert got.shape == ref.shape == (3, 50, 2) and np.isfinite(got).all()
    _assert_close(got, ref, dtype, f"transformer {dtype} masked={masked}")


def test_transformer_without_positions_fails_the_rule():
    """Control: the same weights with the position table zeroed."""
    jax_mod, params, port = _transformer_pair("float32")
    ids, quals, _ = _inputs(3, 50, 5)
    ref = np.asarray(jax.jit(jax_mod.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(quals)))
    port.backbone.positions.zero_()
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(quals)).numpy()
    with pytest.raises(AssertionError):
        _assert_close(got, ref, "float32", "control")


# -- CNN -------------------------------------------------------------------------


def _cnn_variables(module, args, seed: int):
    """`module.init`'s variables (jitted: an eager init compiles op by op),
    running statistics moved off their initial (0, 1) so eval mode reads
    them."""
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)) * a
                         + jnp.asarray(rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)),
                         variables["batch_stats"])  # fmt: skip
    return variables["params"], stats


def _running(port) -> dict:
    return {k: v.numpy().copy() for k, v in port.state_dict().items() if "running" in k}


def _want_running(stats) -> dict:
    return {k: v.numpy() for k, v in bridge.flax_to_state_dict({}, _np(stats)).items()}


def _cnn_pair(compute_dtype: str = "float32"):
    cfg = jax_config.CnnConfig(embed_dim=16, num_filters=(8, 12), filter_sizes=(3, 4), compute_dtype=compute_dtype)
    ids, quals, _ = _inputs(3, 40, 6)
    jax_mod = JaxCNN(config=cfg)
    params, stats = _cnn_variables(jax_mod, (jnp.asarray(ids), jnp.asarray(quals)), 7)
    port = BenchmarkCNN(_port_config(CnnConfig, cfg))
    bridge.load_flax_params(port, _np(params), _np(stats))
    return jax_mod, params, stats, port, (ids, quals)


def _head_pair():
    rng = np.random.default_rng(8)
    hidden = rng.standard_normal((3, 40, 16)).astype(np.float32)
    _, quals, _ = _inputs(3, 40, 9)
    jax_mod = JaxCnnHead(input_size=16, num_class=2, num_filters=(8, 12), filter_sizes=(5, 2))
    params, stats = _cnn_variables(jax_mod, (jnp.asarray(hidden), jnp.asarray(quals)), 10)
    port = TokenClassificationCnnHead(16, 2, (8, 12), (5, 2))
    bridge.load_flax_params(port, _np(params), _np(stats))
    return jax_mod, params, stats, port, (hidden, quals)


def test_jax_registry_cannot_apply_its_own_cnn():
    """The JAX package's fault the port does not share: `init_params` keeps
    only "params", and `BenchmarkCNN`'s BatchNorms need "batch_stats", so
    `DeepChopper.new("cnn").apply` raises (flax's ScopeCollectionNotFound)."""
    from flax.errors import ScopeCollectionNotFound

    bundle = JaxDeepChopper.new("cnn")
    with pytest.raises(ScopeCollectionNotFound, match="batch_stats"):
        bundle.apply(jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, 16), jnp.float32))


def _port_call(port, which: str, args):
    if which == "cnn":
        ids, quals = args
        return port(torch.from_numpy(ids).long(), torch.from_numpy(quals))
    hidden, quals = args
    return port(torch.from_numpy(hidden).transpose(1, 2), torch.from_numpy(quals))


@pytest.mark.parametrize("which", ["cnn", "head"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cnn_matches_flax_in_both_batchnorm_modes(which, mode):
    jax_mod, params, stats, port, args = _cnn_pair() if which == "cnn" else _head_pair()
    jargs = [jnp.asarray(a) for a in args]
    variables = {"params": params, "batch_stats": stats}
    if mode == "eval":
        ref, want_stats = jax.jit(jax_mod.apply)(variables, *jargs), stats
    else:
        train_apply = functools.partial(jax_mod.apply, train=True, mutable=["batch_stats"])
        ref, updated = jax.jit(train_apply)(variables, *jargs)
        want_stats = updated["batch_stats"]
    port.train(mode == "train")
    with torch.no_grad():
        got = _port_call(port, which, args).numpy()
    _assert_close(got, np.asarray(ref), "float32", f"{which} {mode}")
    want, have = _want_running(want_stats), _running(port)
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=F32_TOL, atol=F32_TOL * np.abs(want[k]).max(), err_msg=k)


def test_cnn_computes_float32_at_its_default_compute_dtype():
    """CnnConfig's default compute_dtype is bfloat16, which neither package's
    CNN reads: both run float32, so the float32 rule holds."""
    jax_mod, params, stats, port, args = _cnn_pair("bfloat16")
    ref = jax.jit(jax_mod.apply)({"params": params, "batch_stats": stats}, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = _port_call(port.eval(), "cnn", args).numpy()
    _assert_close(got, np.asarray(ref), "float32", "cnn at bf16 config")


class _UnbiasedBatchNorm(BatchNorm):
    """Control: torch BatchNorm1d's running variance, the unbiased one."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.shape[0] * x.shape[2]
        mean, var = x.mean(dim=(0, 2)), x.var(dim=(0, 2), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var * n / (n - 1))
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


def test_unbiased_running_variance_fails_the_train_rule():
    jax_mod, params, stats, port, args = _cnn_pair()
    for i in range(port.n_convs):
        bn = getattr(port, f"bn_{i}")
        bn.__class__ = _UnbiasedBatchNorm
    train_apply = functools.partial(jax_mod.apply, train=True, mutable=["batch_stats"])
    _ref, updated = jax.jit(train_apply)({"params": params, "batch_stats": stats}, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        _port_call(port.train(), "cnn", args)
    want, have = _want_running(updated["batch_stats"]), _running(port)
    bad = [k for k in want if "running_var" in k
           and np.abs(have[k] - want[k]).max() > F32_TOL * np.abs(want[k]).max()]  # fmt: skip
    assert bad, "the unbiased running variance passed the rule"


# -- train steps ---------------------------------------------------------------


def _labels(batch: int, seq_len: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    labels = (rng.random((batch, seq_len)) < 0.3).astype(np.int32)
    labels[-1, seq_len // 2 :] = -100
    return labels


def _check_grads(port, want_grads: dict, zero: tuple[str, ...] = ()) -> None:
    """Each leaf within GRAD_TOL of its own max|g|. The leaves named by a
    suffix in `zero` have a zero gradient in exact arithmetic (rounding is
    all there is to compare): they are held to GRAD_TOL of the model's
    largest gradient instead."""
    named = dict(port.named_parameters())
    assert named.keys() == want_grads.keys()
    largest = max(float(g.abs().max()) for g in want_grads.values())
    for name, want in want_grads.items():
        got = named[name].grad
        scale = largest if name.endswith(zero) else float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= GRAD_TOL * scale, f"{name}: err {err:.3e}, max|g| {scale:.3e}"


def test_transformer_train_step_matches_jax_make_train_step():
    """JAX's own `make_train_step`, with a transformation that keeps the
    gradients as its state (and leaves the parameters), against the port's
    `train_step`."""
    jax_mod, params, port = _transformer_pair("float32", seed=1)
    ids, quals, _ = _inputs(2, 48, 11)
    labels = _labels(2, 48, 12)
    keep_grads = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                              lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))  # fmt: skip
    step = jax.jit(make_train_step(jax_mod.apply, keep_grads, 0.5))
    state = TrainState(params=params, opt_state=keep_grads.init(params), step=jnp.zeros((), jnp.int32))
    new_state, aux = step(state, {"input_ids": jnp.asarray(ids), "input_quals": jnp.asarray(quals),
                                  "labels": jnp.asarray(labels)})  # fmt: skip
    batch = {"input_ids": torch.from_numpy(ids).long(), "input_quals": torch.from_numpy(quals),
             "labels": torch.from_numpy(labels).long()}  # fmt: skip
    got = train_step(port.train(), make_optimizer(port.parameters(), 1e-3), batch, 0.5)
    assert abs(float(got["loss"]) - float(aux["loss"])) <= 1e-5 * abs(float(aux["loss"]))
    np.testing.assert_array_equal(got["stats"].numpy(), np.asarray(aux["stats"]))
    # A key bias shifts every score of a query's row alike, which softmax ignores.
    _check_grads(port, bridge.flax_to_state_dict(_np(new_state.opt_state)), zero=("mha.key.bias",))


def test_cnn_train_step_matches_jax_grad_in_train_mode():
    """`jax.grad` of the flax CNN in train mode (batch statistics, running
    ones updated) against the port's `train_step` on the model in train
    mode: loss, gradients and the updated running statistics."""
    jax_mod, params, stats, port, (ids, quals) = _cnn_pair()
    labels = _labels(3, 40, 13)

    def loss_fn(p):
        logits, updated = jax_mod.apply({"params": p, "batch_stats": stats}, jnp.asarray(ids), jnp.asarray(quals),
                                        train=True, mutable=["batch_stats"])  # fmt: skip
        return jax_loss.continuous_interval_loss(logits, jnp.asarray(labels), 0.0), updated["batch_stats"]

    (loss, updated), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    batch = {"input_ids": torch.from_numpy(ids).long(), "input_quals": torch.from_numpy(quals),
             "labels": torch.from_numpy(labels).long()}  # fmt: skip
    got = train_step(port.train(), make_optimizer(port.parameters(), 1e-3), batch)
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    # A conv bias before a train-mode BatchNorm is taken out with the batch mean.
    _check_grads(port, bridge.flax_to_state_dict(_np(grads)), zero=tuple(f"conv_{i}.bias" for i in range(port.n_convs)))
    want, have = _want_running(updated), _running(port)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=F32_TOL, atol=F32_TOL * np.abs(want[k]).max(), err_msg=k)


# -- registry and model folders ------------------------------------------------


def test_registry_has_both_baselines_and_the_cnn_has_no_head():
    assert {"transformer", "cnn"} <= MODEL_REGISTRY.keys()
    assert isinstance(build_model("transformer"), TransformerTokenClassifier)
    assert isinstance(build_model("cnn"), BenchmarkCNN)
    with pytest.raises(ValueError, match="no tunable head"):
        build_model("cnn", {"lin1_size": 128})


@pytest.mark.parametrize("name", ["transformer", "cnn"])
def test_full_width_configs_equal_jax(name):
    jax_mod, port = jax_build(name), build_model(name)
    if name == "cnn":
        assert dataclasses.asdict(jax_mod.config) == dataclasses.asdict(port.config)
    else:
        assert dataclasses.asdict(jax_mod.backbone_config) == dataclasses.asdict(port.backbone_config)
        assert dataclasses.asdict(jax_mod.head_config) == dataclasses.asdict(port.head_config)


@pytest.mark.parametrize("name", ["transformer", "cnn", "hyenadna-tiny-1k-seqlen"])
def test_model_folder_round_trip_and_config_json(name, tmp_path):
    """save_pretrained -> from_pretrained_dir and from_pretrained(<folder>):
    the same logits bitwise, the CNN's running statistics included; the
    config.json equal to the JAX package's for the same model, but for the
    two JAX Hyena/Caduceus fields the port leaves out (conv_impl,
    scan_chunk)."""
    model = DeepChopper.new(name, seed=3, device="cpu")
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.5, 1.5)
    folder = DeepChopper.save_pretrained(model, tmp_path / "folder")
    module = jax_build(name)  # JAX's save_pretrained writes config.json from the module alone
    bundle = JaxModelBundle(module, {}, name, getattr(module, "backbone_config", None))
    jax_folder = JaxDeepChopper.save_pretrained(bundle, tmp_path / "jax")
    got, want = json.loads((folder / "config.json").read_text()), json.loads((jax_folder / "config.json").read_text())
    for key in ("conv_impl", "scan_chunk"):
        want["backbone"].pop(key, None)
    assert got == want
    ids, quals, _ = _inputs(2, 64, 14)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(quals))
    with torch.no_grad():
        ref = model(*args)
        for loaded in (DeepChopper.from_pretrained_dir(folder, device="cpu"),
                       DeepChopper.from_pretrained(str(folder), device="cpu")):  # fmt: skip
            assert not loaded.training
            assert torch.equal(loaded(*args), ref)
    hub = DeepChopper.to_hub(model, "me/model", tmp_path / "hub")
    assert sorted(p.name for p in hub.iterdir()) == ["config.json", "model.pt"]


def test_predict_from_a_model_folder(tmp_path):
    fq = synth_fastq(tmp_path / "reads.fq", np.full(5, 150), seed=2)
    folder = DeepChopper.save_pretrained(DeepChopper.new("hyenadna-tiny-1k-seqlen", device="cpu"), tmp_path / "m")
    rc = cli.main(["predict", str(fq), "--model", str(folder), "--max-length", "256", "--device", "cpu",
                   "-o", str(tmp_path / "pred")])  # fmt: skip
    assert rc == 0
    assert sum(len(np.load(p)["id"]) for p in (tmp_path / "pred" / "0").glob("*.npz")) == 5


# -- the CLI on the CPU -----------------------------------------------------------


@pytest.mark.parametrize("name", ["transformer", "cnn"])
def test_predict_random_init_on_the_cpu(name, tmp_path):
    fq = synth_fastq(tmp_path / "reads.fq", np.array([150, 300, 700]), seed=3)
    rc = cli.main(["predict", str(fq), "--model", name, "--random-init", "--device", "cpu",
                   "-o", str(tmp_path / "pred")])  # fmt: skip
    assert rc == 0
    shards = sorted((tmp_path / "pred" / "0").glob("*.npz"))
    assert sum(len(np.load(p)["id"]) for p in shards) == 3
    assert all(np.isfinite(np.load(p)["prediction"]).all() for p in shards)


@pytest.fixture(scope="module")
def cnn_run(tmp_path_factory):
    """`train --config configs/experiment/cnn.yaml` on the CPU, one epoch."""
    tmp = tmp_path_factory.mktemp("cnn")
    fq = synth_labelled_fastq(tmp / "reads.fq", np.full(24, 200), seed=4)
    rc = cli.main(["train", "--config", "configs/experiment/cnn.yaml", f"data.train_data_path={fq}",
                   "data.max_length=256", "trainer.max_epochs=1", "trainer.loggers=csv", f"output_dir={tmp / 'runs'}",
                   "--device", "cpu"])  # fmt: skip
    return tmp, fq, rc


def test_train_cnn_on_the_cpu_then_predict_from_its_checkpoint(cnn_run):
    """The checkpoint holds the BatchNorm buffers: predict --checkpoint gives
    the logits of the model in it, in eval mode."""
    tmp, fq, rc = cnn_run
    assert rc == 0
    best = sorted((tmp / "runs" / "train" / "checkpoints").glob("epoch_*.ckpt"))
    assert best
    state = torch.load(best[-1], weights_only=True)["state_dict"]
    assert "bn_0.running_var" in state and not torch.equal(state["bn_0.running_var"], torch.ones(128))
    rc = cli.main(["predict", str(fq), "--checkpoint", str(best[-1]), "--model", "cnn", "--max-length", "256",
                   "--device", "cpu", "-o", str(tmp / "pred"), "--max-sample", "4"])  # fmt: skip
    assert rc == 0
    shard = np.load(sorted((tmp / "pred" / "0").glob("*.npz"))[0])
    model = build_model("cnn")
    model.load_state_dict(state)
    model.eval()
    ids = torch.from_numpy(shard["seq"]).long()
    raw = shard["qual"].astype(np.float32)
    with torch.no_grad():
        want = model(ids, torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(shard["prediction"], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_train_transformer_on_the_cpu(tmp_path):
    fq = synth_labelled_fastq(tmp_path / "reads.fq", np.full(16, 120), seed=5)
    cfg_args = ["train", "--config", "configs/experiment/transformer.yaml", f"data.train_data_path={fq}",
                "data.max_length=256", "trainer.max_epochs=1", "trainer.loggers=jsonl",
                f"output_dir={tmp_path / 'runs'}", "--device", "cpu"]  # fmt: skip
    assert cli.main(cfg_args) == 0
    row = json.loads((tmp_path / "runs" / "train" / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(row["train/loss"]) and np.isfinite(row["val/loss"])


def test_cnn_refuses_several_ranks(tmp_path):
    """Batch statistics are one device's: fit refuses the CNN on several ranks
    before its first step."""
    fq = synth_labelled_fastq(tmp_path / "reads.fq", np.full(8, 120), seed=6)
    cfg = load_config(None, [f"data.train_data_path={fq}", "model.name=cnn", "data.max_length=256",
                             f"output_dir={tmp_path}", "device=cpu"])  # fmt: skip
    trainer = Trainer(cfg)
    trainer.world = 2
    with pytest.raises(ValueError, match="one rank"):
        trainer.fit()


def test_eval_runs_the_cnn_in_eval_mode(cnn_run):
    """`eval` on the checkpoint: the test split with running statistics; the
    same metrics twice (train-mode BatchNorm would move them)."""
    tmp, fq, _rc = cnn_run
    best = sorted((tmp / "runs" / "train" / "checkpoints").glob("epoch_*.ckpt"))[-1]
    overrides = [f"data.train_data_path={fq}", "data.max_length=256", "model.name=cnn", f"model.checkpoint={best}",
                 f"output_dir={tmp / 'eval'}", "device=cpu"]  # fmt: skip
    first, second = evaluate(load_config(None, overrides)), evaluate(load_config(None, overrides))
    assert first == second and np.isfinite(first["test/loss"])
