"""Caduceus at its full scale, on the CPU: blocks that recompute in their
backward, the recompute policy, and the paths that carry widths past the
32768 ladder top.

- A train step of `caduceus-tiny` and `caduceus-tiny-ps` with k = 0, 1 and
  n_layer blocks recomputed (the backbone's `_recompute` override): loss,
  gradients and the parameters after Adam bitwise equal to k = 0's (the
  recompute runs the same ops on the same inputs), and within the tolerances
  of tests/test_torch_port_caduceus.py of JAX's `value_and_grad` (loss 1e-5
  relative, each leaf 1e-4 of its max|g|). The same under DDP (gloo, one
  rank, two steps): every gradient reaches the comm hook once.
- `recompute_blocks` on the flagship against an 80 GB budget, the budget
  `blocks_to_recompute` takes on a card (its calls mocked), and where
  nothing is recomputed: under no_grad, in eval, on the CPU.
- `default_buckets(131072)` and the engine's plan at (1, 131072) equal the
  JAX package's; train batches at `max_length` 131072 (the JAX module fails
  on a read past 32768 tokens there, ROADMAP queue 3); the CLI's `predict`
  at `--max-length 33024`, the smallest window past the ladder top that a
  256-multiple gives, against the JAX CLI on the same float32 weights.
No model runs at width 131072 here: that width runs on the card
(chip_smoke.py).
"""

from __future__ import annotations

import dataclasses
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepchopper_tpu import cli as jax_cli
from deepchopper_tpu.data import bucketing as jax_bucketing
from deepchopper_tpu.data.parquet_module import DataModule as JaxDataModule
from deepchopper_tpu.infer import PredictEngine as JaxPredictEngine
from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.classifier import CaduceusTokenClassifier as JaxClassifier
from deepchopper_tpu.models.registry import DeepChopper as JaxDeepChopper
from deepchopper_tpu.models.registry import ModelBundle, init_params
from deepchopper_tpu.train import loss as jax_loss
from deepchopper_tpu_torch import cli
from deepchopper_tpu_torch.data import bucketing
from deepchopper_tpu_torch.data.parquet_module import DataModule
from deepchopper_tpu_torch.data.synth import synth_labelled_fastq
from deepchopper_tpu_torch.infer.engine import PredictEngine
from deepchopper_tpu_torch.models import bridge, caduceus
from deepchopper_tpu_torch.models.classifier import CaduceusTokenClassifier
from deepchopper_tpu_torch.models.config import CaduceusConfig, HeadConfig
from deepchopper_tpu_torch.models.registry import DeepChopper
from deepchopper_tpu_torch.train.loss import loss_counts
from deepchopper_tpu_torch.train.step import make_optimizer, train_step

GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
MARGIN = 1e-4
FLAGSHIP = dict(n_layer=16, d_model=256)
GB = 1e9


def _port_config(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny models: beside the suite's other
    workers on the same cores, more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tiny_configs(tied: bool):
    backbone = jax_config.CADUCEUS_TINY if tied else jax_config.CADUCEUS_TINY_PS
    head = jax_config.HeadConfig(input_size=64, lin1_size=128, lin2_size=128)
    return dataclasses.replace(backbone, compute_dtype="float32"), dataclasses.replace(head, compute_dtype="float32")


def _tiny_pair(tied: bool):
    """(JAX module, params, port module) of caduceus-tiny(-ps) at float32 with
    the same weights (tests/test_torch_port_caduceus.py's); the JAX params
    are made once a file, the port module anew."""
    bb32, hd32 = _tiny_configs(tied)
    jax_mod = JaxClassifier(backbone_config=bb32, head_config=hd32)
    if ("params", tied) not in _RUNS:
        _RUNS["params", tied] = init_params(jax_mod, seed=1, seq_len=8)
    params = _RUNS["params", tied]
    port = CaduceusTokenClassifier(_port_config(CaduceusConfig, bb32), _port_config(HeadConfig, hd32))
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    return jax_mod, params, port


def _batch(batch: int, seq_len: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 12, (batch, seq_len)).astype(np.int32)
    quals = rng.integers(5, 40, (batch, seq_len)).astype(np.float32)
    labels = (rng.random((batch, seq_len)) < 0.3).astype(np.int32)
    ids[-1, seq_len // 2 :], quals[-1, seq_len // 2 :], labels[-1, seq_len // 2 :] = 4, 0, -100
    quals /= np.sqrt((quals * quals).sum(-1, keepdims=True))
    return ids, quals, labels


def _port_step(tied: bool, k: int, ddp: bool = False):
    """One port train step (lambda 0.5, Adam 1e-3) with k blocks recomputed:
    (loss, gradients, parameters after the step)."""
    key = (tied, k, ddp)
    if key not in _RUNS:
        _jax_mod, _params, port = _tiny_pair(tied)
        port.train().backbone._recompute = k
        ids, quals, labels = _batch(2, 128, seed=11)
        batch = {"input_ids": torch.from_numpy(ids).long(), "input_quals": torch.from_numpy(quals),
                 "labels": torch.from_numpy(labels).long()}  # fmt: skip
        opt = make_optimizer(port.parameters(), 1e-3)
        if ddp:
            from deepchopper_tpu_torch.train.loop import data_parallel

            model = data_parallel(port, torch.device("cpu"))
            counts = loss_counts(labels)
            train_step(model, opt, batch, 0.5, counts=counts)  # a second step shows each gradient came once
            out = train_step(model, opt, batch, 0.5, counts=counts)
        else:
            out = train_step(port, opt, batch, 0.5)
        _RUNS[key] = (out["loss"], {n: p.grad.clone() for n, p in port.named_parameters()},
                      {n: p.detach().clone() for n, p in port.named_parameters()})  # fmt: skip
    return _RUNS[key]


def _jax_grads(tied: bool):
    key = ("jax", tied)
    if key not in _RUNS:
        jax_mod, params, _port = _tiny_pair(tied)
        ids, quals, labels = _batch(2, 128, seed=11)

        def loss_fn(p):
            logits = jax_mod.apply({"params": p}, jnp.asarray(ids), jnp.asarray(quals))
            return jax_loss.continuous_interval_loss(logits, jnp.asarray(labels), 0.5)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        _RUNS[key] = (float(loss), bridge.flax_to_state_dict(jax.tree.map(np.asarray, grads)))
    return _RUNS[key]


# -- blocks that recompute in their backward ------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("tied", [True, False], ids=["ph", "ps"])
def test_recomputed_train_step_is_bitwise_and_matches_jax(tied, k):
    loss, grads, params = _port_step(tied, k)
    loss0, grads0, params0 = _port_step(tied, 0)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name
        assert torch.equal(params[name], params0[name]), name
    want_loss, want = _jax_grads(tied)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert want.keys() == grads.keys()
    for name, w in want.items():
        scale = float(w.abs().max())
        assert float((grads[name] - w).abs().max()) <= GRAD_TOL * scale, name


@pytest.fixture
def one_gloo_rank():
    """A gloo process group of one rank in this process, destroyed after."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("tied", [True, False], ids=["ph", "ps"])
def test_ddp_step_with_every_block_recomputed(one_gloo_rank, tied):
    """DDP with the summing comm hook over non-reentrant checkpoints: two
    steps run (DDP raises on a gradient marked ready twice or never), and the
    second equals two plain steps bitwise."""
    loss, grads, params = _port_step(tied, 2, ddp=True)
    _jax_mod, _params, port = _tiny_pair(tied)
    port.train()
    ids, quals, labels = _batch(2, 128, seed=11)
    batch = {"input_ids": torch.from_numpy(ids).long(), "input_quals": torch.from_numpy(quals),
             "labels": torch.from_numpy(labels).long()}  # fmt: skip
    opt = make_optimizer(port.parameters(), 1e-3)
    train_step(port, opt, batch, 0.5)
    want = train_step(port, opt, batch, 0.5)
    assert torch.equal(loss, want["loss"])
    for name, p in port.named_parameters():
        assert torch.equal(grads[name], p.grad), name
        assert torch.equal(params[name], p.detach()), name


def test_nothing_is_recomputed_under_no_grad_in_eval_or_by_the_cpu_policy(monkeypatch):
    calls = []

    def counted(fn, *args, **kwargs):
        calls.append(kwargs)
        return fn(*args)

    monkeypatch.setattr(caduceus, "checkpoint", counted)
    model = DeepChopper.new("caduceus-tiny", seed=0, device="cpu")
    ids, quals = torch.full((2, 64), 8), torch.rand(2, 64)
    backbone = model.backbone
    backbone._recompute = 2
    model.train()(ids, quals)
    assert calls == [{"use_reentrant": False, "preserve_rng_state": False}] * 2
    with torch.no_grad():
        model(ids, quals)
    model.eval()(ids, quals)
    assert len(calls) == 2
    backbone._recompute = 7  # clamped to n_layer
    model.train()(ids, quals)
    assert len(calls) == 4
    backbone._recompute = None
    model(ids, quals)
    assert len(calls) == 4 and backbone._recompute_k == {(2, 64): 0}


# -- the policy -------------------------------------------------------------------------


def test_recompute_blocks_on_the_flagship():
    budget = 80 * GB
    assert caduceus.recompute_blocks(64, 1024, budget_bytes=budget, **FLAGSHIP) == 0
    assert caduceus.recompute_blocks(2, 32768, budget_bytes=budget, **FLAGSHIP) == 0
    for shape in ((128, 1024), (4, 32768), (1, 131072)):
        assert 0 < caduceus.recompute_blocks(*shape, budget_bytes=budget, **FLAGSHIP) <= 16, shape
    ks = [caduceus.recompute_blocks(1, tokens, budget_bytes=budget, **FLAGSHIP) for tokens in range(1 << 14, 3 << 16, 1 << 12)]
    assert ks == sorted(ks) and ks[0] == 0 and ks[-1] > ks[len(ks) // 2]
    assert caduceus.recompute_blocks(1, 131072, budget_bytes=budget, **FLAGSHIP) == caduceus.recompute_blocks(
        128, 1024, budget_bytes=budget, **FLAGSHIP)  # fmt: skip
    for k, fewer in zip(range(16), range(1, 17)):  # each block recomputed lowers the estimate
        assert caduceus.step_bytes(1 << 17, 16, fewer) < caduceus.step_bytes(1 << 17, 16, k)


def test_recompute_blocks_raises_where_no_k_fits():
    need = caduceus.step_bytes(1 << 17, 16, 16)
    assert caduceus.recompute_blocks(1, 131072, 16, need) == 16
    with pytest.raises(torch.OutOfMemoryError, match=r"131072 tokens \(1 x 131072\).*all 16 blocks.*budget of 1\.00 GB"):
        caduceus.recompute_blocks(1, 131072, 16, 1 * GB)


def test_blocks_to_recompute_takes_the_card_budget_once_a_shape(monkeypatch):
    """On a card the budget is MEMORY_MARGIN of its memory less what is
    allocated when the forward starts; the choice is kept per (B, L)."""
    allocated = [2 * GB]
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(total_memory=85 * GB))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: allocated[0])
    backbone = caduceus.CaduceusBackbone(CaduceusConfig())
    cuda = torch.device("cuda")
    budget = 85 * GB * caduceus.MEMORY_MARGIN - 2 * GB
    want = caduceus.recompute_blocks(128, 1024, 16, budget)
    assert 0 < want < 16
    assert backbone.blocks_to_recompute(128, 1024, cuda) == want
    allocated[0] = 40 * GB
    assert backbone.blocks_to_recompute(128, 1024, cuda) == want  # kept for the shape
    assert backbone.blocks_to_recompute(4, 32768, cuda) == caduceus.recompute_blocks(4, 32768, 16,
                                                                                     budget - 38 * GB)  # fmt: skip
    assert backbone.blocks_to_recompute(64, 1024, torch.device("cpu")) == 0
    backbone._recompute = 3
    assert backbone.blocks_to_recompute(128, 1024, cuda) == 3


# -- widths past the ladder top ------------------------------------------------------------


def test_buckets_and_dispatch_plan_at_131072_are_jax_s():
    assert bucketing.default_buckets(131072) == jax_bucketing.default_buckets(131072)
    assert bucketing.default_buckets(131072) == [*bucketing.default_buckets(), 131072]
    jax_mod, params, port = _tiny_pair(True)
    jax_engine = JaxPredictEngine(ModelBundle(module=jax_mod, params=params, name="caduceus-tiny",
                                              config=jax_mod.backbone_config), max_length=131072)  # fmt: skip
    port_engine = PredictEngine(port, max_length=131072, device="cpu")
    assert port_engine.buckets == jax_engine.buckets
    for w in port_engine.buckets:
        assert port_engine._row_variants(w) == jax_engine._row_variants(w), w
    assert port_engine._row_variants(131072) == [1]
    assert port_engine._plan_dispatches(1, 131072) == jax_engine._plan_dispatches(1, 131072) == [(0, 1, 1)]


def _long_reads(tmp_path):
    return synth_labelled_fastq(tmp_path / "long.fq", np.array([500, 40000, 700, 140000, 90000, 131072]), seed=0)


def test_train_batches_at_131072_append_the_window(tmp_path):
    fq = str(_long_reads(tmp_path))
    kw = dict(train_data_path=fq, val_data_path=fq, test_data_path=fq, max_length=131072)
    batches = list(DataModule(**kw).train_batches(0))
    wide = [b for b in batches if b.input_ids.shape[1] == 131072]
    assert sorted(b.input_ids.shape for b in batches) == [(1, 512), (1, 768)] + [(1, 131072)] * 4
    assert sorted((int(b.lengths[0]), int(b.ids[0, 1])) for b in wide) == [(40001, 0), (90001, 0), (131072, 1),
                                                                          (131072, 1)]  # fmt: skip
    # The JAX module batches on the bare ladder: the 40001-token read does not fit its clamped 32768 bucket.
    with pytest.raises(ValueError, match="could not broadcast"):
        list(JaxDataModule(**kw).train_batches(0))
    for max_length in (32768, 1000):  # at or below the ladder top: the JAX module's batches
        kw["max_length"] = max_length
        got, want = list(DataModule(**kw).train_batches(0)), list(JaxDataModule(**kw).train_batches(0))
        assert [b.input_ids.shape for b in got] == [b.input_ids.shape for b in want]
        for g, w in zip(got, want):
            for key in ("input_ids", "labels", "quals", "ids", "lengths"):
                np.testing.assert_array_equal(getattr(g, key), getattr(w, key), err_msg=key)


def test_cli_predict_past_the_ladder_matches_the_jax_cli(tmp_path, monkeypatch):
    """`predict --max-length 33024` at float32 in both CLIs, on the same JAX
    random-init weights: caduceus-tiny's (the tiny head of the tests above)
    cut to its first layer, to keep the plain scan's CPU time at this width
    small. One read past 32768 bases (40000): dispatched as one row of the
    appended 33024 bucket, truncated and flagged. Shards: targets, tokens,
    quals and ids (the truncation flag) exact; logits within 1e-4 of
    max|logit|; labels (argmax) the same beyond a 1e-4 margin."""
    jax_mod, params, _port = _tiny_pair(True)
    bb1 = dataclasses.replace(jax_mod.backbone_config, n_layer=1)
    params1 = {**params, "backbone": {k: v for k, v in params["backbone"].items() if k != "block_1"}}
    jax_mod = JaxClassifier(backbone_config=bb1, head_config=jax_mod.head_config)
    jax_bundle = ModelBundle(module=jax_mod, params=params1, name="caduceus-tiny", config=bb1)
    port = CaduceusTokenClassifier(_port_config(CaduceusConfig, bb1), _port_config(HeadConfig, jax_mod.head_config))
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params1))
    monkeypatch.setattr(JaxDeepChopper, "from_pretrained", staticmethod(lambda *a, **k: jax_bundle))
    monkeypatch.setattr(DeepChopper, "from_pretrained", staticmethod(lambda *a, **k: port.eval()))
    fq = synth_labelled_fastq(tmp_path / "reads.fq", np.array([40000]), seed=4)
    argv = ["predict", str(fq), "--model", "caduceus-tiny", "--random-init", "--max-length", "33024", "-o"]
    assert jax_cli.main([*argv, str(tmp_path / "jax")]) == 0
    assert cli.main([*argv, str(tmp_path / "port"), "--device", "cpu"]) == 0
    jax_shards, port_shards = sorted((tmp_path / "jax" / "0").glob("*.npz")), sorted((tmp_path / "port" / "0").glob("*.npz"))
    assert [p.name for p in port_shards] == [p.name for p in jax_shards]
    flags = []
    for pj, pp in zip(jax_shards, port_shards):
        ref, got = np.load(pj), np.load(pp)
        for key in ("target", "seq", "qual", "id"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{pp.name}:{key}")
        pr, pg = ref["prediction"], got["prediction"]
        assert pg.shape == pr.shape and np.abs(pg - pr).max() <= LOGIT_TOL * np.abs(pr).max(), pp.name
        sure = np.abs(pr[..., 1] - pr[..., 0]) > MARGIN
        np.testing.assert_array_equal(pg.argmax(-1)[sure], pr.argmax(-1)[sure], err_msg=pp.name)
        width = ref["seq"].shape[1]
        flags += [(width, int(flag)) for flag in ref["id"][:, 1]]
    assert flags == [(33024, 1)]
