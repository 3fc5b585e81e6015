"""The port engine's dispatch plan and planned predict vs the JAX engine, on the CPU.

`PredictEngine._row_variants` and `_plan_dispatches` of the port must return
exactly the JAX engine's values (`deepchopper_tpu/infer/engine.py:290, :628`,
its mesh and streaming-warmup branches aside): on the cases of
`tests/test_pipeline_engine.py` and on a hypothesis sweep over the batch rows,
the width, tokens_per_batch, max_batch and `DEEPCHOPPER_ROW_VARIANTS`. The
JAX engine is built as that test builds it (`hyenadna-tiny-1k-seqlen`);
planning compiles nothing.

Then `predict_file` on `hyenadna-tiny-1k-seqlen` and `caduceus-tiny` at
float32, with the JAX weights bridged into the port: 45 reads in the 256
bucket at 8192 tokens a batch make one full batch of 32 rows and a tail of 13
that decomposes into 8 + 2 + 2 rows and 1 row padded to 2. Both engines must
dispatch the same shapes, and each shard must agree with the JAX engine's:
target, seq, qual and id exactly, logits within 1e-4 of max|logit| (float32
rounding through the layers, as tests/test_torch_port_predict.py) and the
same argmax wherever the JAX logits' margin exceeds 1e-4.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepchopper_tpu.infer import PredictEngine as JaxPredictEngine
from deepchopper_tpu.models.registry import DeepChopper as JaxDeepChopper
from deepchopper_tpu.models.registry import ModelBundle
from deepchopper_tpu_torch.infer.engine import PredictEngine
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models.classifier import CaduceusTokenClassifier, HyenaTokenClassifier
from deepchopper_tpu_torch.models.config import CaduceusConfig, HeadConfig, HyenaConfig

LOGIT_TOL = 1e-4
MARGIN = 1e-4
TINY = "hyenadna-tiny-1k-seqlen"


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) with the JAX test's settings; the sweep
    sets tokens_per_batch and max_batch on both."""
    jax_engine = JaxPredictEngine(JaxDeepChopper.new(TINY, seed=0), max_length=1024, tokens_per_batch=1 << 18)
    port_engine = PredictEngine(HyenaTokenClassifier(HyenaConfig(d_model=8, n_layer=1), HeadConfig(input_size=8)),
                                max_length=1024, tokens_per_batch=1 << 18, device="cpu")  # fmt: skip
    return jax_engine, port_engine


def _same_plan(jax_engine, port_engine, b: int, w: int) -> list[tuple[int, int, int]]:
    variants = port_engine._row_variants(w)
    assert variants == jax_engine._row_variants(w)
    plan = port_engine._plan_dispatches(b, w)
    assert plan == jax_engine._plan_dispatches(b, w)
    # The parts cover the rows once, in order, each at a variant or at b.
    assert [s for s, _r, _t in plan] == [sum(r for _s, r, _t in plan[:i]) for i in range(len(plan))]
    assert sum(r for _s, r, _t in plan) == b
    assert all(r <= t and (t in variants or t == b) for _s, r, t in plan)
    return plan


@pytest.mark.parametrize(
    "b,want",
    [(256, [(0, 256, 256)]), (5, [(0, 5, 16)]), (100, [(0, 64, 64), (64, 16, 16), (80, 16, 16), (96, 4, 16)]),
     (63, [(0, 63, 64)]), (64, [(0, 64, 64)]), (257, [(0, 257, 257)]), (1, [(0, 1, 16)]), (16, [(0, 16, 16)]),
     (200, [(0, 64, 64), (64, 64, 64), (128, 64, 64), (192, 8, 16)])],
)  # fmt: skip
def test_plan_matches_jax_on_the_jax_tests_cases(engines, b, want):
    """The JAX test's cases (variants [16, 64, 256] at w 1024), an oversized
    batch and the edges of the smallest variant."""
    jax_engine, port_engine = engines
    port_engine.tokens_per_batch = jax_engine.tokens_per_batch = 1 << 18
    port_engine.max_batch = jax_engine.max_batch = 512
    assert port_engine._row_variants(1024) == [16, 64, 256]
    assert _same_plan(jax_engine, port_engine, b, 1024) == want


@pytest.mark.parametrize("env", [None, "", "2,4,8,16", "3", "16,4", "1"])
def test_row_variants_follow_the_environment_as_jax(engines, env):
    jax_engine, port_engine = engines
    port_engine.tokens_per_batch = jax_engine.tokens_per_batch = 1 << 17
    port_engine.max_batch = jax_engine.max_batch = 512
    patch = {"DEEPCHOPPER_ROW_VARIANTS": env} if env is not None else {}
    with mock.patch.dict(os.environ, patch):
        if env is None:
            os.environ.pop("DEEPCHOPPER_ROW_VARIANTS", None)
        for w in (256, 768, 1024, 5120, 32768):
            assert port_engine._row_variants(w) == jax_engine._row_variants(w)


@settings(max_examples=400, deadline=None)
@given(
    b=st.integers(1, 1100),
    w=st.one_of(st.sampled_from([256, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072, 4096, 5120, 6144, 8192, 12288,
                                 16384, 24576, 32768]), st.integers(1, 70000)),
    tokens=st.integers(1, 1 << 19),
    max_batch=st.integers(1, 1024),
    divs=st.one_of(st.none(), st.lists(st.integers(1, 40), max_size=5)),
)  # fmt: skip
def test_plan_matches_jax_on_a_sweep(engines, b, w, tokens, max_batch, divs):
    jax_engine, port_engine = engines
    port_engine.tokens_per_batch = jax_engine.tokens_per_batch = tokens
    port_engine.max_batch = jax_engine.max_batch = max_batch
    env = {} if divs is None else {"DEEPCHOPPER_ROW_VARIANTS": ",".join(map(str, divs))}
    with mock.patch.dict(os.environ, env):
        if divs is None:
            os.environ.pop("DEEPCHOPPER_ROW_VARIANTS", None)
        _same_plan(jax_engine, port_engine, b, w)


# -- planned predict vs the JAX engine -------------------------------------------------


def _write_reads(path: Path, n: int = 45, seed: int = 11) -> Path:
    """n reads of 60-250 bases (all in the 256 bucket); every third one
    annotated with an adapter region."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        for i in range(n):
            length = int(rng.integers(60, 251))
            seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), length, p=[0.24, 0.24, 0.24, 0.24, 0.04])
            qual = rng.integers(33 + 3, 33 + 41, length).astype(np.uint8)
            rid = f"plan_{i}" + (f"|{length // 4}:{length // 2}" if i % 3 == 0 else "")
            fh.write(b"@" + rid.encode() + b"\n" + seq.tobytes() + b"\n+\n" + qual.tobytes() + b"\n")
    return path


def _port_config(cls, jax_cfg):
    """The port's config with the JAX config's values, field by field."""
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


def _float32_pair(name: str, port_cls, port_cfg_cls):
    """(JAX bundle, port model) of a registry model at float32, with the
    JAX random-init weights (seed 0) bridged into the port."""
    bundle = JaxDeepChopper.new(name, seed=0)
    bb32 = dataclasses.replace(bundle.module.backbone_config, compute_dtype="float32")
    hd32 = dataclasses.replace(bundle.module.head_config, compute_dtype="float32")
    module = type(bundle.module)(backbone_config=bb32, head_config=hd32)
    jax_bundle = ModelBundle(module=module, params=bundle.params, name=name, config=bb32)
    port = port_cls(_port_config(port_cfg_cls, bb32), _port_config(HeadConfig, hd32))
    bridge.load_flax_params(port, jax.tree.map(np.asarray, bundle.params))
    return jax_bundle, port


def _shards(d: Path) -> list[Path]:
    return sorted(d.glob("0/*.npz"), key=lambda p: int(p.stem.split("_")[1]))


@pytest.mark.parametrize(
    "name,port_cls,port_cfg_cls",
    [(TINY, HyenaTokenClassifier, HyenaConfig), ("caduceus-tiny", CaduceusTokenClassifier, CaduceusConfig)],
)
def test_planned_predict_matches_jax_engine(tmp_path, name, port_cls, port_cfg_cls, monkeypatch):
    monkeypatch.delenv("DEEPCHOPPER_ROW_VARIANTS", raising=False)
    fq = _write_reads(tmp_path / "reads.fq")
    jax_bundle, port = _float32_pair(name, port_cls, port_cfg_cls)
    kw = dict(max_length=1024, tokens_per_batch=8192)
    jax_stats = JaxPredictEngine(jax_bundle, **kw).predict_file(fq, tmp_path / "jax")
    engine = PredictEngine(port, device="cpu", **kw)
    assert engine._row_variants(256) == [2, 8, 32]
    assert engine._plan_dispatches(13, 256) == [(0, 8, 8), (8, 2, 2), (10, 2, 2), (12, 1, 2)]
    stats = engine.predict_file(fq, tmp_path / "port")
    assert (stats.reads, stats.batches) == (45, 2)
    assert stats.shape_counts == jax_stats.shape_counts == {(32, 256): 1, (8, 256): 1, (2, 256): 3}
    assert stats.padded_tokens == jax_stats.padded_tokens == (32 + 8 + 2 * 3) * 256
    assert stats.dispatches == 5 and stats.captures == 0 and stats.compile_s == 0.0
    jax_shards, port_shards = _shards(tmp_path / "jax"), _shards(tmp_path / "port")
    assert [p.name for p in port_shards] == [p.name for p in jax_shards] and len(port_shards) == 2
    for pj, pp in zip(jax_shards, port_shards):
        ref, got = np.load(pj), np.load(pp)
        for key in ("target", "seq", "qual", "id"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{pp.name}:{key}")
        pr, pg = ref["prediction"], got["prediction"]
        assert pg.shape == pr.shape and pg.dtype == np.float32
        err = np.abs(pg - pr).max()
        assert err <= LOGIT_TOL * np.abs(pr).max(), f"{pp.name}: {err:.3e} vs max|ref| {np.abs(pr).max():.3e}"
        sure = np.abs(pr[..., 1] - pr[..., 0]) > MARGIN
        assert (pg.argmax(-1)[sure] == pr.argmax(-1)[sure]).all(), pp.name


def test_planned_outputs_equal_one_eager_step_per_batch():
    """Decomposed and padded dispatches reassemble to the logits of one
    unplanned step over the whole batch (rows are independent; float32
    matmuls of another row count may round otherwise, so within 1e-5 of
    max|logit|), and the labels path to their argmax."""
    from deepchopper_tpu_torch.data.bucketing import Batch

    model = HyenaTokenClassifier(HyenaConfig(d_model=16, n_layer=1, max_seq_len=258, compute_dtype="float32"),
                                 HeadConfig(input_size=16, compute_dtype="float32"))  # fmt: skip
    model.reset_parameters(torch.Generator().manual_seed(0))
    engine = PredictEngine(model, max_length=256, tokens_per_batch=8192, device="cpu")
    labels_engine = PredictEngine(model, max_length=256, tokens_per_batch=8192, return_labels=True, device="cpu")
    rng = np.random.default_rng(3)
    for b, parts in ((32, 1), (13, 4), (7, 1), (1, 1)):
        ids = rng.integers(7, 12, (b, 256)).astype(np.int32)
        quals = rng.integers(0, 41, (b, 256)).astype(np.uint8)
        batch = Batch(input_ids=ids, labels=ids, quals=quals.astype(np.float32), ids=np.zeros((b, 256), np.int32),
                      lengths=np.full(b, 256, np.int32), read_ids=[str(i) for i in range(b)], quals_raw=quals)  # fmt: skip
        assert len(engine._plan_dispatches(b, 256)) == parts
        ((_, got),) = engine.predict_batches(iter([batch]), prefetch=0)
        ((_, labels),) = labels_engine.predict_batches(iter([batch]), prefetch=0)
        want = engine.step(torch.from_numpy(ids.astype(np.int8)), torch.from_numpy(quals)).numpy()
        assert got.dtype == np.float32 and got.shape == (b, 256, 2) and labels.shape == (b, 256)
        assert np.isfinite(want).all()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), b
        np.testing.assert_array_equal(labels, got.argmax(-1).astype(np.int8))


@pytest.mark.parametrize("route_env", [{}, {"DEEPCHOPPER_FUSE_SHORT": "0"}, {"DEEPCHOPPER_FUSE_INPROJ": "1"}])
def test_width_memo_is_the_plain_forward(route_env, monkeypatch):
    """The engine keeps each width's long filters (and their spectra) in the
    model's memo: the logits are bitwise those of a forward without it, at
    two widths and on every Hyena route; the memo holds one filter per layer
    and width, computed once, and the graph key is the route."""
    from deepchopper_tpu_torch.models.hyena import mixer_route
    from deepchopper_tpu_torch.ops import mixer

    for k, v in route_env.items():
        monkeypatch.setenv(k, v)
    model = HyenaTokenClassifier(HyenaConfig(d_model=16, n_layer=2, max_seq_len=1026, compute_dtype="float32"),
                                 HeadConfig(input_size=16, compute_dtype="float32"))  # fmt: skip
    model.reset_parameters(torch.Generator().manual_seed(1))
    engine = PredictEngine(model, max_length=1024, device="cpu")
    rng = np.random.default_rng(4)
    for width in (256, 1024, 256):
        ids = torch.from_numpy(rng.integers(7, 12, (3, width)).astype(np.int8))
        quals = torch.from_numpy(rng.integers(0, 41, (3, width)).astype(np.uint8))
        got = engine.step(ids, quals)
        q = quals.float()
        q = q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=1e-12)
        with torch.inference_mode():
            want = model(ids.long(), q).float()
        assert torch.equal(got, want), width
        assert model.graph_key(width) == mixer_route(16, width)
    assert sorted(width for _op, width in engine._memo) == [256, 256, 1024, 1024]
    for k_long, bias in engine._memo.values():
        n = mixer.fft_size(k_long.shape[0])
        assert mixer.filter_spectrum(k_long, bias, n) is mixer.filter_spectrum(k_long, bias, n)
        assert torch.equal(mixer.filter_spectrum(k_long, bias, n), mixer.filter_spectrum(k_long.clone(), bias, n))


def test_every_op_counter_is_registered():
    """CUDA graph replays add their launches through `_build.COUNTERS`: every
    op module's launch counter must be in it."""
    from deepchopper_tpu_torch.ops import _build, conv, gated, inproj, mixer, scan, setup

    for module in (conv, gated, inproj, mixer, scan, setup):
        assert any(c is module.launch_counts for c in _build.COUNTERS), module.__name__
