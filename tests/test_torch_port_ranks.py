"""The port's data-parallel ranks vs the JAX package, on the CPU with gloo.

The counterparts of `tests/test_multihost.py` and of the JAX trainer's
batch-sharded mesh:
- in-process shards: ranks 0 and 1 predict their `shard=(r, 2)` slices
  into one directory; `chop` over it gives the bytes of the one-rank run and
  of the JAX package's sharded run on the same bridged float32 weights;
- the shard-parallel chop (`multihost_stream_chop`, nprocs 2, a no-op
  barrier) gives the bytes of JAX's on the same predicts, and the records of
  the one-rank chop; a missing sidecar raises and leaves no part behind;
- two real processes (one launch, `RANK_SCRIPT`): gloo ranks set up from the
  `DC_*` variables, then from torchrun's, hold `process_shard_info`,
  `barrier` and `all_reduce_sum`; `predict --fused-chop` through the CLI
  merges to the records of the one-rank CLI run; one DDP train step on a
  global batch whose two row blocks hold 256 and 64 valid labels is held
  to JAX's single-device step and to the port's one-rank step, with and
  without the clip, and DDP's default average fails the JAX comparison;
  the trainer resumes from the CLI run's checkpoint on both ranks;
- `train trainer.n_devices=2 --device cpu` through the CLI (which spawns its
  ranks): one set of checkpoints and logs, from rank 0, and the metrics of
  the one-rank run.

Limits: losses 1e-5 relative to JAX (PERF.md section 2), gradient leaves 1e-4
of their max|g|, the Adam step's parameters 1e-4 of each leaf's max|p| (one
Adam step at lr 1e-3: g / (|g| + 1e-8) amplifies rounding only where |g| is
near 1e-8); the one-rank port step 1e-6 of each leaf's max; stats exactly.
Each multi-process launch has a timeout, so a hang fails its test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gzip
import json
import logging
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepchopper_tpu.chop import ChopOptions as JaxChopOptions
from deepchopper_tpu.chop.pipeline import multihost_stream_chop as jax_multihost_stream_chop
from deepchopper_tpu.chop.pipeline import run_chop as jax_run_chop
from deepchopper_tpu.infer import PredictEngine as JaxPredictEngine
from deepchopper_tpu.io.predicts import load_predicts_from_batch_pts as jax_load_predicts
from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.classifier import HyenaTokenClassifier as JaxClassifier
from deepchopper_tpu.models.registry import ModelBundle, init_params
from deepchopper_tpu.train import loss as jax_loss
from deepchopper_tpu_torch import cli, parallel
from deepchopper_tpu_torch.chop import ChopOptions, multihost_stream_chop, run_chop
from deepchopper_tpu_torch.data.synth import synth_labelled_fastq
from deepchopper_tpu_torch.infer.engine import PredictEngine
from deepchopper_tpu_torch.io.bgzf import BGZF_EOF
from deepchopper_tpu_torch.io.predicts import load_predicts_from_batch_pts
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
from deepchopper_tpu_torch.models.config import HeadConfig, HyenaConfig
from deepchopper_tpu_torch.train.config import load_config
from deepchopper_tpu_torch.train.loop import rank_block, train, world_size
from deepchopper_tpu_torch.train.loss import loss_counts
from deepchopper_tpu_torch.train.step import make_optimizer, train_step

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120  # seconds a multi-process launch may take before its test fails
LR, LAM, CLIP = 1e-3, 0.5, 0.05


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_fastq(path: Path, rng, n: int = 40, min_len: int = 60, max_len: int = 400) -> Path:
    with open(path, "wb") as fh:
        for i in range(n):
            length = int(rng.integers(min_len, max_len))
            seq = "".join(rng.choice(list("ACGT"), length))
            qual = "".join(chr(c) for c in rng.integers(38, 70, length))
            fh.write(b"@mh_%d\n%s\n+\n%s\n" % (i, seq.encode(), qual.encode()))
    return path


def _records(path) -> list[tuple[bytes, ...]]:
    lines = gzip.open(path, "rb").read().splitlines()
    assert len(lines) % 4 == 0
    return sorted(tuple(lines[i : i + 4]) for i in range(0, len(lines), 4))


def _port_config(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


@functools.cache
def _narrow():
    """(JAX module, params, port backbone config, port head config) of a
    narrow float32 Hyena (JAX arrays are immutable: one init serves every
    test)."""
    backbone = jax_config.HyenaConfig(d_model=64, n_layer=2, d_inner=128, max_seq_len=1026, compute_dtype="float32")
    head = jax_config.HeadConfig(input_size=64, lin1_size=128, lin2_size=128, compute_dtype="float32")
    module = JaxClassifier(backbone_config=backbone, head_config=head)
    params = init_params(module, seed=1)
    return module, params, _port_config(HyenaConfig, backbone), _port_config(HeadConfig, head)


def _port_model(bb, hd, params) -> HyenaTokenClassifier:
    port = HyenaTokenClassifier(bb, hd)
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    return port.train()


# -- host pieces -------------------------------------------------------------


def test_rank_block_pads_and_splits_rows_as_a_batch_sharding():
    a = np.arange(5 * 3).reshape(5, 3)
    blocks = [rank_block(a, -1, r, 2) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(blocks)[:5], a)
    np.testing.assert_array_equal(blocks[1][-1], [-1, -1, -1])
    assert [len(b) for b in blocks] == [3, 3]
    assert [len(rank_block(a, 0, r, 4)) for r in range(4)] == [2, 2, 2, 2]


def test_loss_counts_split_across_row_blocks():
    labels = np.array([[0, 1, -100, 1], [1, 1, 1, 1], [-100] * 4])
    assert loss_counts(labels) == (7, 4)
    parts = [loss_counts(rank_block(labels, -100, r, 2)) for r in range(2)]
    assert tuple(map(sum, zip(*parts))) == loss_counts(labels)


def test_one_process_sets_up_no_group(monkeypatch):
    for name in ("DC_NUM_PROCESSES", "WORLD_SIZE", "DC_PROCESS_ID", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert parallel.launched_world() == 1
    assert not parallel.initialize_distributed(device="cpu")
    assert parallel.process_shard_info() == (0, 1)
    parallel.barrier("alone")
    assert float(parallel.all_reduce_sum(torch.tensor([2.0]))) == 2.0


def test_world_size_follows_n_devices():
    cfg = load_config(None, ["device=cpu"])
    assert world_size(cfg) == 1
    assert world_size(load_config(None, ["device=cpu", "trainer.n_devices=3"])) == 3
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from deepchopper_tpu_torch.device import DeviceUnavailable

    with pytest.raises(DeviceUnavailable):
        world_size(load_config(None, ["device=cuda"]))
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        world_size(load_config(None, ["device=cuda", "trainer.n_devices=2"]))


@pytest.mark.parametrize(
    "env, card",
    [
        # JAX's DC_PROCESS_ID is a global index, one process a host: no card.
        ({"DC_NUM_PROCESSES": "2", "DC_PROCESS_ID": "1"}, 0),
        # A LOCAL_RANK left in the environment of one process names no card.
        ({"LOCAL_RANK": "1"}, 0),
        ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}, 1),
    ],
)
def test_card_index_is_local_rank_inside_a_launch_only(monkeypatch, env, card):
    from deepchopper_tpu_torch.device import resolve_device

    for name in ("DC_NUM_PROCESSES", "WORLD_SIZE", "DC_PROCESS_ID", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device("cuda") == torch.device("cuda", card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if card:
        with pytest.raises(ValueError, match="local rank 1 has no card"):
            resolve_device("cuda")
    else:
        assert resolve_device("cuda") == torch.device("cuda", 0)


def test_trainer_takes_its_ranks_from_the_process_group(tmp_path):
    from deepchopper_tpu_torch.train.loop import Trainer

    fq = synth_labelled_fastq(tmp_path / "reads.fq", np.full(8, 200), seed=0)
    overrides = ["device=cpu", f"data.train_data_path={fq}", f"output_dir={tmp_path}"]
    assert Trainer(load_config(None, overrides)).world == 1
    with pytest.raises(ValueError, match="trainer.n_devices=2 and this process is one of 1 ranks"):
        Trainer(load_config(None, [*overrides, "trainer.n_devices=2"]))


def test_ranked_logger_prefixes_the_rank_and_drops_other_ranks(caplog, monkeypatch):
    from deepchopper_tpu_torch.utils import RankedLogger

    caplog.set_level(logging.INFO, logger="ranks-test")
    RankedLogger("ranks-test").info("hello %d", 1)
    monkeypatch.setattr(RankedLogger, "_rank", staticmethod(lambda: 1))
    RankedLogger("ranks-test", rank_zero_only=True).info("dropped")
    RankedLogger("ranks-test").warning("kept")
    assert [r.getMessage() for r in caplog.records] == ["[rank 0] hello 1", "[rank 1] kept"]


def test_suppress_warnings_adds_and_removes_only_its_filters():
    import warnings

    from deepchopper_tpu_torch.utils import suppress_warnings

    suppress_warnings(verbose=True)  # drop what an earlier call in this process installed
    before = list(warnings.filters)
    try:
        suppress_warnings()
        assert len(warnings.filters) > len(before)
        with warnings.catch_warnings(record=True) as seen:
            warnings.filterwarnings("always", message="other")
            warnings.warn("TypedStorage is deprecated", UserWarning, stacklevel=1)
            warnings.warn("other", UserWarning, stacklevel=1)
        assert [str(w.message) for w in seen] == ["other"]
        suppress_warnings(verbose=True)
        assert warnings.filters == before
    finally:
        warnings.filters[:] = before


# -- in-process shards ---------------------------------------------------------


@pytest.fixture(scope="module")
def predicted(tmp_path_factory):
    """One FASTQ, predicted by the port in one rank and in two shards, and by
    the JAX package in the same two shards (one engine), on the same float32
    weights."""
    tmp = tmp_path_factory.mktemp("shards")
    fq = _write_fastq(tmp / "mh.fq", np.random.default_rng(0), max_len=250)
    module, params, bb, hd = _narrow()
    port = _port_model(bb, hd, params).eval()
    kw = dict(max_length=256, tokens_per_batch=1 << 12, buckets=[256])
    PredictEngine(port, device="cpu", **kw).predict_file(fq, tmp / "single")
    for rank in range(2):
        PredictEngine(port, device="cpu", **kw).predict_file(fq, tmp / "multi", rank=rank, shard=(rank, 2))
    bundle = ModelBundle(module=module, params=params, name="narrow", config=module.backbone_config)
    jax_engine = JaxPredictEngine(bundle, **kw)
    for rank in range(2):
        jax_engine.predict_file(fq, tmp / "jax", rank=rank, shard=(rank, 2))
    return tmp, fq


def test_sharded_predict_chops_like_one_rank_and_jax(predicted):
    tmp, fq = predicted
    names = sorted(p.name for p in (tmp / "multi" / "0").iterdir())
    assert any(n.startswith("0_") for n in names) and any(n.startswith("1_") for n in names)
    assert names == sorted(p.name for p in (tmp / "jax" / "0").iterdir())
    single = run_chop([tmp / "single" / "0"], fq, ChopOptions(output_prefix=str(tmp / "single_out"), min_read_len=80))
    multi = run_chop([tmp / "multi" / "0"], fq, ChopOptions(output_prefix=str(tmp / "multi_out"), min_read_len=80))
    ref = jax_run_chop([tmp / "jax" / "0"], fq, JaxChopOptions(output_prefix=str(tmp / "jax_out"), min_read_len=80))
    assert multi.predicts_loaded == single.predicts_loaded == ref.predicts_loaded == 40
    assert multi.total_output_count == single.total_output_count == ref.total_output_count
    want = gzip.open(single.output_file, "rb").read()
    assert gzip.open(multi.output_file, "rb").read() == want
    assert gzip.open(ref.output_file, "rb").read() == want


def _shard_parallel(chop, load, shard_dir: Path, fq: Path, opts_cls, prefix: str):
    """Ranks 1 then 0 of the shard-parallel chop in one process (rank 0
    merges last); returns rank 0's stats and the barrier names."""
    calls: list[str] = []
    stats = None
    for rank in (1, 0):
        own = load(shard_dir, pattern=f"{rank}_*")
        assert own and all(int(rid.split("_")[1]) % 2 == rank for rid in own)
        st = chop(own, fq, opts_cls(output_prefix=prefix, min_read_len=80), rank=rank, nprocs=2, barrier=calls.append)
        assert (st is None) == (rank != 0)
        stats = st if rank == 0 else stats
    return stats, calls


def test_shard_parallel_chop_matches_jax_and_one_rank(predicted):
    tmp, fq = predicted
    shards = tmp / "multi" / "0"
    got, calls = _shard_parallel(multihost_stream_chop, load_predicts_from_batch_pts, shards, fq, ChopOptions,
                                 str(tmp / "mh_port"))  # fmt: skip
    want, _ = _shard_parallel(jax_multihost_stream_chop, jax_load_predicts, shards, fq, JaxChopOptions,
                              str(tmp / "mh_jax"))  # fmt: skip
    assert calls == ["deepchopper_chop_parts_done"] * 2
    assert Path(got.output_file).name.replace("mh_port", "mh_jax") == Path(want.output_file).name
    raw = Path(got.output_file).read_bytes()
    assert raw == Path(want.output_file).read_bytes()
    assert raw.endswith(BGZF_EOF) and raw.count(BGZF_EOF) == 1
    single = run_chop([tmp / "single" / "0"], fq, ChopOptions(output_prefix=str(tmp / "mh_single"), min_read_len=80))
    assert (got.predicts_loaded, got.total_fq_count, got.total_output_count) == (
        single.predicts_loaded, single.total_fq_count, single.total_output_count)  # fmt: skip
    assert _records(got.output_file) == _records(single.output_file)
    assert not list(tmp.glob(".dc_chop_part_*"))


def test_shard_parallel_chop_without_a_sidecar_raises_and_cleans_up(predicted, tmp_path):
    tmp, fq = predicted
    shards = tmp / "multi" / "0"
    opts = ChopOptions(output_prefix=str(tmp_path / "out"), min_read_len=80)
    multihost_stream_chop(load_predicts_from_batch_pts(shards, pattern="1_*"), fq, opts, rank=1, nprocs=2)
    (tmp_path / ".dc_chop_part_1.json").unlink()
    with pytest.raises(FileNotFoundError, match="rank 1"):
        multihost_stream_chop(load_predicts_from_batch_pts(shards, pattern="0_*"), fq, opts, rank=0, nprocs=2)
    assert not list(tmp_path.glob(".dc_chop_part_*")) and not list(tmp_path.glob(".deepchopper_temp_*"))
    assert not list(tmp_path.glob("*.chop.fq.gz"))


# -- train through the CLI, two ranks it spawns ------------------------------------


def _train_overrides(fq: Path, out: Path, *extra: str) -> list[str]:
    # The tiny config computes in bfloat16: two ranks' summed gradients differ
    # from one device's by bf16 rounding, and any Adam step moves the two runs
    # apart (measured: 1e-4 relative by the second step, at lr 2e-4 and 1e-5
    # alike). At lr 0 both runs keep the seed's weights, so every loss and
    # metric must agree; the gradients are held in float32 below.
    return [f"data.train_data_path={fq}", "data.max_length=256", "data.tokens_per_batch=4096",
            "data.shuffle_buffer=16", "model.name=hyenadna-tiny-1k-seqlen", "optimizer.lr=0", "seed=0",
            "trainer.max_epochs=1", "trainer.loggers=csv,jsonl,tensorboard", f"output_dir={out}", *extra]  # fmt: skip


@pytest.fixture(scope="module")
def cli_train(tmp_path_factory):
    """`train trainer.n_devices=2 --device cpu` through the CLI, and the same
    run on one rank in this process."""
    tmp = tmp_path_factory.mktemp("train")
    fq = synth_labelled_fastq(tmp / "train.fq", np.full(40, 180), seed=0)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepchopper_tpu_torch", "train", *_train_overrides(fq, tmp / "two"),
         "trainer.n_devices=2", "--device", "cpu"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )  # fmt: skip
    try:
        one = train(load_config(None, [*_train_overrides(fq, tmp / "one"), "device=cpu"]))
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    return tmp, fq, stdout, one


def test_train_on_two_ranks_writes_once_from_rank_zero(cli_train):
    tmp, _fq, stdout, _one = cli_train
    assert stdout.count("train done: {") == 1
    out = tmp / "two" / "train"
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == sorted(
        p.name for p in (tmp / "one" / "train" / "checkpoints").iterdir())  # fmt: skip
    assert len(list((out / "tb").iterdir())) == 1  # one event file: one writer
    assert [json.loads(line)["epoch"] for line in (out / "metrics.jsonl").read_text().splitlines()] == [0]
    assert len((out / "metrics.csv").read_text().splitlines()) == 2
    assert {p.name for p in out.iterdir()} >= {"config.yaml", "result.json", "test_metrics.json"}


def test_train_on_two_ranks_has_the_one_rank_metrics(cli_train):
    tmp, _fq, stdout, one = cli_train
    rows = {who: [json.loads(line) for line in (tmp / who / "train" / "metrics.jsonl").read_text().splitlines()]
            for who in ("one", "two")}  # fmt: skip
    for a, b in zip(rows["two"], rows["one"], strict=True):
        for key in ("val/f1", "val/precision", "val/recall", "train/f1", "lr"):
            assert a[key] == b[key], key
        assert abs(a["val/loss"] - b["val/loss"]) <= 1e-6 * abs(b["val/loss"])
        assert abs(a["train/loss"] - b["train/loss"]) <= 1e-5 * abs(b["train/loss"])
    test = {who: json.loads((tmp / who / "train" / "test_metrics.json").read_text()) for who in ("one", "two")}
    for key in ("test/f1", "test/precision", "test/recall", "test/acc"):
        assert test["two"][key] == test["one"][key] == one[key], key
    assert abs(test["two"]["test/loss"] - test["one"]["test/loss"]) <= 1e-6 * abs(test["one"]["test/loss"])
    assert f"'best_val_f1': {one['best_val_f1']!r}" in stdout


# -- two real processes ---------------------------------------------------------

RANK_SCRIPT = textwrap.dedent(
    """
    import json, os, pickle, sys
    from pathlib import Path

    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli, parallel
    from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
    from deepchopper_tpu_torch.train.config import load_config
    from deepchopper_tpu_torch.train.loop import Trainer, data_parallel, rank_block
    from deepchopper_tpu_torch.train.loss import loss_counts
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    work, torchrun_port = Path(sys.argv[1]), sys.argv[2]
    LR, LAM, CLIP = (float(x) for x in sys.argv[3:6])
    rank = int(os.environ["DC_PROCESS_ID"])
    torch.set_num_threads(2)
    out = {}

    def plumbing(tag):
        total = parallel.all_reduce_sum(torch.tensor([float(rank + 1)]))
        parallel.barrier(tag)
        out[tag] = [*parallel.process_shard_info(), float(total)]

    assert parallel.initialize_distributed(device="cpu")
    plumbing("dc")
    parallel.shutdown()
    for name in ("DC_COORDINATOR", "DC_NUM_PROCESSES", "DC_PROCESS_ID"):
        del os.environ[name]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=torchrun_port, RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_RANK=str(rank))
    assert parallel.initialize_distributed(device="cpu")
    plumbing("torchrun")

    os.chdir(work / "fused")
    out["predict_rc"] = cli.main(["predict", str(work / "reads.fq"), "--fused-chop", "--device", "cpu",
                                  "--random-init", "--model", "hyenadna-tiny-1k-seqlen", "--max-length", "512",
                                  "-o", str(work / "fused_shards")])

    with open(work / "model.pkl", "rb") as fh:
        bb, hd, state = pickle.load(fh)
    data = np.load(work / "batch.npz")
    fills = {"input_ids": 4, "input_quals": 0.0, "labels": -100}
    block = {k: torch.from_numpy(rank_block(data[k], fill, rank, 2)) for k, fill in fills.items()}
    counts = loss_counts(data["labels"])
    out["valid"] = int((block["labels"] != -100).sum())
    for name, clip, summed in (("ddp", None, True), ("clip", CLIP, True), ("control", None, False)):
        model = HyenaTokenClassifier(bb, hd)
        model.load_state_dict(state)
        model.train()
        if summed:
            step_model = data_parallel(model, torch.device("cpu"))
        else:  # DDP's default: each rank's own mean, gradients averaged
            step_model = torch.nn.parallel.DistributedDataParallel(model)
        aux = train_step(step_model, make_optimizer(model.parameters(), LR), block, LAM, clip,
                         counts if summed else None)
        loss = aux["loss"] if summed else parallel.all_reduce_sum(aux["loss"].clone()) / 2
        arrays = {"loss": loss.numpy(), "stats": aux["stats"].numpy()}
        for key, p in model.named_parameters():
            arrays["grad/" + key] = p.grad.numpy()
            arrays["param/" + key] = p.detach().numpy()
        np.savez(work / f"{name}_{rank}.npz", **arrays)

    trainer = Trainer(load_config(None, json.loads((work / "resume.json").read_text())))
    trainer.fit()
    out["resume"] = {"epochs": [row["epoch"] for row in trainer.history], "step": trainer.global_step,
                     "rows": trainer.history}
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    parallel.shutdown()
    """
)


def _global_batch(seed: int = 5):
    """Two rows of 256: row 0 (rank 0) valid throughout, row 1 (rank 1) for
    its first 64 positions: 256 and 64 valid labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 11, (2, 256))
    quals = rng.integers(5, 40, (2, 256)).astype(np.float32)
    labels = (rng.random((2, 256)) < 0.3).astype(np.int64)
    ids[1, 64:], quals[1, 64:], labels[1, 64:] = 4, 0.0, -100
    quals /= np.sqrt((quals * quals).sum(-1, keepdims=True))
    return {"input_ids": ids, "input_quals": quals, "labels": labels}




FAILING_RANKS = textwrap.dedent(
    """
    def fail_on_rank_one():
        import torch.distributed as dist

        if dist.get_rank() == 1:
            raise RuntimeError("rank 1 fails")
        dist.barrier()  # rank 0 waits for a rank that died

    if __name__ == "__main__":
        from deepchopper_tpu_torch.parallel import launch

        launch(fail_on_rank_one, 2, "cpu")
    """
)


@pytest.fixture(scope="module")
def ranks(cli_train, tmp_path_factory):
    """Launch `RANK_SCRIPT` on two gloo ranks (from `DC_*` variables) and,
    to share their wait, `FAILING_RANKS`, and take JAX's steps meanwhile;
    returns the work directory, each rank's report, JAX's steps and the
    failed launch's (exit code, stderr)."""
    train_dir, fq_train, _stdout, _one = cli_train
    work = tmp_path_factory.mktemp("ranks")
    (work / "fused").mkdir()
    _write_fastq(work / "reads.fq", np.random.default_rng(7), n=24)
    _module, params, bb, hd = _narrow()
    with open(work / "model.pkl", "wb") as fh:
        pickle.dump((bb, hd, _port_model(bb, hd, params).state_dict()), fh)
    np.savez(work / "batch.npz", **_global_batch())
    resume = _train_overrides(fq_train, work / "resume", f"ckpt_path={train_dir / 'two/train/checkpoints/last.ckpt'}",
                              "trainer.max_epochs=2", "trainer.n_devices=2", "device=cpu", "test=false")  # fmt: skip
    (work / "resume.json").write_text(json.dumps(resume))
    env = {**os.environ, "PYTHONPATH": str(REPO), "DC_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "DC_NUM_PROCESSES": "2"}  # fmt: skip
    args = [sys.executable, "-c", RANK_SCRIPT, str(work), str(_free_port()), str(LR), str(LAM), str(CLIP)]
    procs = [subprocess.Popen(args, env={**env, "DC_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]  # fmt: skip
    (work / "failing_ranks.py").write_text(FAILING_RANKS)
    failing = subprocess.Popen([sys.executable, str(work / "failing_ranks.py")], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env={**os.environ, "PYTHONPATH": str(REPO)})  # fmt: skip
    try:
        reference = _jax_steps()
        outs = [p.communicate(timeout=TIMEOUT) for p in (*procs, failing)]
    finally:
        for p in (*procs, failing):
            p.kill()
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    reports = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    return work, reports, reference, (failing.returncode, outs[2][1])


def test_ranks_join_from_dc_and_torchrun_variables(ranks):
    _work, reports, _jax, _failing = ranks
    for rank, rep in enumerate(reports):
        assert rep["dc"] == rep["torchrun"] == [rank, 2, 3.0]


def test_fused_predict_on_two_ranks_has_the_one_rank_records(ranks, tmp_path):
    work, reports, _jax, _failing = ranks
    assert [rep["predict_rc"] for rep in reports] == [0, 0]
    merged = list((work / "fused").glob("*.chop.fq.gz"))
    assert len(merged) == 1
    assert {p.name.split("_")[0] for p in (work / "fused_shards" / "0").iterdir()} == {"0", "1"}
    assert not list(work.glob(".dc_chop_part_*"))
    with contextlib.chdir(tmp_path):
        rc = cli.main(["predict", str(work / "reads.fq"), "--fused-chop", "--device", "cpu", "--random-init",
                       "--model", "hyenadna-tiny-1k-seqlen", "--max-length", "512"])  # fmt: skip
    one = list(tmp_path.glob("*.chop.fq.gz"))
    assert rc == 0 and len(one) == 1
    assert merged[0].name == one[0].name
    assert _records(merged[0]) == _records(one[0])


def _leaves(npz, kind: str) -> dict[str, np.ndarray]:
    return {k.split("/", 1)[1]: npz[k] for k in npz.files if k.startswith(kind + "/")}


def _jax_steps():
    """JAX's single-device step on the whole global batch, with Adam alone
    and with the clip before it: {name: (loss, gradients Adam saw, parameters
    after the update)}, as state_dicts."""
    module, params, _bb, _hd = _narrow()
    b = {k: jnp.asarray(v) for k, v in _global_batch().items()}

    def loss_fn(p):
        logits = module.apply({"params": p}, b["input_ids"], b["input_quals"])
        return jax_loss.continuous_interval_loss(logits, b["labels"], LAM)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert float(optax.global_norm(grads)) > CLIP  # the clip acts
    clipped, _ = optax.clip_by_global_norm(CLIP).update(grads, None)
    adam = optax.adam(LR)
    out = {}
    for name, g in (("ddp", grads), ("clip", clipped)):
        updates, _ = adam.update(g, adam.init(params), params)
        out[name] = (float(loss), _state_dict(g), _state_dict(optax.apply_updates(params, updates)))
    return out


def _state_dict(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in bridge.flax_to_state_dict(jax.tree.map(np.asarray, tree)).items()}


# Adam's first update is lr g / (|g| + 1e-8), whose slope lr 1e-8 / (|g| + 1e-8)^2
# turns a gradient's rounding into up to 2 lr where |g| is near 1e-8 (measured
# against JAX: 0.07% of the narrow model's entries move by more than 1e-6, each
# with |g| < 1e-7) and still into ~1e-4 of a leaf's max at |g| = 1e-6. The
# parameters are held where both gradients exceed ADAM_STEEP (slope <= 0.1 lr);
# the gradients are held everywhere.
ADAM_STEEP = 1e-5


def _step_errors(got, want) -> tuple[float, float, float]:
    """(loss error relative to want's, worst gradient leaf's error over its
    max|g|, worst parameter leaf's error over its max|p| outside Adam's steep
    region) of a step's npz against (loss, gradients, parameters)."""
    loss, grads, params = want
    got_grads, got_params = _leaves(got, "grad"), _leaves(got, "param")
    grad_err = max(float(np.abs(got_grads[k] - g).max() / max(float(np.abs(g).max()), 1e-30)) for k, g in grads.items())
    param_err = 0.0
    for k, p in params.items():
        held = (np.abs(grads[k]) > ADAM_STEEP) & (np.abs(got_grads[k]) > ADAM_STEEP)
        if held.any():
            param_err = max(param_err, float(np.abs(got_params[k] - p)[held].max() / np.abs(p).max()))
    return abs(float(got["loss"]) - loss) / abs(loss), grad_err, param_err


def test_ddp_train_step_matches_jax_single_device(ranks):
    work, reports, jax_steps, _failing = ranks
    assert [rep["valid"] for rep in reports] == [256, 64]
    got = [np.load(work / f"ddp_{r}.npz") for r in range(2)]
    for key in got[0].files:  # both replicas hold the same state
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    errs = _step_errors(got[0], jax_steps["ddp"])
    assert errs[0] <= 1e-5 and errs[1] <= 1e-4 and errs[2] <= 1e-4, errs


def test_ddp_train_step_with_clip_matches_optax_chain(ranks):
    work, _reports, jax_steps, _failing = ranks
    errs = _step_errors(np.load(work / "clip_0.npz"), jax_steps["clip"])
    assert errs[0] <= 1e-5 and errs[1] <= 1e-4 and errs[2] <= 1e-4, errs


def test_ddp_default_average_fails_the_jax_comparison(ranks):
    work, _reports, jax_steps, _failing = ranks
    loss_err, grad_err, _param_err = _step_errors(np.load(work / "control_0.npz"), jax_steps["ddp"])
    assert loss_err > 1e-5 and grad_err > 1e-4, (loss_err, grad_err)


def test_ddp_train_step_matches_the_one_rank_step(ranks):
    work, _reports, _jax, _failing = ranks
    _module, params, bb, hd = _narrow()
    port = _port_model(bb, hd, params)
    batch = {k: torch.from_numpy(v) for k, v in _global_batch().items()}
    aux = train_step(port, make_optimizer(port.parameters(), LR), batch, LAM)
    got = np.load(work / "ddp_0.npz")
    np.testing.assert_array_equal(got["stats"], aux["stats"].numpy())
    named = dict(port.named_parameters())
    want = (float(aux["loss"]), {k: p.grad.numpy() for k, p in named.items()},
            {k: p.detach().numpy() for k, p in named.items()})  # fmt: skip
    errs = _step_errors(got, want)
    # Two ranks' partial gradients summed round differently from one sum: the
    # filter's sin frequencies, whose sums over positions cancel, differ by
    # 1.4e-6 of their max; the loss and the parameters by < 4e-7.
    assert errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2] <= 1e-6, errs


def test_trainer_resumes_on_both_ranks(ranks):
    _work, reports, _jax, _failing = ranks
    resumed = [rep["resume"] for rep in reports]
    assert resumed[0]["epochs"] == resumed[1]["epochs"] == [1]
    assert resumed[0]["step"] == resumed[1]["step"] > 0
    assert resumed[0]["rows"][0]["val/loss"] == resumed[1]["rows"][0]["val/loss"]


def test_a_failed_rank_ends_the_launch_nonzero(ranks):
    returncode, stderr = ranks[3]
    # Whichever rank's failure the launcher sees first is raised: rank 1's
    # error, or rank 0's barrier losing its peer.
    assert returncode != 0
    assert "ProcessRaisedException" in stderr or "ProcessExitedException" in stderr
