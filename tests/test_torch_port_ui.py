"""Port web core (ui/main.py, utils/vis.py) and the `web` command vs the JAX
package, on the CPU.

`predict_record` runs one pasted record at its own width. Both packages get
the same float32 weights (JAX `init_params` through `models/bridge.py`): the
labels, the smoothed intervals, the highlighted text and the kept segments
must be equal. Records are made by numpy from a seed, at a width outside the
kernels' rule (301 tokens: the plain route in both) and at one inside it
(512 tokens: the fused route's plain version here).
"""

from __future__ import annotations

import dataclasses
import importlib.util

import jax
import numpy as np
import pytest
import torch

from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.classifier import HyenaTokenClassifier as JaxClassifier
from deepchopper_tpu.models.registry import ModelBundle
from deepchopper_tpu.ui import main as jax_ui
from deepchopper_tpu.utils import vis as jax_vis
from deepchopper_tpu_torch import cli
from deepchopper_tpu_torch.device import DeviceUnavailable
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
from deepchopper_tpu_torch.models.config import HeadConfig, HyenaConfig
from deepchopper_tpu_torch.ui import main as port_ui
from deepchopper_tpu_torch.utils import vis as port_vis


def _record(n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGTacgtN"), n))
    qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 40, n))
    return f"@read_{seed} extra\n{seq}\n+\n{qual}\n"


@pytest.mark.parametrize(
    "text",
    [_record(40, 1), "  \n" + _record(12, 2) + "\n\n", "read\nACGT\n+\nIIII\n", "@r\nACGT\n+\nIII\n", "@r\nACGT\n"],
)
def test_parse_fq_record_equals_jax(text):
    try:
        want = jax_ui.parse_fq_record(text)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            port_ui.parse_fq_record(text)
        return
    assert port_ui.parse_fq_record(text) == want


@pytest.mark.parametrize("color", [True, False])
@pytest.mark.parametrize("width", [None, 7])
def test_highlight_targets_equals_jax(color, width):
    seq = "ACGTACGTACGTACGTACGTACGTAC"
    targets = [(10, 14), (1, 3), (20, 26)]
    want = jax_vis.highlight_targets(seq, targets, width, color)
    assert port_vis.highlight_targets(seq, targets, width, color) == want


@pytest.fixture(scope="module")
def models():
    """(JAX bundle, port model): a narrow Hyena at float32, the same weights
    (JAX's `init_params`, jitted)."""
    backbone = jax_config.HyenaConfig(d_model=64, n_layer=2, d_inner=128, max_seq_len=1026, compute_dtype="float32")
    head = jax_config.HeadConfig(input_size=64, lin1_size=128, lin2_size=128, compute_dtype="float32")
    module = JaxClassifier(backbone_config=backbone, head_config=head)
    zeros = jax.numpy.zeros((1, 1024), jax.numpy.int32)
    params = jax.jit(module.init)(jax.random.PRNGKey(4), zeros, zeros.astype(jax.numpy.float32))["params"]
    port = HyenaTokenClassifier(
        HyenaConfig(**{f.name: getattr(backbone, f.name) for f in dataclasses.fields(HyenaConfig)}),
        HeadConfig(**dataclasses.asdict(head)),
    )
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    return ModelBundle(module, params, "narrow", backbone), port.eval()


@pytest.mark.parametrize("n_bases", [300, 511])
def test_predict_record_equals_jax(models, n_bases):
    bundle, port = models
    text = _record(n_bases, seed=n_bases)
    want = jax_ui.predict_record(text, bundle, smooth_window_size=5, min_interval_size=3)
    got = port_ui.predict_record(text, port, smooth_window_size=5, min_interval_size=3)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert 0 < int(got["labels"].sum()) < n_bases  # both classes: the intervals are not trivial
    for key in ("id", "smooth_intervals", "highlighted", "kept_segments", "kept_intervals"):
        assert got[key] == want[key], key


def test_predict_record_loads_the_flagship_on_the_cpu_when_asked():
    out = port_ui.predict_record(_record(200, 5), random_init=True, device="cpu")
    assert out["labels"].shape == (200,) and out["id"] == "read_5 extra"


def test_predict_record_needs_weights_and_a_device():
    with pytest.raises(FileNotFoundError):
        port_ui.predict_record(_record(50, 6), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable):
            port_ui.predict_record(_record(50, 6), random_init=True)


def test_web_without_gradio_exits_one_and_without_cuda_two(capsys):
    if importlib.util.find_spec("gradio") is not None:
        pytest.skip("gradio is installed: launch would serve")
    with pytest.raises(ImportError, match="gradio"):
        port_ui.launch(random_init=True, device="cpu")
    assert cli.main(["web", "--random-init", "--device", "cpu"]) == 1
    assert "gradio" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert cli.main(["web", "--random-init"]) == 2
