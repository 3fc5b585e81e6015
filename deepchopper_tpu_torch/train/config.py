"""Dataclass config tree for train/eval runs.

Port of `deepchopper_tpu/train/config.py`: the same fields and defaults,
YAML files and `key.subkey=value` overrides, plus `device` (the run's device:
"cuda" unless asked for "cpu"). YAML is read and written without PyYAML, for
the form every config of the repository takes, a block mapping of mappings
and scalars: `read_yaml` resolves scalars as `yaml.safe_load` does and
refuses any other form; `save_config` writes the run's config.yaml with a
small emitter, which `yaml.safe_load` reads back.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class DataConfig:
    """Reference: configs/data/fq.yaml + deepchopper/data/fq_datamodule.py:22-118."""

    train_data_path: str | None = None
    val_data_path: str | None = None
    test_data_path: str | None = None
    predict_data_path: str | None = None
    # Single-dataset ratio split when only train_data_path is given
    # (reference: deepchopper/data/hg_data.py:7-39 — 80/10/10).
    split_train: float = 0.8
    split_val: float = 0.1
    max_length: int = 32768
    tokens_per_batch: int = 1 << 17
    max_batch: int = 512
    shuffle_buffer: int = 4096
    seed: int = 0


@dataclasses.dataclass
class OptimizerConfig:
    """Reference: configs/model/hyena.yaml optimizer+scheduler blocks."""

    lr: float = 2e-4
    weight_decay: float = 0.0
    # ReduceLROnPlateau equivalents (mode=min on val/loss).
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    min_lr: float = 0.0


@dataclasses.dataclass
class ModelConfig:
    name: str = "hyenadna-small-32k-seqlen"
    lambda_penalty: float = 0.0
    checkpoint: str | None = None  # native checkpoint to initialize from
    torch_checkpoint: str | None = None  # reference torch ckpt to convert
    # Head hyperparameters the reference's sweeper tunes
    # (configs/hparams_search/hyena_optuna.yaml:50-52); None = registry default.
    lin1_size: int | None = None
    use_identity_layer_for_qual: bool | None = None


@dataclasses.dataclass
class CallbacksConfig:
    """Reference: configs/callbacks/default.yaml."""

    monitor: str = "val/f1"
    monitor_mode: str = "max"
    save_last: bool = True
    early_stop_patience: int = 40
    min_delta: float = 0.0


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 10
    limit_train_batches: int | None = None
    limit_val_batches: int | None = None
    log_every_n_steps: int = 50
    # Ranks, one a card. The CLI's train/eval start that many, None = every
    # visible card (1 on the CPU); a Trainer runs on its process group's.
    n_devices: int | None = None
    deterministic: bool = True
    gradient_clip: float | None = None
    # Debug shortcuts (reference: configs/debug/fdr.yaml, overfit.yaml):
    # fast_dev_run = 1 train/val batch, 1 epoch, no checkpoints;
    # overfit_batches = train AND validate on the same N cached batches.
    fast_dev_run: bool = False
    overfit_batches: int | None = None
    # Comma-separated logger backends: csv, tensorboard
    # (reference: configs/logger/*.yaml).
    loggers: str = "csv,tensorboard"


@dataclasses.dataclass
class TrainConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    callbacks: CallbacksConfig = dataclasses.field(default_factory=CallbacksConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    task_name: str = "train"
    output_dir: str = "outputs"
    seed: int | None = None
    train: bool = True
    test: bool = True
    ckpt_path: str | None = None  # resume checkpoint (reference: configs/train.yaml:45)
    device: str = "cuda"  # "cuda" or "cpu"; without CUDA, "cuda" raises DeviceUnavailable


# ---------------------------------------------------------------------------
# YAML round-trip + dotted overrides
# ---------------------------------------------------------------------------


def _to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    return cfg


def _from_dict(cls: type, data: dict) -> Any:
    inst = cls()
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        cur = getattr(inst, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            setattr(inst, f.name, _from_dict(type(cur), v))
        else:
            setattr(inst, f.name, v)
    return inst


def _yaml_scalar(v: Any) -> str:
    """One scalar of the config tree as YAML that `yaml.safe_load` reads back
    to the same value and type."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        mant, _, exp = text.partition("e")
        if "." not in mant:  # YAML 1.1 floats need a dot: 1e-08 -> 1.0e-08
            mant += ".0"
        return mant + ("e" + exp if exp else "")
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"config value {v!r} is not a YAML scalar")


def _yaml_lines(node: dict, indent: int) -> list[str]:
    lines = []
    for key, val in node.items():
        if isinstance(val, dict):
            lines.append(f"{'  ' * indent}{key}:")
            lines += _yaml_lines(val, indent + 1)
        else:
            lines.append(f"{'  ' * indent}{key}: {_yaml_scalar(val)}")
    return lines


def save_config(cfg: TrainConfig, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(_yaml_lines(_to_dict(cfg), 0)) + "\n")


# YAML 1.1 scalars as PyYAML's safe loader resolves them.
_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_INT_BASE = re.compile(r"[-+]?0(?:b[0-1_]+|x[0-9a-fA-F_]+|[0-7_]+)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")


def _plain_scalar(text: str) -> Any:
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _INT_BASE.fullmatch(text):
        sign, digits = (-1, text[1:]) if text[0] == "-" else (1, text.lstrip("+"))
        digits = digits.replace("_", "")
        base = {"b": 2, "x": 16}.get(digits[1:2], 8)
        return sign * int(digits[2:] if base != 8 else digits, base)
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF.fullmatch(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.fullmatch(text):
        return float("nan")
    if text[0] in "[{&*!|>%@`-?" or ": " in text:
        raise ValueError(f"unsupported YAML scalar {text!r}")
    return text


def _split_value(text: str, where: str) -> Any:
    """A value after `key:`, comment stripped: a quoted string or a plain
    scalar."""
    if text[:1] in ("'", '"'):
        q = text[0]
        i, out = 1, []
        while i < len(text):
            c = text[i]
            if c == q and q == "'" and text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            if c == "\\" and q == '"':
                esc = text[i + 1 : i + 2]
                if esc not in ('"', "\\"):
                    raise ValueError(f"{where}: unsupported escape \\{esc}")
                out.append(esc)
                i += 2
                continue
            if c == q:
                rest = text[i + 1 :].strip()
                if rest and not rest.startswith("#"):
                    raise ValueError(f"{where}: text after a quoted scalar")
                return "".join(out)
            out.append(c)
            i += 1
        raise ValueError(f"{where}: unterminated quoted scalar")
    m = re.search(r"\s#", text)
    return _plain_scalar((text[: m.start()] if m else text).strip())


def read_yaml(text: str) -> dict:
    """Parse a block mapping of mappings and scalars (the form of every
    config of the repository) to the dict `yaml.safe_load` returns; any
    other YAML (lists, flow collections, anchors, multi-line scalars)
    raises ValueError."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        stripped = raw.strip()
        if not stripped or stripped.startswith("#") or stripped == "---":
            continue
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab indentation")
        lines.append((n, len(raw) - len(raw.lstrip(" ")), stripped))

    def block(i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(lines):
            n, ind, body = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"line {n}: unexpected indentation")
            m = re.match(r"""('(?:[^']|'')*'|"[^"]*"|[^'"#][^#]*?):(?:\s+(.*))?$""", body)
            if m is None or body.startswith("- "):
                raise ValueError(f"line {n}: not a `key: value` line: {body!r}")
            key = _split_value(m.group(1), f"line {n}")
            value = m.group(2)
            i += 1
            if value is None or value.startswith("#"):
                if i < len(lines) and lines[i][1] > indent:
                    out[key], i = block(i, lines[i][1])
                else:
                    out[key] = None
            else:
                out[key] = _split_value(value, f"line {n}")
        return out, i

    data, _ = block(0, lines[0][1]) if lines else ({}, 0)
    return data


def apply_override(cfg: Any, key: str, value: str) -> None:
    """Apply one `a.b.c=value` override with type coercion from the field type."""
    parts = key.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key {key!r}")
    cur = getattr(obj, leaf)
    new: Any = value
    if isinstance(value, str):
        low = value.lower()
        if low in ("null", "none"):
            new = None
        elif isinstance(cur, bool) or low in ("true", "false"):
            new = low == "true"
        elif isinstance(cur, int) and not isinstance(cur, bool):
            new = int(value)
        elif isinstance(cur, float):
            new = float(value)
        elif cur is None:
            # Try numeric, else keep string.
            for cast in (int, float):
                try:
                    new = cast(value)
                    break
                except ValueError:
                    continue
    setattr(obj, leaf, new)


def load_config(
    path: str | Path | None = None, overrides: list[str] | None = None
) -> TrainConfig:
    """Build a TrainConfig from an optional YAML file + dotted overrides."""
    cfg = TrainConfig()
    if path is not None:
        cfg = _from_dict(TrainConfig, read_yaml(Path(path).read_text()))
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must look like key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        apply_override(cfg, k, v)
    return cfg


def format_config_tree(cfg: TrainConfig) -> str:
    """Indented config tree for run-start logging
    (reference capability: deepchopper/utils/rich_utils.py print_config_tree)."""
    lines: list[str] = []

    def walk(node: Any, indent: int, name: str) -> None:
        pad = "  " * indent
        if dataclasses.is_dataclass(node):
            lines.append(f"{pad}{name}:")
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), indent + 1, f.name)
        else:
            lines.append(f"{pad}{name}: {node}")

    walk(cfg, 0, "config")
    return "\n".join(lines)
