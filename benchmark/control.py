"""The control of each cell's comparison, and the faults it must catch,
read at the cell's own size (run on the card; the benchmark's runs do not
run it):

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--program]

It puts the reference in the program's place, computed in the precision
below the configuration's (float8 e4m3 for its bfloat16 products), and
prints, for every seed, the numbers the cell compares: for a predict cell
the widest gap of the labels the float8 forward puts first; for a train
cell the first steps' gaps of the float8 reference and of the half-batch
fault (the reference's step over the first half of each batch's rows:
`half_batch` in the whole step, `half_batch_loss` in the loss and its
gradient alone, the (tp, fp, fn, tn) still over every row), the limits'
upper readings. A state left unchanged reads 1 in `change_gap` and needs
no run. A predict cell's weights take the calibrated head bias of its runs
(`harness/calibrate.py`). With `--program`, a train cell's sound readings
instead: the program's own checked steps on each seed, in one process.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _weights(cfg: dict, seed: int, device):
    from deepchopper_tpu_torch.models.registry import build_model

    from benchmark.harness.weights import make_weights

    shapes = {k: tuple(v.shape) for k, v in build_model(cfg["registry_name"]).state_dict().items()}
    return make_weights(shapes, cfg["init"], seed, device)


def predict_readings(cell, seed: int, device) -> dict:
    from deepchopper_tpu_torch.data.bucketing import default_buckets

    from benchmark.harness.calibrate import set_adapter_bias
    from benchmark.harness.traffic import bucket_widths, make_reads
    from benchmark.paths.fused_predict import _sample
    from benchmark.reference import judge

    mix = cell.traffic
    buckets = default_buckets(mix["max_length"])
    weights = _weights(cell.config, seed, device)
    set_adapter_bias(weights, cell.config, mix, seed, buckets, device)
    reads = make_reads(mix, mix["reads_per_pass"], seed)
    sample = _sample(reads.lengths(), seed, mix["check_bases"])
    items = list(zip(sample, bucket_widths(reads.lengths()[sample], buckets, mix["max_length"])))
    ref = judge.read_logits(weights, cell.config, reads, items, mix["max_length"], device)
    low = judge.read_logits(weights, cell.config, reads, items, mix["max_length"], device, mode="fp8")
    widest, mean, flips = judge.label_gaps(ref, {i: lg.argmax(1) for i, lg in low.items()}, mix["tie_band"])
    return {"fp8": {"logit_gap": widest, "logit_gap_mean": mean, "flip_share": flips}}


def train_readings(cell, seed: int, device) -> dict:
    from deepchopper_tpu_torch.data.parquet_module import DataModule

    from benchmark.harness.traffic import make_reads
    from benchmark.paths.train_step import CHECKED_STEPS
    from benchmark.reference import judge

    import tempfile

    mix = cell.traffic
    weights = _weights(cell.config, seed, device)
    reads = make_reads(mix, mix["reads"], seed)
    with tempfile.TemporaryDirectory(prefix="dcbench-control-") as tmp:
        fq = reads.write_fastq(Path(tmp) / "train.fq")
        val = make_reads(mix, 8, seed, stream=1, prefix="val_read").write_fastq(Path(tmp) / "val.fq")
        dm = DataModule(train_data_path=str(fq), val_data_path=str(val), max_length=mix["max_length"],
                        tokens_per_batch=mix["tokens_per_batch"], max_batch=mix["max_batch"],
                        shuffle_buffer=mix["shuffle_buffer"], seed=seed)  # fmt: skip
        it = dm.train_batches(0)
        batches = [next(it) for _ in range(mix.get("checked_steps", CHECKED_STEPS))]
    ref_batches = [judge.reference_batch(reads, b.read_ids, b.input_ids.shape[1], mix["max_length"]) for b in batches]
    lr = mix["learning_rate"]
    ref = judge.train_reference(weights, cell.config, ref_batches, lr, device)
    out = {}
    faults = {"fp8": {"mode": "fp8"}, "half_batch": {"rows_kept": 0.5}, "half_batch_loss": {"loss_rows_kept": 0.5}}
    for name, kw in faults.items():
        got = judge.train_reference(weights, cell.config, ref_batches, lr, device, **kw)
        as_program = {"losses": got["losses"], "stats": got["stats"], "grad1_vec": got["grad1"],
                      "grad1": {k: float(g.norm()) for k, g in got["grad1"].items()},
                      "change": {k: float(c.norm()) for k, c in got["change"].items()}}  # fmt: skip
        notes: list[str] = []
        out[name] = {**judge.train_gaps(as_program, ref, log=notes.append), "notes": notes}
    return out


def program_readings(cell, seed: int, device) -> dict:
    """A train cell's sound readings: the program's checked steps, as a
    run's set-up drives them, against the reference, without the warm
    steps and the window."""
    import tempfile

    from benchmark.paths import train_step

    with tempfile.TemporaryDirectory(prefix="dcbench-control-") as tmp:
        state = train_step.first_steps(cell, seed, device, Path(tmp))
    train_step.release(state)
    return {"program": train_step.check(cell, state, {"losses": []}, device)}


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    from benchmark.harness.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true", help="a train cell's sound readings instead of the control's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control reads at the cell's size, on the card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    readings = predict_readings if cell.path == "fused_predict" else program_readings if args.program else train_readings
    for seed in args.seeds:
        t0 = time.monotonic()
        got = readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds": time.monotonic() - t0, **got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
