#!/usr/bin/env python3
"""Runs of one cell in one process, for the measurements that set the
cell's batch and limits: the batch sweep and the readings of the
comparison on many seeds, of the program and of its control.

    python3 perfbench/calibrate.py --workload resnet18.eval-n64 \\
        --batches 64,128,256 --seeds 11 --seconds 4 --trace 1
    python3 perfbench/calibrate.py --workload resnet18.eval-n64 \\
        --seeds 1,2,3 --control bf16 --out control.jsonl

Each run is `run.run_once` with the cell's batch replaced where
`--batches` is given; a run that does not fit on the card is recorded as
such and ends the sweep. Every run appends one JSON line to `--out` and
prints it. The benchmark's own runs never call this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def half_batch():
    """The training step's loss taken over the first half of each batch
    (the rest left out, the mean over the half)."""
    import torch

    from fpmatch_tpu_torch.train import step as step_mod

    real = step_mod.loss_and_metrics

    def half(model, batch, stage, **kw):
        h = batch.batch_size // 2
        return real(model, type(batch)(*(a[:h] if torch.is_tensor(a) else a
                                         for a in batch)), stage, **kw)
    step_mod.loss_and_metrics = half


def unchanged():
    """The training step leaves the parameters as they were."""
    import torch

    torch.optim.AdamW.step = lambda self, closure=None: None


def cudnn_fp32():
    """The program's convolutions in float32 (cuDNN's TF32 off): a probe of
    what TF32 rounding moves, not a fault."""
    import torch

    torch.backends.cudnn.allow_tf32 = False


FAULTS = {"half-batch": half_batch, "unchanged": unchanged}
PROBES = {"cudnn-fp32": cudnn_fp32}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", default=None)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16", "tf32"), default=None)
    ap.add_argument("--fault", choices=tuple(FAULTS), default=None,
                    help="plant a fault in the program's training step")
    ap.add_argument("--probe", choices=tuple(PROBES), default=None)
    ap.add_argument("--detail", action="store_true",
                    help="per-leaf readings of the training comparison")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    if args.probe:
        PROBES[args.probe]()

    import torch

    from perfbench import harness, run
    from perfbench.tasks import train

    train.DETAIL = args.detail
    seeds = [int(s) for s in args.seeds.split(",")]
    batches = ([int(b) for b in args.batches.split(",")] if args.batches
               else [None])
    for batch in batches:
        for seed in seeds:
            cell = harness.load_cell(args.workload)
            if batch is not None:
                cell.spec["batch"] = batch
            for trace in sorted({0, args.trace}):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                row = {"workload": args.workload, "batch": cell.spec["batch"],
                       "seed": seed, "control": args.control,
                       "fault": args.fault, "probe": args.probe,
                       "trace": trace}
                t = time.perf_counter()
                try:
                    line = run.run_once(args.workload, seed, args.seconds,
                                        bool(trace), args.control,
                                        t0=time.perf_counter(), cell=cell)
                except torch.cuda.OutOfMemoryError as e:
                    row["out_of_memory"] = str(e).splitlines()[0][:200]
                    line = None
                row["run_s"] = time.perf_counter() - t
                if line is not None:
                    row.update(correct=line["correct"],
                               attempted=line["attempted"],
                               failed=line["failed"], metrics=line["metrics"],
                               device=line.get("device"),
                               numbers=line["_numbers"],
                               setup_s=line["_setup_s"],
                               trace_summary=line.get("_trace"))
                text = json.dumps(row)
                print(text, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(text + "\n")
                if line is None:
                    return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
