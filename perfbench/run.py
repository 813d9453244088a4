#!/usr/bin/env python3
"""The benchmark of `fpmatch_tpu_torch` (the PyTorch and CUDA matcher) on
one NVIDIA H100.

Run one cell from the root of a checkout:

    python3 perfbench/run.py --workload resnet18.eval-n64 --seed 7 \\
        --seconds 10 --trace 0

It makes the cell's weights and inputs from `--seed`, warms up every shape
the cell uses (that is `setup_s`), drives the program for `--seconds`,
judges what the window produced against the plain reference
(`perfbench/reference/`), and prints one JSON line as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with `--trace
1`), `device`, with `--trace 1` `breakdown`, and last `checks`, each
compared number beside its limit (also the last lines of standard error).
Without a CUDA card, or with a module of JAX or of the JAX package loaded,
it exits non-zero and prints no result. `--control bf16` runs the
program's own bfloat16 path (`--bf16` of its CLIs) in place of the
configuration's precision, `--control tf32` its float32 matmuls in TF32:
the comparison's controls, which must come out not correct (TF32 matmuls
in the eval cells).

Everything is found by name, so a later change adds files and edits none:

  * a configuration: `perfbench/configs/<name>.json` (the program's
    `Config` fields, its source, `reduced`, `assumed`), listed under
    `configs` in `BENCHMARK.json`;
  * a traffic mix: `perfbench/traffic/<name>.json`, parameters read by the
    one generator `perfbench/traffic/generator.py`; its `task` picks the
    driver `perfbench/tasks/<task>.py` (`evaluate`, `train`);
  * a cell: an entry under `workloads` in `BENCHMARK.json` and
    `perfbench/workloads/<cell>.json` (its batch, the reference's block,
    the limits of its comparison);
  * a per-layer metric: an entry under `per_layer` and a reader
    `perfbench/metrics/<metric>.py` (`LAYER`, `MOVES`, `UNIT`, `read(ctx)`
    returning a number or None).

`run_seconds` and every end-to-end metric's `bound` live in
`BENCHMARK.json`; the comparison's limits in each cell's file. The CPU
tests of the harness: `python -m pytest perfbench/tests -q` (those marked
`gpu` run on a card only).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_overrides(kind):
    """The program's configuration with its own lower-precision path on
    (`bf16`); None for the configuration as it stands (no control, or
    `tf32`, which `run_once` sets around the run)."""
    if kind in (None, "tf32"):
        return None
    if kind != "bf16":
        raise ValueError(f"unknown control {kind!r}")

    def bf16(cfg):
        import dataclasses

        return dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone,
                                              dtype="bfloat16"),
            ngm=dataclasses.replace(cfg.ngm, compute_dtype="bfloat16"))
    return bf16


def run_once(workload: str, seed: int, seconds: float, trace: bool,
             control=None, device="cuda", t0=None, cell=None) -> dict:
    """One run of a cell: the result line as a dict (without printing)."""
    from perfbench import compare, harness

    seed %= 2 ** 63        # numpy's seed sequences take no negative seed

    man = harness.manifest()
    cell = cell or harness.load_cell(workload, man)
    if device == "cuda":
        harness.check_device(cell.entry["chips"])
    harness.check_program()
    task = importlib.import_module(f"perfbench.tasks.{cell.traffic['task']}")
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    # the `tf32` control: the program's float32 matmuls in TF32
    torch.backends.cuda.matmul.allow_tf32 = tf32 or control == "tf32"
    try:
        out = task.run(cell, seed, seconds, trace, device=device,
                       t0=T0 if t0 is None else t0,
                       port_overrides=control_overrides(control))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    checks = compare.judge(out["numbers"], cell.spec["limits"])
    units = {m["name"]: m["unit"] for m in man["end_to_end"]}
    if trace:
        ctx = {"trace": out["trace"], "work": out["work"],
               "peaks": json.loads((ROOT / "perfbench" / "peaks.json")
                                   .read_text())}
        metrics = {}
        for name in cell.per_layer:
            reader = harness.metric_reader(name)
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
    else:
        metrics = {name: {"value": out["e2e"][name], "unit": units[name]}
                   for name in cell.end_to_end}
    line = {"correct": all(ok for *_, ok in checks) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics}
    if device == "cuda":
        line["device"] = harness.device_record(out["trace"])
        line["device"]["memory_peak_bytes"] = out["memory_peak"]
    if trace:
        from perfbench import trace as tr

        line["breakdown"] = tr.breakdown(out["trace"])
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in checks}
    line["_numbers"] = out["numbers"]
    if trace:
        t = out["trace"]
        line["_trace"] = {k: t[k] for k in (
            "window_s", "busy_s", "launches", "pairs", "windows",
            "wrapper_launches", "by_range", "host_ranges", "device_spans",
            "runtime_events")}
    line["_setup_s"] = out["setup_s"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16", "tf32"), default=None)
    args = ap.parse_args(argv)

    from perfbench import harness

    try:
        line = run_once(args.workload, args.seed, args.seconds,
                        bool(args.trace), args.control)
    except harness.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    numbers = line.pop("_numbers")
    print("numbers " + json.dumps(numbers), file=sys.stderr)
    print(f"setup_s {line.pop('_setup_s')!r}", file=sys.stderr)
    if "_trace" in line:
        print("trace " + json.dumps(line.pop("_trace")), file=sys.stderr)
    print(f"card {harness.power_limit()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
