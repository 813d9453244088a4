"""Train-step scaling through the training CLI: `python -m
fpmatch_tpu_torch.cli.train --n-devices N` on one generated dataset, each N
read from the trainer's own `pairs/s, ms/step` line.

    python -m fpmatch_tpu_torch.scripts.bench_cli_mesh_scaling
        [--device cuda]

The JAX script's dataset and flags: a synthetic split of 8 / 8 / 8 fingers,
40 pores, 320 x 280 images (seed 0); stage 1, one epoch of one pass over 64
pairs, batches of 8 (the global batch: N ranks take 8 / N each), n_max 64,
e_max 384, univ 64, test length 8, thread workers. N = 1, 2, 4 run where
that many cards are visible (one rank a card, NCCL); the N left out are
listed with the reason. On `--device cpu` only N = 1 runs (the scaling is
of cards). Ideal data-parallel throughput is N times one device's;
`efficiency` is the measured speedup over N. Exit 0 only if N = 1 ran.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import _measure

ROOT = Path(__file__).resolve().parents[2]
DEVICE_COUNTS = (1, 2, 4)
COMMON = ["--stages", "1", "--epochs", "1", "--passes", "1", "--length",
          "64", "--batch-size", "8", "--test-length", "8", "--n-max", "64",
          "--e-max", "384", "--univ", "64", "--thread-workers"]
THROUGHPUT = re.compile(r"([\d.]+) pairs/s, ([\d.]+) ms/step")


def trainer_command() -> List[str]:
    return [sys.executable, "-m", "fpmatch_tpu_torch.cli.train"]


def run(device: str = "cuda", command: Optional[List[str]] = None,
        timeout_s: float = 1800) -> Dict:
    """`command` (Python callers only) replaces the trainer's command
    line; the flags above are appended to it."""
    from ..data.generator import generate_synthetic_dataset

    command = command or trainer_command()
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cuda" and cards == 0:
        raise RuntimeError("--device cuda: no card is visible")
    out = {"device": device, "card": _measure.card(device),
           "cards_visible": cards, "runs": {}, "left_out": {}}
    with tempfile.TemporaryDirectory(prefix="mesh_scaling_") as tmp:
        root = os.path.join(tmp, "Synthetic")
        generate_synthetic_dataset(root, fingers_per_split=(8, 8, 8),
                                   n_pores=40, seed=0, size=(320, 280))
        for n in DEVICE_COUNTS:
            if n > 1 and n > cards:
                out["left_out"][str(n)] = (
                    f"{cards} card(s) visible on {device}; "
                    f"--n-devices {n} needs {n}")
                continue
            proc = subprocess.run(
                [*command, "--data-root", root, *COMMON, "--n-devices",
                 str(n), "--device", device, "--checkpoint-dir",
                 os.path.join(tmp, f"ckpt{n}")],
                capture_output=True, text=True, timeout=timeout_s,
                cwd=str(ROOT))
            found = THROUGHPUT.findall(proc.stdout)
            if proc.returncode != 0 or not found:
                raise RuntimeError(
                    f"--n-devices {n}: exit {proc.returncode}, no "
                    f"throughput line; output:\n{proc.stdout[-2000:]}"
                    f"{proc.stderr[-2000:]}")
            pps, ms = (float(v) for v in found[-1])
            out["runs"][str(n)] = {"pairs_per_s": pps, "ms_per_step": ms}
    base = out["runs"]["1"]["pairs_per_s"]
    for n, row in out["runs"].items():
        row["speedup"] = row["pairs_per_s"] / base
        row["efficiency"] = row["speedup"] / int(n)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None, command: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    out = run(args.device, command)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
