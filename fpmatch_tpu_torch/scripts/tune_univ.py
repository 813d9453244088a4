"""Block-size sweep of the blocked UNIV-scale association kernel (K4).

    python -m fpmatch_tpu_torch.scripts.tune_univ                  # sweep
    python -m fpmatch_tpu_torch.scripts.tune_univ --one R1 R2 PREC # one row
    python -m fpmatch_tpu_torch.scripts.tune_univ --device cpu     # off the card

Counterpart of the JAX package's `scripts/tune_univ.py`: the same `CONFIGS`
and `PRECS`, the same inputs (seed 0, n = 600 uniform points in 400 x 300,
Delaunay graphs, C = 16, normal X / Kp / Ke made with numpy, the plan in the
model's K^T orientation) and the same row keys except `fused_ta`, which picks
a layout of the TPU's matrix unit and has no counterpart. Two things differ:

* every config runs in this process: the JAX script starts one subprocess per
  config only to keep its TPU runtime out of a slow dispatch mode that mixing
  kernel and non-kernel programs triggers, and the card has no such mode;
* `ms` is the median of CUDA-event times of one `assoc_matvec_univ` call with
  KeR given, the L2 cache flushed before each (the JAX script's chained slope
  cancels a per-dispatch cost of its runtime that the card does not have).
  `kernel_ms` is the one launch of the CUDA kernel alone (kept terms, spill
  terms and Kp X together: no separate spill path is left to time, so the
  rows carry no `spill_ms`), `err_vs_plain` the largest difference from
  `assoc_matvec_univ_plain` relative to its largest value, measured on the
  same device, and `bit_identical` whether two calls gave the same bits.

The sweep first runs `kernels.inoculate.inoculate` (one first launch in every
kernel library, before anything is timed). On `--device cpu` the wrapper (and
`kernel_ms`) is the plain version and every time is a host-clock time of the
CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.build_graphs import build_edges
from ..kernels import assoc_univ as k4
from ..kernels.inoculate import inoculate

CONFIGS = [
    # (r1, r2): r2 stays a multiple of 128; r1 sweeps the other axis
    (8, 128), (16, 128), (32, 128), (64, 128), (32, 256), (16, 256),
]
PRECS = ["highest", "default"]


class Inputs(NamedTuple):
    pts1: np.ndarray
    pts2: np.ndarray
    edges: tuple            # (s1, d1, s2, d2)
    X: torch.Tensor         # (n, n, c) f32
    Kp: torch.Tensor
    Ke: torch.Tensor        # (E1, E2) f32


def make_inputs(device, n: int = 600, c: int = 16, seed: int = 0) -> Inputs:
    """The JAX script's inputs, drawn in the same order from the same seed."""
    rng = np.random.default_rng(seed)
    pts1 = rng.uniform(size=(n, 2)).astype(np.float32) * [400, 300]
    pts2 = rng.uniform(size=(n, 2)).astype(np.float32) * [400, 300]
    _, s1, d1 = build_edges(pts1, stg="tri")
    _, s2, d2 = build_edges(pts2, stg="tri")
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    return Inputs(pts1, pts2, (s1, d1, s2, d2), t(X), t(Kp), t(Ke))


def l2_flush(device) -> Optional[torch.Tensor]:
    """A 256 MB buffer, five times the H100's L2, for `time_ms`'s `flush`
    (None on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.empty(256 << 20, dtype=torch.uint8, device=device)


def time_ms(fn: Callable, device, reps: int = 20,
            flush: Optional[torch.Tensor] = None) -> float:
    """Median time of one call in ms: CUDA events on a CUDA device (after
    three warm-up calls), the host clock on the CPU. `flush` (from
    `l2_flush`) is overwritten before each call so the call finds the L2
    cache cold; the first event is recorded behind it, so the host's time to
    reach the launch passes while the flush runs and is not in the reading."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(3 if cuda else 1):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def profiled_ms(fn: Callable, key: str, reps: int = 10,
                flush: Optional[torch.Tensor] = None) -> Optional[float]:
    """Device time of one launch of the CUDA kernels whose name holds `key`,
    from torch.profiler over `reps` calls of `fn` (one such launch each,
    `flush` overwritten before each; `_measure.profile_window`, after one
    call outside the window): the kernel alone, without the host time that
    `time_ms` may hold. None unless the profiler caught exactly `reps`
    launches, so that a short capture never reads as a fast kernel."""
    from ._measure import launches_of, profile_window

    def call():
        if flush is not None:
            flush.zero_()
        fn()

    fn()
    _, evs = profile_window(call, "cuda", reps, expect={key: reps})
    if launches_of(evs, [key])[key] != reps:
        return None
    return sum(ms for k, (_, ms) in evs.items() if key in k) / reps


def run_one(r1: int, r2: int, prec: str, device="cuda",
            inputs: Optional[Inputs] = None, reps: int = 20) -> Dict:
    """One (r1, r2, precision) row of the sweep."""
    device = resolve_device(device)
    inp = inputs if inputs is not None else make_inputs(device)
    X, Kp, Ke = inp.X, inp.Kp, inp.Ke
    n = X.shape[0]
    hplan = k4.plan_univ(inp.pts1, inp.pts2, *inp.edges, r1=r1, r2=r2,
                         transpose=True)
    plan = hplan.to(device)
    dt = k4.compute_dtype(X, prec)
    KeR = k4.gather_ke_blocks(Ke, plan, dtype=dt)
    cuda = device.type == "cuda"
    if cuda:
        kernel = lambda: k4.launch_kernel(X, Kp, Ke, KeR, plan, prec)
    else:
        kernel = lambda: k4.assoc_matvec_univ_plain(X, Kp, Ke, plan, KeR,
                                                    precision=prec)
    call = lambda: k4.assoc_matvec_univ(X, Kp, Ke, plan, KeR,
                                        precision=prec)
    got, again = call(), call()
    want = k4.assoc_matvec_univ_plain(X, Kp, Ke, plan, KeR, precision=prec)
    err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-30)
    flush = l2_flush(device)
    ms = time_ms(call, device, reps, flush)
    kernel_ms = time_ms(kernel, device, reps, flush)
    nnz = Ke.shape[0] * Ke.shape[1] + n * n
    return {"r1": r1, "r2": r2, "prec": prec, "b1": hplan.b1, "b2": hplan.b2,
            "spill": int(len(hplan.spill1) + len(hplan.spill2)),
            "ker_mb": round(KeR.numel() * KeR.element_size() / 1e6, 1),
            "ms": ms, "edges_per_s": round(nnz / (ms * 1e-3), 0),
            "kernel_ms": kernel_ms,
            "err_vs_plain": err,
            "bit_identical": bool(torch.equal(got, again)),
            "device": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu"}


def sweep(device="cuda", inputs: Optional[Inputs] = None,
          configs=CONFIGS, precs=PRECS, reps: int = 20,
          emit: Callable = print) -> List[Dict]:
    """Every (config, precision) row, each passed to `emit` as a JSON line;
    the kernel libraries are warmed by `inoculate` first."""
    device = resolve_device(device)
    first = inoculate(device)
    emit("# first launch per library (s): " + json.dumps(first))
    inp = inputs if inputs is not None else make_inputs(device)
    rows = []
    for r1, r2 in configs:
        for prec in precs:
            row = run_one(r1, r2, prec, device, inp, reps)
            rows.append(row)
            emit(json.dumps(row))
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fpmatch_tpu_torch.scripts.tune_univ",
        description="Block-size sweep of the blocked UNIV association "
                    "kernel at n=600, C=16")
    p.add_argument("--one", nargs=3, metavar=("R1", "R2", "PREC"),
                   help="run one config only")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error without a GPU) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.one:
        r1, r2, prec = int(args.one[0]), int(args.one[1]), args.one[2]
        if prec not in PRECS:
            raise SystemExit(f"PREC must be one of {PRECS}")
        device = resolve_device(args.device)
        inoculate(device)
        print(json.dumps(run_one(r1, r2, prec, device)))
        return
    rows = sweep(args.device)
    best = max(rows, key=lambda r: r["edges_per_s"])
    print("# best:", json.dumps(best))


if __name__ == "__main__":
    main()
