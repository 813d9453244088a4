"""Profiling and timing helpers (the JAX package's `utils/profiling.py`),
for the card:

- `trace(dir)`: a `torch.profiler` trace of the block (CPU and CUDA
  activities) written for TensorBoard;
- `time_fn`: the median seconds of a call, each call ending in
  `torch.cuda.synchronize()`, after warm-up calls;
- `assoc_roofline`: the association aggregation's achieved against
  light-speed edges/s from the bytes it must move.

The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense, at its
700 W limit); `chip_smoke.py`'s bounds read the same constants. The JAX
package's dispatch probes of its TPU runtime (`dispatch_health_ms`,
`warn_if_degraded_dispatch`) have no counterpart: the card has no such
degraded dispatch mode.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

PEAK_DEVICE = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = 3.35e12       # HBM3 bytes/s
F32_FLOPS = 67e12               # float32 outside the tensor cores
BF16_FLOPS = 989e12             # bf16 on the tensor cores, dense


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU and, where there is a card, CUDA
    activities), written to `log_dir` for TensorBoard's profiler plugin.
    Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> float:
    """Median seconds per call of `fn(*args)` over `iters` calls after
    `warmup` ones; where there is a card every call ends in
    `torch.cuda.synchronize()` (the host clock then spans the device's
    work). Without one it is a host-clock time of the CPU."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    for _ in range(warmup):
        fn(*args)
    sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclass
class AssocRoofline:
    seconds: float
    nnz: int
    bytes_moved: int
    achieved_edges_per_s: float
    lightspeed_edges_per_s: float
    efficiency: float


def assoc_roofline(seconds: float, batch: int, n1: int, n2: int, e1: int,
                   e2: int, channels: int, dtype_bytes: int = 4,
                   hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> AssocRoofline:
    """Roofline of the factorized aggregation: it must at least read Ke
    (E1 E2), read X and write Y (N1 N2 C each), batch * dtype_bytes *
    (E1 E2 + 2 N1 N2 C) bytes; light-speed edges/s follows from that traffic
    at `hbm_bytes_per_s` (default: PEAK_DEVICE's)."""
    nnz = batch * (e1 * e2 + n1 * n2)
    traffic = batch * dtype_bytes * (e1 * e2 + 2 * n1 * n2 * channels)
    t_light = traffic / hbm_bytes_per_s
    return AssocRoofline(
        seconds=seconds, nnz=nnz, bytes_moved=traffic,
        achieved_edges_per_s=nnz / seconds,
        lightspeed_edges_per_s=nnz / t_light,
        efficiency=t_light / seconds)
