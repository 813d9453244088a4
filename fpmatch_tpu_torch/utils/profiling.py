"""Profiling and timing helpers (the JAX package's `utils/profiling.py`),
for the card:

- `trace(dir)`: a `torch.profiler` trace of the block (CPU and CUDA
  activities) written for TensorBoard;
- `span(name, args=None)`: the program's own spans, `record_function`
  ranges that land in the same profiler trace as the device events (one
  clock), and only while a profiler records: otherwise one shared
  `nullcontext`, well under a microsecond. Names are `<layer>.<stage>`
  (`evaluate.fetch`, `ngm.affinity`, `op.sinkhorn`); every span opened
  inside a train step's backward (`backward_spans`), on whichever thread,
  ends in `.backward` (`op.assoc.backward`);
- `backward_spans(root, name)`: around `root.backward()`, the span `name`
  on the calling thread and on the autograd engine's thread that runs the
  backward, and the `.backward` suffix for the spans opened meanwhile;
- `call_times` / `time_fn`: the host-clock seconds of each call / their
  median, each call ending in `torch.cuda.synchronize()` on a card, after
  warm-up calls;
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
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

PEAK_DEVICE = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = 3.35e12       # HBM3 bytes/s
F32_FLOPS = 67e12               # float32 outside the tensor cores
BF16_FLOPS = 989e12             # bf16 on the tensor cores, dense


_OFF = contextlib.nullcontext()
# the suffix of every span name, ".backward" while `backward_spans` is open:
# process-wide, so that the autograd engine's threads read it too
_suffix = ""


def span(name: str, args: Optional[str] = None):
    """A `record_function` range `name` (+ `.backward` inside a backward),
    `args` its argument string, while a profiler records; one shared
    `nullcontext` otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name + _suffix, args)


@contextlib.contextmanager
def backward_spans(root: torch.Tensor, name: str):
    """Wrap `root.backward()` (which blocks until the backward has ended) in
    the span `name`, and while a profiler records:

    - the spans opened inside, on any thread, end in `.backward`;
    - the autograd engine runs a CUDA graph on a thread of its own, whose
      launches would fall in no span of this thread: a hook on `root`, the
      backward's first node, opens `name` there too, and a final callback
      of the engine, run by the thread that finishes the backward, closes
      it. A backward the calling thread runs itself (a CPU graph) needs no
      second span.

    Registers nothing while no profiler records."""
    global _suffix
    if not torch.autograd._profiler_enabled():
        yield
        return
    caller = threading.get_ident()

    def enter(grad):
        if threading.get_ident() == caller:
            return
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: rf.__exit__(None, None, None))

    with torch.profiler.record_function(name):
        handle = root.register_hook(enter)
        _suffix = ".backward"
        try:
            yield
        finally:
            _suffix = ""
            handle.remove()


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


def synchronize(device=None) -> None:
    """Wait for the work queued on `device` (by default the card, where
    there is one); nothing to wait for on the CPU."""
    if device is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def call_times(fn: Callable, *args, iters: int = 20, warmup: int = 2,
               device=None) -> list:
    """Host-clock seconds of each of `iters` calls of `fn(*args)` after
    `warmup` ones, every call ending in `synchronize(device)`: on a card
    the host clock then spans the device's work; on the CPU it is a
    host-clock time of the CPU."""
    for _ in range(warmup):
        fn(*args)
    synchronize(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        synchronize(device)
        ts.append(time.perf_counter() - t0)
    return ts


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2,
            device=None) -> float:
    """Median seconds per call of `fn(*args)` (`call_times`)."""
    return float(np.median(call_times(fn, *args, iters=iters, warmup=warmup,
                                      device=device)))


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
