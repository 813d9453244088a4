"""What the tools of this directory and `chip_smoke.py` measure alike: a
torch.profiler window's device busy time, idle share and launches, the
kernel wrappers' launch counts beside the profiler's, and the card's name
and power limit. Host-clock times are `utils.profiling.call_times`.

On the CPU every device number is None ("not measured"): nothing here
falls back to a CPU figure under a device metric's name.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels import assoc_bucket, assoc_grad, assoc_univ_v3
from ..utils.profiling import synchronize

# the kernels of the tools' paths: wrapper count key -> CUDA kernel name
KERNEL_NAMES = {"assoc_univ_v3": "assoc_univ_v3_kernel",
                "assoc_bucket": "assoc_bucket_kernel",
                "assoc_large": "assoc_large_kernel",
                "assoc_grad": "assoc_grad_kernel"}
_COUNTS = (assoc_univ_v3.LAUNCHES, assoc_bucket.LAUNCHES, assoc_grad.LAUNCHES)
# calls of a short function (one launch or a few) in a launch check's window
LAUNCH_CHECK_CALLS = 10
# see `profile_window`
PRIMER_ADDS = 32
WINDOWS = 3


def wrapper_counts() -> Dict[str, int]:
    """The wrappers' launch counts of K1 / K2 / K3 / K6 so far."""
    return {k: v for c in _COUNTS for k, v in c.items() if k in KERNEL_NAMES}


def counts_since(before: Dict[str, int]) -> Dict[str, int]:
    now = wrapper_counts()
    return {k: now[k] - before[k] for k in now}


def launches_of(events: Dict[str, list], names) -> Dict[str, int]:
    """The launches in `events` of the kernels whose name holds each of
    `names`."""
    return {n: sum(c for k, (c, _) in events.items() if n in k)
            for n in names}


def device_events(prof) -> Dict[str, list]:
    """A finished torch.profiler window's device activity by name:
    [launches, device ms]. Read from the profiler's own records:
    `key_averages()` first builds an event tree, which costs seconds for a
    train step's ~11,500 launches. Left out as `key_averages()` leaves
    them out: hidden events, and user annotations (a record_function range
    shows on the device timeline too, spanning kernels already counted)."""
    out: Dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type().name == "CUDA" and e.duration_ns() > 0
                and not e.is_user_annotation() and not e.is_hidden_event()):
            row = out.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e6
    return out


def _window(fn: Callable, device, calls: int, mark, cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    before = wrapper_counts()
    with (profile(activities=[ProfilerActivity.CUDA]) if cuda
          else contextlib.nullcontext()) as prof:
        for _ in range(PRIMER_ADDS if cuda else 0):
            mark.add_(1)
        t = time.perf_counter()
        for _ in range(calls):
            mark.add_(1)
            fn()
        synchronize(device)
        window = (time.perf_counter() - t) * 1e3
    row = {"profiled_steps": calls, "window_ms": window,
           "wrapper_launches": counts_since(before)}
    if not cuda:
        row.update(device_busy_ms=None, idle_share=None, launches=None,
                   profiler_launches=None)
        return row, {}
    evs = device_events(prof)
    busy = sum(ms for _, ms in evs.values())
    seen = launches_of(evs, KERNEL_NAMES.values())
    row.update(device_busy_ms=busy, idle_share=1.0 - busy / window,
               launches=sum(c for c, _ in evs.values()),
               profiler_launches={k: seen[n] for k, n in KERNEL_NAMES.items()})
    return row, evs


def profile_window(fn: Callable, device, calls: int,
                   expect: Optional[Dict[str, int]] = None) -> Tuple[Dict,
                                                                     Dict]:
    """`calls` calls of `fn`, which has run before (so that first-use costs
    stay out), under torch.profiler (device activity only). Returns a JSON
    row and the window's `device_events`: the window's host
    ms, and on a CUDA device its busy ms (the device time of every kernel,
    copy and set), idle share (1 - busy / window), launches (device
    events), and the launches of K1 / K2 / K3 / K6 by kernel name beside
    the wrappers' counts of the same calls.

    The one workaround for the profiler on the H100 machine, which has
    dropped device records: a window that opened with a lone hand-written
    kernel showed none of it, and after many profiled train steps in one
    process windows of ten calls showed 6-7 of 10. So the window opens
    with `PRIMER_ADDS` one-element adds on the device and each call follows
    one more (all in `launches`, and by microseconds in the busy time), and
    a window that saw fewer launches than it must is taken again, up to
    `WINDOWS` times (`windows` says how many; the last one is returned).
    It must see `expect` (kernel name part -> launches), by default the
    wrappers' counts of K1 / K2 / K3 / K6. A dropped record can only lower
    the profiler's count, so a window that sees every counted launch checks
    the wrappers' counts. On the CPU the calls run in one window without
    the profiler, and the device numbers are None."""
    cuda = torch.device(device).type == "cuda"
    mark = torch.zeros(1, device=device)
    synchronize(device)
    for taken in range(1, WINDOWS + 1):
        row, evs = _window(fn, device, calls, mark, cuda)
        want = expect or {KERNEL_NAMES[k]: v
                          for k, v in row["wrapper_launches"].items()}
        if not cuda or launches_of(evs, want) == want:
            break
    row["windows"] = taken
    return row, evs


def profiled(fn: Callable, device, calls: int) -> Dict:
    """`profile_window`'s JSON row."""
    return profile_window(fn, device, calls)[0]


def card(device="cuda") -> Optional[str]:
    """`nvidia-smi`'s name and power limit of the cards (None on the
    CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
