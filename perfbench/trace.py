"""The traced window of a run and its reduction to numbers.

A traced run opens torch.profiler (CPU and CUDA activity) over a short
window of the cell's own work, keeps the events in memory and reduces them:

  * device activity: every device event (kernels, copies, sets) but the
    user annotations, which span kernels already counted; `busy_s` is the
    union of their intervals, `window_s` the host clock around the window;
  * `launches`: the device events, by name too;
  * attribution: `ranges` opens a `record_function` range around each
    top-level child of the model (forward pre- and post-hooks) and around
    the optimizer's step, from the benchmark's side; a device event belongs
    to the innermost range open on the host thread that launched it (the
    launch and the device event share a correlation id);
  * idle gaps: each stretch between device events, named by the range the
    host was in when it launched the event that ends the gap.

The profiler on the H100 machine has dropped device records (a window that
opened with a lone kernel showed none of it), so the window opens with
`PRIMER_ADDS` one-element adds, and a window that saw fewer launches of the
hand-written kernels than their wrappers counted is taken again, up to
`WINDOWS` times (the arithmetic of `fpmatch_tpu_torch/scripts/_measure.py`).
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict

import torch

# what the profiler records: device activity (kernels, copies, the CUDA
# runtime calls, the device-side spans of record_function ranges), and
# with "CPU" the host's operators and ranges too
ACTIVITIES = ("CPU", "CUDA")
PRIMER_ADDS = 32
WINDOWS = 3
UNATTRIBUTED = "host (no range)"
UNRECORDED = "launch not recorded"
OTHER_THREAD = "autograd backward (other thread)"


class Ranges:
    """`record_function` ranges around the model's top-level children (and
    the model itself, and an optimizer's step), opened by hooks registered
    from the benchmark; `close()` removes the hooks."""

    def __init__(self, model, prefix: str, optimizer=None):
        from torch.autograd.profiler import record_function

        self._open: Dict[int, list] = {}
        self.handles = []

        def enter(name):
            def hook(mod, *args):
                rf = record_function(name)
                rf.__enter__()
                self._open.setdefault(id(mod), []).append(rf)
            return hook

        def leave(mod, *args):
            stack = self._open.get(id(mod))
            if stack:
                stack.pop().__exit__(None, None, None)

        mods = [(prefix + ".forward", model)] + [
            (f"{prefix}.{n}", m) for n, m in model.named_children()]
        for name, m in mods:
            self.handles.append(m.register_forward_pre_hook(enter(name)))
            self.handles.append(m.register_forward_hook(leave))
        if optimizer is not None:
            key = optimizer
            self.handles.append(optimizer.register_step_pre_hook(
                lambda opt, a, k: enter(prefix + ".optimizer")(key)))
            self.handles.append(optimizer.register_step_post_hook(
                lambda opt, a, k: leave(key)))

    def close(self):
        for h in self.handles:
            h.remove()


def _is_device(e) -> bool:
    return e.device_type().name == "CUDA" and not e.is_user_annotation() \
        and not e.is_hidden_event() and e.duration_ns() > 0


WINDOW = "perfbench.window"


def _innermost(rs, starts, t):
    """Name of the innermost range of `rs` (sorted (lo, hi, name), nested)
    that holds time t: the latest opened before t that has not closed."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if rs[i][1] >= t:
            return rs[i][2]
    return None


def reduce_events(events, main_thread: int) -> dict:
    """The window's device events reduced: busy union, launches by name,
    device seconds by range and by name, idle gaps by range. A device
    event's range is the innermost host range open where its launch was
    made (when the profiler recorded the host side) or else the innermost
    device-side span of a range that holds it. Events launched (or run)
    before the range `WINDOW` opened, the primer adds, are left out."""
    dev, runtime, host, spans = [], {}, {}, []
    for e in events:
        if _is_device(e):
            dev.append(e)
        elif e.device_type().name == "CUDA" and e.is_user_annotation():
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name()))
        elif e.device_type().name == "CPU":
            if e.is_user_annotation():
                host.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.name().startswith("cu") and e.correlation_id():
                runtime[e.correlation_id()] = e        # a launch, a copy
    for rs in list(host.values()) + [spans]:
        rs.sort()
    host_starts = {tid: [r[0] for r in rs] for tid, rs in host.items()}
    span_starts = [r[0] for r in spans]

    def launch_of(e):
        return runtime.get(e.linked_correlation_id() or e.correlation_id())

    def range_of(e) -> str:
        launch = launch_of(e)
        if launch is not None and host:
            tid = launch.start_thread_id()
            name = _innermost(host.get(tid, []), host_starts.get(tid, []),
                              launch.start_ns())
            if name is not None:
                return name
            return UNATTRIBUTED if tid == main_thread else OTHER_THREAD
        return _innermost(spans, span_starts, e.start_ns()) or UNRECORDED

    opened = min((lo for rs in host.values() for lo, _, n in rs
                  if n == WINDOW), default=None)
    if opened is not None:
        dev = [e for e in dev if launch_of(e) is None
               or launch_of(e).start_ns() >= opened]
    else:
        dev_open = min((lo for lo, _, n in spans if n == WINDOW),
                       default=None)
        if dev_open is not None:
            dev = [e for e in dev if e.start_ns() >= dev_open]
    dev.sort(key=lambda e: e.start_ns())
    by_name: Dict[str, list] = {}
    by_range: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    busy_ns, cur_lo, cur_hi = 0, None, None
    for e in dev:
        lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        rng = range_of(e)
        row = by_name.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += e.duration_ns() / 1e9
        by_range[rng] = by_range.get(rng, 0.0) + e.duration_ns() / 1e9
        if cur_hi is None:
            cur_lo, cur_hi = lo, hi
        elif lo > cur_hi:
            busy_ns += cur_hi - cur_lo
            gaps[rng] = gaps.get(rng, 0.0) + (lo - cur_hi) / 1e9
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy_ns += cur_hi - cur_lo
    return {"busy_s": busy_ns / 1e9, "launches": len(dev),
            "by_name": by_name, "by_range": by_range, "gaps": gaps,
            "host_ranges": bool(host), "device_spans": len(spans),
            "runtime_events": len(runtime)}


def launches_of(by_name: Dict[str, list], part: str) -> int:
    return sum(c for k, (c, _) in by_name.items() if part in k)


def profiled_window(fn: Callable[[], int], expect: Callable[[], Dict[str, int]]
                    ) -> dict:
    """Run `fn` (which returns the pairs it completed, and synchronizes
    the device before it returns) under torch.profiler, opened with the
    primer adds; retaken while the profiler saw fewer launches of a kernel
    than `expect()` (kernel name part -> launches counted by the wrappers,
    read after `fn`) says. Returns the reduction with `window_s` (host
    clock around `fn`), `pairs` and `windows` (how many were taken)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    main = threading.get_native_id()
    for taken in range(1, WINDOWS + 1):
        before = expect()
        with profile(activities=[getattr(ProfilerActivity, a)
                                 for a in ACTIVITIES]) as prof:
            for _ in range(PRIMER_ADDS):
                mark.add_(1)
            with record_function(WINDOW):
                t = time.perf_counter()
                pairs = fn()
                window = time.perf_counter() - t
        after = expect()
        want = {k: after[k] - before[k] for k in after}
        red = reduce_events(prof.profiler.kineto_results.events(), main)
        red.update(window_s=window, pairs=pairs, windows=taken,
                   wrapper_launches=want)
        if all(launches_of(red["by_name"], k) >= v for k, v in want.items()):
            break
    return red


def breakdown(red: dict) -> dict:
    """The `--trace 1` line's breakdown: the 10 device operations that took
    most time and the 10 largest idle totals by host range, in seconds."""
    ops = sorted(((n, s) for n, (_, s) in red["by_name"].items()),
                 key=lambda r: -r[1])[:10]
    gaps = sorted(red["gaps"].items(), key=lambda r: -r[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
