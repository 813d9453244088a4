"""Idle time of the traced window under the program's own spans
(`fpmatch_tpu_torch/utils/profiling.span`), as a share of the window: the
per-layer metrics that split `eval.device_idle_share` and
`train.device_idle_share` by where the host was when the card went idle.

A gap between device events belongs to the innermost range open where the
event that ends it was launched (`trace.reduce_events`). A program without
the spans (one older than them) gives no reading: None, not 0.
"""
from __future__ import annotations


def share(ctx, names=(), suffix=None, also=()):
    """100 x the idle seconds under the spans `names` and every span whose
    name ends in `suffix`, plus under the benchmark's own names `also`, over
    the window's seconds. None without a trace, or where no span of the
    program that `names` / `suffix` pick was open under any device event or
    gap of the window."""
    t = ctx.get("trace")
    if not t or not t.get("window_s") or "gaps" not in t:
        return None
    gaps, by_range = t["gaps"], t.get("by_range", {})

    def ours(name):
        return name in names or (suffix is not None and name.endswith(suffix))

    if not any(ours(n) for n in list(gaps) + list(by_range)):
        return None
    idle = sum(s for n, s in gaps.items() if ours(n) or n in also)
    return 100.0 * idle / t["window_s"]
