"""Where a train step goes: the step split into forward, backward and
optimizer, and what each model option costs, on the card.

    python -m fpmatch_tpu_torch.scripts.profile_train_step [--device cuda]
        [--steps 10] [--profile-steps 3]

`Config()` at full width, n_max 64, a batch of 8 (`run` takes another
size from Python callers) synthetic pairs (`synthetic_pair_batch`, half genuine, seed 0), stage 3
(every partition trains: K2 forward, K2 / K3 dX and K6 run). Variants:

  forward_eval      the eval-mode forward (no autograd)
  forward_train     the train-mode forward and the stage's loss
  forward_backward  the same and its backward
  optimizer_step    the step's clipping (where the stage clips) and AdamW
                    update alone, on the gradients of the last backward
  train_step        the full step (`train.step.make_train_step`: backward,
                    clipping, AdamW)

then the full step under each ablation of the JAX package's profiler
(`remat_sinkhorn` off, `sk_iter` 5, `sk_layer_iter` 5, `topk_extra_iter`
2, `regression` off, the backbone in bf16), each on a model made anew from
seed 0. Per variant: the median host ms of `--steps` calls after two
warm-up calls (each call ends in `torch.cuda.synchronize()`), pairs/s from
it, and from torch.profiler over `--profile-steps` more calls the device's
busy ms, idle share and launches, with the K1 / K2 / K3 / K6 launches by
kernel name beside the wrappers' counts of the same calls. The JAX
script's chained-slope timing answers the TPU's dispatch and is not
carried over. `split_ms`: the step's forward (forward_train), backward
(forward_backward less forward_train) and optimizer (optimizer_step).
Prints one JSON line; the card's name and power limit are in it. `--device
cpu` runs the same on the CPU (host times of the CPU; the device numbers
are null).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict

import numpy as np

from .. import resolve_device
from ..core.config import Config, default_stages
from ..data.synthetic import synthetic_pair_batch
from ..models import ngm
from ..train.state import clip_by_global_norm_, create_state
from ..train.step import loss_and_metrics, make_train_step
from ..utils.profiling import call_times
from . import _measure

SEED = 0


def ablations(cfg: Config) -> Dict[str, Config]:
    """The JAX profiler's ablations, by its labels (sk_iter's default is
    10 in both packages)."""
    ngm_cfg = lambda **kw: dataclasses.replace(  # noqa: E731
        cfg, ngm=dataclasses.replace(cfg.ngm, **kw))
    return {
        "no remat_sinkhorn": ngm_cfg(remat_sinkhorn=False),
        "sk_iter ->5": ngm_cfg(sk_iter=5),
        "sk_layer_iter ->5": ngm_cfg(sk_layer_iter=5),
        "topk_extra_iter ->2": ngm_cfg(topk_extra_iter=2),
        "no AFA-U (regression off)": ngm_cfg(regression=False),
        "backbone bf16": dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone,
                                              dtype="bfloat16")),
    }


def measure(fn: Callable, device, batch_size: int, steps: int,
            profile_steps: int) -> Dict:
    t = time.perf_counter()
    ms = [s * 1e3 for s in call_times(fn, iters=steps, device=device)]
    med = float(np.median(ms))
    row = {"median_ms": med, "ms": ms, "pairs_per_s": batch_size / med * 1e3}
    row.update(_measure.profiled(fn, device, profile_steps))
    row["measure_s"] = time.perf_counter() - t
    return row


def step_variants(model, batch, stage) -> Dict[str, Callable]:
    """The views of one step on the same model and batch, in the order
    they run: `optimizer_step` needs the gradients of `forward_backward`;
    the last two change the weights."""
    state = create_state(model, stage)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]

    def forward_eval():
        return loss_and_metrics(model, batch, stage, train=False)

    def forward_train():
        return loss_and_metrics(model, batch, stage, train=True)[0]

    def forward_backward():
        for p in params:
            p.grad = None
        forward_train().backward()

    def optimizer_step():
        # on the gradients the last backward left (the weights drift from
        # step to step, which the timing does not see)
        if stage.grad_clip is not None:
            clip_by_global_norm_(params, stage.grad_clip)
        state.optimizer.step()

    train_step = make_train_step(model, stage)
    return {"forward_eval": forward_eval, "forward_train": forward_train,
            "forward_backward": forward_backward,
            "optimizer_step": optimizer_step,
            "train_step": lambda: train_step(state, batch)}


def run(device="cuda", steps: int = 10, profile_steps: int = 3,
        batch_size: int = 8) -> Dict:
    device = resolve_device(device)
    cfg = Config()
    batch = synthetic_pair_batch(cfg, batch_size, genuine_ratio=0.5,
                                 seed=SEED).to(device)
    stage = default_stages()[2]
    out = {"device": device.type,
           "card": _measure.card(device), "batch_size": batch_size,
           "n_max": cfg.shapes.n_max, "stage": stage.name, "variants": {}}
    model = ngm.build_model(cfg, device=device, seed=SEED)
    for name, fn in step_variants(model, batch, stage).items():
        out["variants"][name] = measure(fn, device, batch_size, steps,
                                        profile_steps)
    del model
    for label, acfg in ablations(cfg).items():
        model = ngm.build_model(acfg, device=device, seed=SEED)
        fn = step_variants(model, batch, stage)["train_step"]
        out["variants"][f"train_step [{label}]"] = measure(
            fn, device, batch_size, steps, profile_steps)
        del model
    v = {k: r["median_ms"] for k, r in out["variants"].items()}
    for name, row in out["variants"].items():
        row["delta_vs_train_step_ms"] = v[name] - v["train_step"]
    out["split_ms"] = {
        "forward": v["forward_train"],
        "backward": v["forward_backward"] - v["forward_train"],
        "optimizer": v["optimizer_step"]}
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10,
                    help="timed calls per variant, after two warm-up calls")
    ap.add_argument("--profile-steps", type=int, default=3,
                    help="calls per variant under torch.profiler")
    return ap


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    out = run(args.device, args.steps, args.profile_steps)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
