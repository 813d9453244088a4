"""Training: the window drives the program's `train.step.make_train_step`
on one stage of the curriculum (the traffic's `stage`), AdamW from
`train.state.create_state`.

Set-up builds one model and its optimizer state from the seed's weights and
drives them through the first three steps with the window's own step
function, on three different batches of the pool, keeping what the
comparison needs (the loss terms of each step, the optimizer's first moment
after step 1, the parameters after step 3); a fourth step finishes the
warm-up. Before the window opens it copies the state the window starts
from: parameters, batch-norm statistics, AdamW's moments and step count.
The window goes on with the same objects, cycling the pool, until the
deadline and for at least two steps; it keeps the loss terms and matching
maps of its first two steps and copies the parameters after its first (one
multi-tensor copy into buffers made at set-up); the host enqueues the
steps without waiting and the window closes when the card has finished the
last one.

Afterwards the reference follows both stretches on the same batches and
judges them (`perfbench/compare.py`): the first three steps from the
seed's weights, and the window's first two steps from the copied state.
"""
from __future__ import annotations

import gc
import time

from .. import compare, harness
from ..counts import kernels as kcount
from ..counts import model as mcount
from ..reference import model as ref
from ..traffic.generator import make_pool

CHECKED_STEPS = 3
# the window's checked steps: the loss terms and matching maps of its first
# two, the parameters' change after its first (from the third step on, a
# pair near a tie under Sinkhorn's tau = 0.01 can send the program and the
# reference apart, as it sends two runs of the program apart)
WINDOW_STEPS = 2
WINDOW_CHANGE_AFTER = 1
# leaves whose float64 reference gradient is under this share of the median
# leaf's move by round-off alone under Adam: left out of the change
NEGLIGIBLE = 1e-6
ZERO_PAIRS = 32
# per-leaf readings in the numbers (for calibration runs)
DETAIL = False
PARTITIONS = {"afau": "k", "match_cls": "cls", "backbone": "backbone"}


def partition(name: str) -> str:
    return PARTITIONS.get(name.split(".", 1)[0], "main")


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float = None, port_overrides=None) -> dict:
    import torch

    from fpmatch_tpu_torch.core.config import default_stages
    from fpmatch_tpu_torch.kernels import assoc_bucket, assoc_grad
    from fpmatch_tpu_torch.models.ngm import PairBatch, build_model
    from fpmatch_tpu_torch.train.state import create_state
    from fpmatch_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter() if t0 is None else t0
    marks = {"imports": time.perf_counter() - t0}
    traffic, spec = cell.traffic, cell.spec
    B = spec["batch"]
    cfg = harness.port_config(cell.config, traffic)
    if port_overrides:
        cfg = port_overrides(cfg)
    weights = harness.make_weights(harness.model_shapes(cfg), seed, device)
    model = build_model(cfg, device=device, state_dict=weights)
    marks["model"] = time.perf_counter() - t0
    pool = make_pool(traffic, B, seed, device)
    marks["pool"] = time.perf_counter() - t0
    batches = [PairBatch(**b) for b in pool]
    stage = default_stages()[traffic["stage"] - 1]
    state = create_state(model, stage)
    step = make_train_step(model, stage)
    names = {id(p): n for n, p in model.named_parameters()}

    maps = []     # the forward's `ds_mat` of each checked step
    hook = model.register_forward_hook(
        lambda module, args, out: maps.append(out["ds_mat"].detach()))
    losses, first_grad = [], None
    for i in range(CHECKED_STEPS):
        state, metrics = step(state, batches[i])
        losses.append({k: v.clone() for k, v in metrics.items()})
        if i == 0:
            first_grad = first_moment(state.optimizer, names)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    hook.remove()
    state, _ = step(state, batches[CHECKED_STEPS % len(batches)])
    done = CHECKED_STEPS + 1
    start = snapshot(model, state.optimizer, names)
    live = [p for _, p in model.named_parameters()]
    ends = [torch.empty_like(p) for p in live]
    window_losses, window_maps, checked = [], [], []
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def window():
        nonlocal state, done
        deadline = time.perf_counter() + seconds
        steps = 0
        limit = traffic["trace_steps"] if trace else None
        # the first steps of the first window taken are checked (a traced
        # run may retake its window)
        checking = not checked
        if checking:
            hook = model.register_forward_hook(
                lambda module, args, out: window_maps.append(
                    out["ds_mat"].detach()))
        while steps < WINDOW_STEPS or (time.perf_counter() < deadline
                                       and (limit is None or steps < limit)):
            slot = done % len(batches)
            state, metrics = step(state, batches[slot])
            done += 1
            steps += 1
            if checking and steps <= WINDOW_STEPS:
                window_losses.append(metrics)
                checked.append(slot)
                if steps == WINDOW_CHANGE_AFTER:
                    with torch.no_grad():
                        torch._foreach_copy_(ends, live)
                if steps == WINDOW_STEPS:
                    hook.remove()
        if device == "cuda":
            torch.cuda.synchronize()
        window.steps = steps
        return steps * B

    red = None
    if trace:
        from .. import trace as tr

        ranges = tr.Ranges(model, "train", state.optimizer)
        try:
            red = tr.profiled_window(window, lambda: {
                "assoc_bucket_kernel": assoc_bucket.LAUNCHES["assoc_bucket"],
                "assoc_grad_kernel": assoc_grad.LAUNCHES["assoc_grad"]})
        finally:
            ranges.close()
        pairs, wall = red["pairs"], red["window_s"]
    else:
        t = time.perf_counter()
        pairs = window()
        wall = time.perf_counter() - t
    steps = window.steps
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else None)

    # the work of the window's steps, from the batches' own counts
    first = done - steps
    slots = [(first + i) % len(batches) for i in range(steps)]
    counts = [(b["n_nodes"].cpu().numpy(), b["n_edges"].cpu().numpy())
              for b in pool]
    flops = mcount.TRAIN_FACTOR * sum(
        mcount.batch_flops(cell.config, traffic["image_hw"], *counts[s])
        for s in slots)
    k6_bound = sum(kcount.bound_s(*kcount.k6_work(*counts[s], C))
                   for s in slots for C in kcount.layer_channels(cell.config))

    del model, state, step, batches, live
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    window_after = dict(zip(names.values(), ends))
    window_batches = [pool[slot] for slot in checked]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    zero = zero_leaves(weights, cell.config, traffic, pool[0])
    numbers = judge(cell, {"weights": weights}, pool[:CHECKED_STEPS], losses,
                    maps, first_grad, after, CHECKED_STEPS, zero)
    numbers.update({f"window_{k}": v for k, v in judge(
        cell, start, window_batches, window_losses, window_maps, None,
        window_after, WINDOW_CHANGE_AFTER, zero).items()})
    numbers["zero_leaves"] = zero
    numbers["reference_s"] = time.perf_counter() - t
    if device == "cuda":
        numbers["reference_peak_bytes"] = torch.cuda.max_memory_allocated()
    numbers["setup_marks_s"] = marks
    return {"attempted": steps, "failed": 0, "setup_s": setup_s,
            "e2e": {"train_pairs_per_s": pairs / wall, "setup_s": setup_s},
            "numbers": numbers, "memory_peak": memory_peak, "trace": red,
            "work": {"pairs": pairs, "steps": steps, "flops": flops,
                     "kernel_bound_s": {"assoc_grad_kernel": k6_bound}}}


def first_moment(optimizer, names) -> dict:
    """{leaf: the first step's gradient as AdamW got it}: its first moment
    after that step over 1 - beta1."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    return {names[id(p)]: s["exp_avg"] / (1 - beta1)
            for p, s in optimizer.state.items()}


def snapshot(model, optimizer, names) -> dict:
    """A copy of the state a stretch of steps starts from: the model's
    `state_dict` (`weights`), and by leaf AdamW's moments and step count (a
    leaf AdamW has not stepped has none)."""
    import torch

    with torch.no_grad():
        state = {names[id(p)]: s for p, s in optimizer.state.items()}
        return {"weights": {n: t.detach().clone()
                            for n, t in model.state_dict().items()},
                "exp_avg": {n: s["exp_avg"].clone()
                            for n, s in state.items()},
                "exp_avg_sq": {n: s["exp_avg_sq"].clone()
                               for n, s in state.items()},
                "step": {n: int(s["step"]) for n, s in state.items()}}


def reference_steps(start, config, traffic, batches, change_after=None):
    """The reference's steps from `start` (`snapshot`'s keys; a leaf
    without moments takes AdamW's first step) over `batches`: the stage's loss terms,
    its gradient by autograd, AdamW (decoupled weight decay) at the stage's
    learning rate per partition. Returns (losses, each step's `ds_mat`, the
    first step's gradient, parameters after `change_after` steps, by
    default all)."""
    import torch

    opt = traffic["optimizer"]
    weights = start["weights"]
    params = {n: t.clone().requires_grad_(True) for n, t in weights.items()
              if t.is_floating_point() and n.rsplit(".", 1)[-1]
              not in ("running_mean", "running_var")}
    buffers = {n: t for n, t in weights.items() if n not in params}
    m = {n: start.get("exp_avg", {}).get(n, torch.zeros_like(p)).clone()
         for n, p in params.items()}
    v = {n: start.get("exp_avg_sq", {}).get(n, torch.zeros_like(p)).clone()
         for n, p in params.items()}
    steps = start.get("step", {})
    b1, b2 = opt["betas"]
    losses, maps, first, kept = [], [], None, None
    with ref.no_tf32():
        for i, batch in enumerate(batches, start=1):
            out = ref.forward({**params, **buffers}, config, batch,
                              train=True)
            n1, n2 = batch["n_nodes"][:, 0], batch["n_nodes"][:, 1]
            terms = {"loss": ref.permutation_loss(out["ds_mat"],
                                                  batch["gt_perm"], n1, n2),
                     "ks_loss": out["ks_loss"], "cls_loss": out["cls_loss"]}
            total = sum(terms[k] for k in traffic["loss_terms"])
            grads = torch.autograd.grad(total, list(params.values()),
                                        allow_unused=True)
            losses.append({"total_loss": float(total.detach()),
                           **{k: float(x.detach()) for k, x in terms.items()}})
            maps.append(out["ds_mat"].detach())
            with torch.no_grad():
                g = {n: torch.zeros_like(p) if gr is None else gr
                     for (n, p), gr in zip(params.items(), grads)}
                if first is None:
                    first = {n: x.clone() for n, x in g.items()}
                for n, p in params.items():
                    t = steps.get(n, 0) + i
                    lr = opt["lr"][partition(n)]
                    p.mul_(1 - lr * opt["weight_decay"])
                    m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                    denom = (v[n] / (1 - b2 ** t)).sqrt() + opt["eps"]
                    p.sub_(lr * (m[n] / (1 - b1 ** t)) / denom)
                if i == change_after:
                    kept = {n: p.detach().clone() for n, p in params.items()}
    if kept is None:
        kept = {n: p.detach() for n, p in params.items()}
    return losses, maps, first, kept


def zero_leaves(weights, config, traffic, batch) -> list:
    """The leaves whose gradient is nought but for rounding: the reference's
    first gradient worked out in float64 (on `weights` and the first
    `ZERO_PAIRS` pairs of `batch`; the whole batch does not fit on the card
    in float64) is under `NEGLIGIBLE` of the median leaf's. They are the
    same leaves from any state and batch (dead branches, biases under a
    shift that Sinkhorn or a norm removes)."""
    import torch

    def wide(t):
        return t.double() if t.is_floating_point() else t

    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        _, _, grad, _ = reference_steps(
            {"weights": {n: wide(t) for n, t in weights.items()}}, config,
            traffic, [{k: wide(v[:ZERO_PAIRS]) for k, v in batch.items()}])
    finally:
        torch.set_default_dtype(old)
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grad.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return sorted(n for n, x in norms.items() if x < NEGLIGIBLE * med)


def judge(cell, start, batches, losses, maps, first_grad, after,
          change_after, zero=()):
    """A stretch of the program's steps from `start` over `batches` against
    the reference's: `compare`'s numbers. `first_grad` None: the stretch's
    first gradient is not compared; `after` holds the parameters after
    `change_after` steps; the leaves in `zero` are left out of the change."""
    import torch

    ref_losses, ref_maps, ref_grad, ref_after = reference_steps(
        start, cell.config, cell.traffic, batches, change_after)
    weights = start["weights"]
    numbers = {}
    for key, name in (("total_loss", "loss_gap"), ("loss", "perm_loss_gap"),
                      ("ks_loss", "ks_loss_gap"),
                      ("cls_loss", "cls_loss_gap")):
        numbers[name] = max(abs(float(p[key]) - r[key]) / max(abs(r[key]),
                                                              1e-30)
                            for p, r in zip(losses, ref_losses))
    gaps = [compare.map_gaps(p, r) for p, r in zip(maps, ref_maps)]
    if len(maps) != len(ref_maps) or any(g is None for g in gaps):
        numbers.update(ds_gap=1.0, ds_gap_median=1.0)
    else:
        numbers.update(ds_gap=max(float(g.max()) for g in gaps),
                       ds_gap_median=max(compare.matched_median(g, r)
                                         for g, r in zip(gaps, ref_maps)))
    keep = set(ref_grad) - set(zero)
    change = compare.leaf_gaps({n: after[n] - weights[n] for n in ref_after},
                               {n: ref_after[n] - weights[n]
                                for n in ref_after}, keep)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])
    numbers.update(
        change_gap=top(change)[0][1],
        change_gap_median=sorted(change.values())[len(change) // 2],
        change_worst_leaves=top(change)[:4],
        leaves_left_out=len(set(ref_grad) - keep))
    if first_grad is not None:
        grad = compare.leaf_gaps(first_grad, ref_grad)
        numbers.update(grad_gap=top(grad)[0][1],
                       grad_gap_median=sorted(grad.values())[len(grad) // 2],
                       grad_worst_leaves=top(grad)[:4])
    if DETAIL:
        gnorm = {n: float(torch.linalg.vector_norm(g))
                 for n, g in ref_grad.items()}
        med = sorted(gnorm.values())[len(gnorm) // 2]
        every = compare.leaf_gaps(
            {n: after[n] - weights[n] for n in ref_after},
            {n: ref_after[n] - weights[n] for n in ref_after})
        numbers["leaves"] = {n: [gnorm[n] / med, every[n]] for n in gnorm}
        steps = []
        for b, p, r, lp, lr in zip(batches, maps, ref_maps, losses,
                                   ref_losses):
            g = compare.rel_frobenius(p.float(), r.float())
            i = int(g.argmax())
            steps.append({"ds_gap": float(g[i]), "pair": i,
                          "ds_gap_median": compare.matched_median(g, r),
                          "n": b["n_nodes"][i].tolist(),
                          "next": sorted(g.tolist())[-4:-1],
                          "loss": {k: [float(lp[k]), lr[k]] for k in lr}})
        numbers["steps"] = steps
    return numbers
