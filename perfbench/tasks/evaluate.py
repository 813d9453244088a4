"""Batched verification: the window drives the program's
`cli.evaluate.evaluate_loader` over a closed loop of the run's batches.

Set-up builds the model from the seed's weights, the pool of batches on the
card, and warms up by one pass of `evaluate_loader` over the pool (every
shape the window uses). The window hands `evaluate_loader` a loader that
cycles the pool and stops yielding at the deadline; the next batch starts
when `evaluate_loader` has taken the last one's scores back to the host,
and the window closes when it returns, its `verification_metrics`
included. The program's data loader (workers, pinned memory, the copy to
the card) is not in the window: the batches are on the card already.

Afterwards the reference runs on every batch of the pool and judges the
window's outputs (`perfbench/compare.py`).
"""
from __future__ import annotations

import gc
import time

import numpy as np

from .. import compare, harness
from ..counts import kernels as kcount
from ..counts import model as mcount
from ..reference import model as ref
from ..traffic.generator import make_pool


class DeadlineLoader:
    """Cycles `batches` until `deadline` (perf_counter seconds) or
    `max_batches`; records the pool index of every batch yielded."""

    def __init__(self, batches, deadline=None, max_batches=None):
        self.batches, self.deadline = batches, deadline
        self.max_batches = max_batches
        self.slots = []

    def __len__(self):
        return self.max_batches or 0

    def __iter__(self):
        i = 0
        while (self.max_batches is None or i < self.max_batches) and (
                self.deadline is None or time.perf_counter() < self.deadline):
            slot = i % len(self.batches)
            self.slots.append(slot)
            yield self.batches[slot]
            i += 1


class Keeper:
    """The `on_batch` hook: keeps every batch's greedy picks (as booleans),
    and per pool slot the outputs of one occurrence drawn from the seed
    (reservoir sampling), all on the card."""

    def __init__(self, pool_size: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.picks = []
        self.seen = [0] * pool_size
        self.sampled = [None] * pool_size
        self.pool_size = pool_size

    def __call__(self, bi, batch, out):
        slot = bi % self.pool_size
        self.picks.append(out["perm_mat"] != 0)
        self.seen[slot] += 1
        if self.rng.integers(self.seen[slot]) == 0:
            self.sampled[slot] = {k: out[k].clone() for k in
                                  ("ds_mat", "perm_mat", "k_prob")}


def reference_outputs(weights, config, batch, block: int):
    """The reference on one batch, in blocks of `block` pairs."""
    import torch

    B = batch["label"].shape[0]
    outs = []
    with torch.no_grad(), ref.no_tf32():
        for lo in range(0, B, block):
            part = {k: v[lo:lo + block] for k, v in batch.items()}
            o = ref.forward(weights, config, part)
            outs.append({k: o[k] for k in ("k_prob", "sinkhorn",
                                           "raw_scores")})
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float = None, port_overrides=None) -> dict:
    import torch

    from fpmatch_tpu_torch.cli.evaluate import evaluate_loader
    from fpmatch_tpu_torch.kernels import assoc_bucket
    from fpmatch_tpu_torch.models.ngm import PairBatch, build_model

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
    kw = dict(score=traffic["score"], discretize=traffic["discretize"])
    evaluate_loader(model, DeadlineLoader(batches, max_batches=len(batches)),
                    **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    red = None

    def window():
        """One window (a traced run may take it again): a fresh loader
        and keeper, the pairs scored."""
        window.keeper = Keeper(len(batches), seed)
        window.loader = DeadlineLoader(
            batches, deadline=time.perf_counter() + seconds,
            max_batches=traffic["trace_batches"] if trace else None)
        window.res = evaluate_loader(model, window.loader,
                                     on_batch=window.keeper, **kw)
        return len(window.res["labels"])

    if trace:
        from .. import trace as tr

        ranges = tr.Ranges(model, "ngm")
        try:
            red = tr.profiled_window(window, lambda: {
                "assoc_bucket_kernel": assoc_bucket.LAUNCHES["assoc_bucket"]})
        finally:
            ranges.close()
        pairs, wall = red["pairs"], red["window_s"]
    else:
        t = time.perf_counter()
        pairs = window()
        wall = time.perf_counter() - t
    res, keeper = window.res, window.keeper
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else None)
    slots = list(window.loader.slots)
    n_slot = [slots.count(i) for i in range(len(batches))]

    # the work the window did, from the batches' own counts
    counts = [(b["n_nodes"].cpu().numpy(), b["n_edges"].cpu().numpy())
              for b in pool]
    flops = sum(n * mcount.batch_flops(cell.config, traffic["image_hw"], *c)
                for n, c in zip(n_slot, counts))
    k2_bound = sum(n * sum(kcount.bound_s(*kcount.k2_work(*c, C))
                           for C in kcount.layer_channels(cell.config))
                   for n, c in zip(n_slot, counts))

    # free the program's state before the reference runs
    del model, window
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers, failed = judge(cell, weights, pool, slots, res, keeper, seed)
    numbers["reference_s"] = time.perf_counter() - t
    numbers["setup_marks_s"] = marks
    return {"attempted": pairs, "failed": failed, "setup_s": setup_s,
            "e2e": {"pairs_per_s": pairs / wall, "setup_s": setup_s},
            "numbers": numbers, "memory_peak": memory_peak, "trace": red,
            "work": {"pairs": pairs, "flops": flops,
                     "kernel_bound_s": {"assoc_bucket_kernel": k2_bound}}}


def judge(cell, weights, pool, slots, res, keeper, seed):
    """The window's outputs against the reference: the numbers of
    `compare` and the count of pairs that fail a limit. The reference runs
    on `reference_pairs` rows of each pool batch, drawn from the seed; the
    picks' validity is checked on every pair."""
    import torch

    spec = cell.spec
    B = spec["batch"]
    n_ref = min(B, spec["reference_pairs"])
    rng = np.random.default_rng(seed)
    rows = [torch.as_tensor(np.sort(rng.choice(B, n_ref, replace=False)),
                            device=pool[0]["label"].device) for _ in pool]
    subs = [{k: v[r] for k, v in b.items()} for b, r in zip(pool, rows)]
    own = [reference_outputs(weights, cell.config, sb, spec["reference_block"])
           for sb in subs]
    k_prog = torch.as_tensor(res["k_probs"]).reshape(-1, B)
    cls_prog = torch.as_tensor(res["cls_scores"]).reshape(-1, B)
    k_gap = torch.zeros(len(slots), n_ref)
    cls_gap = torch.zeros(len(slots), n_ref)
    bad = torch.zeros(len(slots), B, dtype=torch.bool)
    for i, slot in enumerate(slots):
        b, sb, r = pool[slot], subs[slot], rows[slot].cpu()
        n1, n2 = b["n_nodes"][:, 0], b["n_nodes"][:, 1]
        picks = keeper.picks[i]
        want = torch.round(k_prog[i].to(picks.device)
                           * torch.minimum(n1, n2).float())
        bad[i] = (picks.sum((1, 2)) != want).cpu() \
            | (picks.sum(1) > 1).any(1).cpu() | (picks.sum(2) > 1).any(1).cpu()
        with torch.no_grad(), ref.no_tf32():
            cls_ref = torch.sigmoid(ref.classify(
                weights, cell.config, own[slot]["raw_scores"],
                picks[rows[slot]].float(), sb["n_nodes"][:, 0],
                sb["n_nodes"][:, 1]))
        k_gap[i] = (k_prog[i][r] - own[slot]["k_prob"].cpu()).abs()
        cls_gap[i] = (cls_prog[i][r] - cls_ref.cpu()).abs()
    ds_gap, pick_gap = [], []
    ngm = cell.config["ngm"]
    for slot, kept in enumerate(keeper.sampled):
        if kept is None:
            continue
        out = {k: v[rows[slot]] for k, v in kept.items()}
        sb = subs[slot]
        n1, n2 = sb["n_nodes"][:, 0], sb["n_nodes"][:, 1]
        k = out["k_prob"] * torch.minimum(n1, n2).float()
        with torch.no_grad():
            at_k = ref.soft_topk(own[slot]["sinkhorn"], k, n1, n2,
                                 ngm["sk_tau"], ngm["sk_iter"],
                                 ngm["topk_extra_iter"])
        ds_gap.append(compare.rel_frobenius(out["ds_mat"], at_k))
        pick_gap.append(compare.pick_gaps(out["perm_mat"], at_k, k, n1, n2))
    ds_gap = torch.cat(ds_gap).cpu()
    pick_gap = torch.cat(pick_gap).cpu()
    limits = spec["limits"]
    q = lambda t, p: float(torch.quantile(t.flatten().double(), p))
    numbers = {"k_gap": float(k_gap.max()), "cls_gap": float(cls_gap.max()),
               "ds_gap": float(ds_gap.max()),
               "pick_gap": float(pick_gap.max()),
               "bad_picks": float(bad.sum()),
               "k_gap_median": q(k_gap, 0.5), "k_gap_p99": q(k_gap, 0.99),
               "cls_gap_median": q(cls_gap, 0.5),
               "ds_gap_median": q(ds_gap, 0.5),
               "pick_gap_p99": q(pick_gap, 0.99),
               "reference_pairs": n_ref * len(pool)}
    over = bad.sum(1)
    for name, gap in (("k_gap", k_gap), ("cls_gap", cls_gap)):
        if name in limits:
            over = over + (gap > limits[name]).sum(1)
    return numbers, int(over.sum())
