"""Verification evaluation CLI: batched test pairs -> EER / ROC artifacts.

Loads a checkpoint (or initialises weights from `--seed`), runs the test
split's genuine / imposter pairs through the model in batches, computes the
EER-threshold metric suite and writes `eval.log`, `scores.csv`,
`metrics.csv`, `sibling_metrics.csv` (when the dataset has sibling fingers),
ROC / PR / k-histogram plots and a few match visualizations (the drawings
need matplotlib and are skipped with a warning where it is missing). Same
flags and artifacts as the JAX package's `cli/evaluate.py`, plus `--device`
(default `cuda`; `cuda` without a GPU is an error, never a silent CPU run)
and `--seed`. On a CUDA device the three association-GNN aggregations of
every batch run through the CUDA kernels of `kernels/assoc_bucket`.
`--discretize hungarian` adds, per batch, the host LAPJV solve of the first
forward's `ds_mat` (`ops.hungarian`) and a second forward through
`train.step.make_eval_step_masked`; the scores are the second forward's.
`--hyperedge` (the batches carry triangles, each GNN layer adds the
third-order term) and `--cls-k-features` must match the checkpoint;
`--augment` augments the test pairs as the train split is augmented
(seeded per pair).

The work is split so that a script can enter below the files:
`evaluate_loader` takes a model and a loader and returns labels, scores and
the report; `main` builds both from the flags and writes the artifacts.

Left out: the JAX CLI's `warn_if_degraded_dispatch` is a probe of the TPU
runtime's dispatch latency and has no counterpart here.

Example:
    python -m fpmatch_tpu_torch.cli.evaluate --data-root dataset/Synthetic \
        --checkpoint-dir checkpoints --batch-size 8
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import itertools
import logging
import os
import sys
import time

import numpy as np

METRIC_COLUMNS = ["accuracy", "precision", "recall", "f1", "roc_auc",
                  "pr_auc", "far", "frr", "eer", "threshold"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Evaluate verification EER/ROC")
    ap.add_argument("--data-root", default="dataset/Synthetic")
    ap.add_argument("--dataset", default="Synthetic",
                    choices=["Synthetic", "L3SFV2Augmented", "PolyUDBII",
                             "PolyUDBI", "L3SF"])
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint name (default: latest from meta)")
    ap.add_argument("--output-dir", default="results/binary-classifier")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--e-max", type=int, default=384)
    ap.add_argument("--univ", type=int, default=600)
    ap.add_argument("--num-viz", type=int, default=4)
    ap.add_argument("--limit", type=int, default=None,
                    help="seeded random subsample of this many test pairs "
                         "(A/B studies; full protocol when omitted)")
    ap.add_argument("--augment", action="store_true",
                    help="augment test pairs")
    ap.add_argument("--score", default="fused",
                    choices=["fused", "cls", "k"],
                    help="verification score: 'fused' = cls_prob * k_prob "
                         "(the AFA-U matchable fraction is the pore-level "
                         "signal), 'cls' = classifier probability, 'k' = "
                         "k_prob alone")
    ap.add_argument("--discretize", default="greedy",
                    choices=["greedy", "hungarian"],
                    help="match discretization: 'greedy' ranks the greedy "
                         "fill by the soft-top-k map directly (device-only, "
                         "the default); 'hungarian' reproduces the "
                         "reference's full discretization (host LAPJV "
                         "between two forwards per batch)")
    ap.add_argument("--thread-workers", action="store_true",
                    help="thread loader workers instead of spawn processes")
    ap.add_argument("--node-taps", default="layer3",
                    help="backbone node-feature taps, must match the "
                         "checkpoint (e.g. 'layer2,layer3')")
    ap.add_argument("--hyperedge", action="store_true",
                    help="enable the third-order (triangle hyperedge) "
                         "association term (must match training)")
    ap.add_argument("--cls-k-features", action="store_true",
                    help="checkpoint was trained with k-statistic features "
                         "in the match classifier")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute in the backbone and the graph-side "
                         "hot path (params stay f32: f32 checkpoints load "
                         "unchanged)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to run on "
                         "the CPU)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weight init used without a checkpoint")
    return ap


def evaluate_loader(model, loader, *, score: str = "fused", log=None,
                    on_batch=None, discretize: str = "greedy") -> dict:
    """Run every batch of `loader` through `model` and score the pairs.

    :param model: an NGMNet; batches are moved to its device if the loader
        yields host batches
    :param loader: yields PairBatches in pair order (sequential, last batch
        may be short)
    :param on_batch: optional `on_batch(index, batch, outputs)`, called with
        the device batch and the eval step's outputs (the masked step's with
        "hungarian")
    :param discretize: "greedy", or "hungarian": per batch the host LAPJV on
        the first forward's `ds_mat`, then the masked second forward, whose
        scores and metrics are kept
    :return: dict with `labels`, `scores`, `cls_scores`, `k_probs` (numpy,
        one entry per pair), `report` (verification_metrics of the chosen
        score), `metrics` (mean of the step metrics over batches) and
        `batch_seconds` (per batch, on the monotonic host clock
        `time.perf_counter`, ending in the device-to-host copy of its
        scores)
    """
    import torch

    from ..core.config import default_stages
    from ..evaluation.metrics import verification_metrics
    from ..ops.hungarian import hungarian
    from ..train.step import make_eval_step, make_eval_step_masked
    from ..utils.profiling import span

    if discretize not in ("greedy", "hungarian"):
        raise ValueError(f"discretize must be greedy or hungarian, not "
                         f"{discretize!r}")
    log = log or (lambda msg: None)
    dev = next(model.parameters()).device
    stage = default_stages()[-1]
    eval_step = make_eval_step(model, stage)
    masked_step = (make_eval_step_masked(model, stage)
                   if discretize == "hungarian" else None)
    labels, cls_scores, k_probs, batch_seconds = [], [], [], []
    sums: dict = {}
    n_batches = len(loader)
    batches = iter(loader)
    t0 = t_prev = time.perf_counter()
    for bi in itertools.count():
        # one span a phase of the batch, each with the batch index
        arg = str(bi)
        with span("evaluate.load", arg):
            batch = next(batches, None)
            if batch is not None and (
                    not isinstance(batch.images, torch.Tensor)
                    or batch.images.device != dev):
                batch = batch.to(dev)
        if batch is None:
            break
        if bi % 50 == 0 and bi:
            rate = bi / (time.perf_counter() - t0)
            log(f"batch {bi}/{n_batches} ({rate:.2f} batches/s, "
                f"eta {(n_batches - bi) / max(rate, 1e-9):.0f}s)")
        with span("evaluate.step", arg):
            metrics, out = eval_step(batch)
        if masked_step is not None:
            with span("evaluate.hungarian", arg):
                mask = hungarian(out["ds_mat"], batch.n_nodes[:, 0],
                                 batch.n_nodes[:, 1])
                metrics, out = masked_step(batch, mask)
        if on_batch is not None:
            with span("evaluate.on_batch", arg):
                on_batch(bi, batch, out)
        with span("evaluate.fetch", arg):
            labels.append(batch.label.cpu().numpy())
            cls_scores.append(out["cls_prob"].float().cpu().numpy())
            k_probs.append(out["k_prob"].float().cpu().numpy())
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        now = time.perf_counter()
        batch_seconds.append(now - t_prev)
        t_prev = now
    if not labels:
        raise ValueError("the loader yielded no batch")
    with span("evaluate.report"):
        labels = np.concatenate(labels)
        cls_scores = np.concatenate(cls_scores)
        k_probs = np.concatenate(k_probs)
        scores = {"fused": cls_scores * k_probs, "cls": cls_scores,
                  "k": k_probs}[score]
        report = verification_metrics(labels, scores)
    return {"labels": labels, "scores": scores, "cls_scores": cls_scores,
            "k_probs": k_probs, "report": report,
            "metrics": {k: v / len(batch_seconds) for k, v in sums.items()},
            "batch_seconds": batch_seconds}


def load_model(cfg, args, log):
    """The model on `args.device`: checkpoint weights when one is named or
    recorded as latest, else weights initialised from `--seed`."""
    from ..models.ngm import build_model
    from ..train.checkpoints import read_meta, restore_params

    ckpt_name = args.checkpoint or read_meta(args.checkpoint_dir).get(
        "latest")
    state_dict = None
    if ckpt_name:
        state_dict = restore_params(args.checkpoint_dir, ckpt_name, cfg)
        log(f"restored checkpoint {ckpt_name}")
    else:
        log("WARNING: no checkpoint found — evaluating random weights")
    return build_model(cfg, device=args.device, seed=args.seed,
                       state_dict=state_dict)


def have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .. import resolve_device

    device = resolve_device(args.device)    # fail before any work without a GPU

    os.makedirs(args.output_dir, exist_ok=True)
    logger = logging.getLogger("fpmatch_tpu_torch.eval")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handlers = [logging.StreamHandler(sys.stdout),
                logging.FileHandler(os.path.join(args.output_dir, "eval.log"),
                                    mode="w")]
    for h in handlers:
        h.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(h)
    try:
        return _run(args, device, logger.info)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()


def _run(args, device, log):
    from . import model_config_from_args
    from ..data.benchmark import make_benchmark
    from ..data.pipeline import DataLoader, PairDataset

    cfg = model_config_from_args(args)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, batch_size=args.batch_size,
            worker_processes=not args.thread_workers))

    bench = make_benchmark(args.dataset, "test", root=args.data_root,
                           task="classify")
    pd = PairDataset(bench, cfg, augment=args.augment)
    if args.limit and len(pd.pairs) > args.limit:
        keep = np.random.default_rng(0).choice(
            len(pd.pairs), size=args.limit, replace=False)
        pd.pairs = [pd.pairs[i] for i in sorted(keep)]
        log(f"seeded subsample: {args.limit} of the full protocol")
    loader = DataLoader(pd, cfg, drop_last=False, device=device,
                        device_prefetch=True)
    pair_ids = list(pd.pairs)
    log(f"test pairs: {len(pd)}")

    log("initializing model…")
    model = load_model(cfg, args, log)

    draw = have_matplotlib()
    if not draw:
        log("WARNING: matplotlib is not installed — match drawings and the "
            "ROC / PR / k-histogram plots are skipped")
    viz = {"saved": 0}

    def on_batch(bi, batch, out):
        if draw and viz["saved"] < args.num_viz:
            viz["saved"] += save_match_viz(batch, out, args.output_dir,
                                           viz["saved"], args.num_viz)

    try:
        if args.discretize == "hungarian":
            log("discretize=hungarian: host LAPJV between two forwards "
                "(second forward per batch)")
        res = evaluate_loader(model, loader, score=args.score, log=log,
                              on_batch=on_batch, discretize=args.discretize)
    finally:
        loader.close()
    labels, scores = res["labels"], res["scores"]
    cls_scores, k_probs, report = (res["cls_scores"], res["k_probs"],
                                   res["report"])
    log(f"verification score: {args.score}")

    # per-pair scores. The loader is sequential (shuffle=False); indices wrap
    # modulo the dataset length, which aligns ids with scores.
    scores_path = os.path.join(args.output_dir, "scores.csv")
    with open(scores_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id_a", "id_b", "label", "score", "cls_prob", "k_prob"])
        for i in range(len(scores)):
            a, b = pair_ids[i % len(pair_ids)]
            w.writerow([a, b, int(labels[i]), f"{scores[i]:.6f}",
                        f"{cls_scores[i]:.6f}", f"{k_probs[i]:.6f}"])
    log(f"wrote {scores_path}")
    log(f"report: { {k: round(v, 5) for k, v in report.items()} }")

    csv_path = os.path.join(args.output_dir, "metrics.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(METRIC_COLUMNS)
        w.writerow([report[c] for c in METRIC_COLUMNS])
    log(f"wrote {csv_path}")

    sibling_report(bench, pair_ids, labels, scores, report, args.output_dir,
                   log)
    if draw:
        plot_curves(labels, scores, k_probs, args.output_dir)
    return report


def sibling_report(bench, pair_ids, labels, scores, report, output_dir, log):
    """Sibling hard-impostor subset (when the dataset has a siblings.json
    sidecar): EER restricted to sibling<->partner impostors + all genuine,
    and the sibling FAR at the full-set EER threshold."""
    from ..evaluation.metrics import verification_metrics

    partners = bench._sibling_partners()
    if not partners:
        return None
    pset = {frozenset(it) for it in partners.items()}
    person = {k: v["cls"] for k, v in bench.data_dict.items()}
    sib_mask = np.array(
        [labels[i] == 0 and frozenset(
            (person[pair_ids[i % len(pair_ids)][0]],
             person[pair_ids[i % len(pair_ids)][1]])) in pset
         for i in range(len(scores))])
    if not sib_mask.any():
        return None
    sel = (labels == 1) | sib_mask
    sib = verification_metrics(labels[sel], scores[sel])
    sib["sibling_far_at_full_threshold"] = float(
        (scores[sib_mask] >= report["threshold"]).mean())
    sib["n_sibling_impostors"] = int(sib_mask.sum())
    log(f"sibling subset: { {k: round(v, 5) for k, v in sib.items()} }")
    with open(os.path.join(output_dir, "sibling_metrics.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(sorted(sib))
        w.writerow([sib[c] for c in sorted(sib)])
    return sib


def plot_curves(labels, scores, k_probs, output_dir):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..evaluation.metrics import pr_curve, roc_curve

    fpr, tpr, _ = roc_curve(labels, scores)
    plt.figure(figsize=(5, 5))
    plt.plot(fpr, tpr)
    plt.plot([0, 1], [0, 1], "--", alpha=0.4)
    plt.xlabel("FPR")
    plt.ylabel("TPR")
    plt.title("ROC")
    plt.savefig(os.path.join(output_dir, "roc_curve.png"), dpi=120)
    plt.close()

    p, r = pr_curve(labels, scores)
    plt.figure(figsize=(5, 5))
    plt.plot(r, p)
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.title("PR")
    plt.savefig(os.path.join(output_dir, "pr_curve.png"), dpi=120)
    plt.close()

    plt.figure(figsize=(6, 4))
    for val, name in ((1.0, "genuine"), (0.0, "imposter")):
        sel = labels == val
        if sel.any():
            plt.hist(k_probs[sel], bins=20, alpha=0.6, label=name)
    plt.xlabel("predicted k fraction")
    plt.legend()
    plt.savefig(os.path.join(output_dir, "k_histogram.png"), dpi=120)
    plt.close()


def save_match_viz(batch, out, output_dir, start_idx, max_viz) -> int:
    """Render keypoint match lines for a few pairs of a padded batch."""
    from ..utils.visualize import visualize_match

    host = lambda a: a.cpu().numpy()
    saved = 0
    B = int(batch.label.shape[0])
    for b in range(min(B, max_viz - start_idx)):
        path = os.path.join(output_dir,
                            f"match_{start_idx + saved:02d}.png")
        visualize_match(
            host(batch.images[b]), host(batch.points[b]),
            host(batch.n_nodes[b]), host(out["perm_mat"][b]),
            float(batch.label[b]), float(out["cls_prob"][b]), path)
        saved += 1
    return saved


if __name__ == "__main__":
    main()
