"""Keypoint matching recall, precision and F1 on GENUINE pairs: the
correspondence-quality counterpart of the verification report (the
reference's matching_accuracy, evaluation_metric.py:58-200, is recall).

The in-training `accuracy` metric averages matching recall over genuine AND
impostor pairs (impostors have no ground-truth matches and add 0), so it
understates correspondence quality by about the impostor share; this
report counts the genuine pairs only.

    python -m fpmatch_tpu_torch.scripts.matching_recall_report \\
        --data-root dataset/SyntheticV2 --checkpoint-dir checkpoints/run4 \\
        --node-taps layer2,layer3 [--sets test] [--device cuda]

The JAX script's flags, plus `--device` (default `cuda`; `cuda` without a
GPU is an error) and `--thread-workers`. The model is `Config()` at full
width (n_max 64: K2 runs on a CUDA device) with the named node taps,
grayscale shipping, weights from the port's checkpoint format
(`train.checkpoints`, `.npz` of the JAX package's too), and the last
curriculum stage's eval step. Prints one JSON line: the means over genuine
pairs, the F1 of the two means, the recall weighted by each pair's number
of ground-truth matches, and each genuine pair's recall and precision.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", default="dataset/SyntheticV2")
    ap.add_argument("--dataset", default="Synthetic")
    ap.add_argument("--sets", default="test")
    ap.add_argument("--checkpoint-dir", default="checkpoints/run4")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint name (default: latest from meta)")
    ap.add_argument("--node-taps", default="layer2,layer3")
    ap.add_argument("--limit", type=int, default=None,
                    help="cap evaluated batches")
    ap.add_argument("--hyperedge", action="store_true")
    ap.add_argument("--thread-workers", action="store_true",
                    help="use thread workers instead of worker processes")
    ap.add_argument("--device", default="cuda")
    return ap


def model_config(args):
    """`Config()` (the serving CLIs' shapes and grayscale shipping) with
    the named node taps and options, worker processes unless
    `--thread-workers`."""
    from ..cli import model_config_from_args
    from ..core.config import ShapeConfig

    sh = ShapeConfig()
    cfg = model_config_from_args(argparse.Namespace(
        n_max=sh.n_max, e_max=sh.e_max, univ=sh.univ_size,
        node_taps=args.node_taps, hyperedge=args.hyperedge))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, worker_processes=not args.thread_workers))


def run(args) -> Dict:
    import torch

    from .. import resolve_device
    from ..core.config import default_stages
    from ..data.benchmark import make_benchmark
    from ..data.pipeline import DataLoader, PairDataset
    from ..evaluation.metrics import matching_precision, matching_recall
    from ..models import ngm
    from ..train.checkpoints import read_meta, restore_params
    from ..train.step import make_eval_step

    device = resolve_device(args.device)
    cfg = model_config(args)
    bench = make_benchmark(args.dataset, args.sets, root=args.data_root,
                           task="classify")
    loader = DataLoader(PairDataset(bench, cfg), cfg, drop_last=False,
                        device=device, device_prefetch=True)
    name = args.checkpoint or read_meta(args.checkpoint_dir).get("latest")
    model = ngm.build_model(cfg, device=device, state_dict=restore_params(
        args.checkpoint_dir, name, cfg))
    eval_step = make_eval_step(model, default_stages()[-1])

    rec, prec, weights = [], [], []
    try:
        for bi, batch in enumerate(loader):
            if args.limit and bi >= args.limit:
                break
            _, out = eval_step(batch)
            n1, n2 = batch.n_nodes[:, 0], batch.n_nodes[:, 1]
            genuine = (batch.label > 0.5).cpu().numpy()
            host = lambda t: t.float().cpu().numpy()[genuine]  # noqa: E731
            rec += host(matching_recall(out["perm_mat"], batch.gt_perm, n1,
                                        n2)).tolist()
            prec += host(matching_precision(out["perm_mat"], batch.gt_perm,
                                            n1, n2)).tolist()
            weights += host(batch.gt_perm.sum((1, 2))).tolist()
    finally:
        loader.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    r, p, w = np.asarray(rec), np.asarray(prec), np.asarray(weights)
    if not len(r):
        raise SystemExit("no genuine pair was evaluated")
    return {
        "sets": args.sets, "device": device.type,
        "checkpoint": f"{args.checkpoint_dir}:{name}",
        "n_genuine_pairs": len(r),
        "matching_recall": float(r.mean()),
        "matching_precision": float(p.mean()),
        "matching_f1": float(2 * r.mean() * p.mean()
                             / max(r.mean() + p.mean(), 1e-8)),
        "matching_recall_gt_weighted": float((r * w).sum()
                                             / max(w.sum(), 1.0)),
        "per_pair": {"recall": r.tolist(), "precision": p.tolist()}}


def main(argv=None) -> Dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
