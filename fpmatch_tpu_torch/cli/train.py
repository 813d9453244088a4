"""Training CLI: the 6-stage curriculum (`train.loop.run_curriculum`) on one
device, the counterpart of the JAX package's `cli/train.py`.

Same flags, plus `--device` (default `cuda`; `cuda` without a GPU is an
error, never a silent CPU run). On a CUDA device the association matvec of
the three GNN layers runs through the CUDA kernels (K2 / K3) forward and
backward, and its edge / diagonal gradient through `kernels.assoc_grad` (K6);
in the k-only and cls-only stages 2, 4 and 6 no backward reaches them.
`--smoke` generates a tiny synthetic dataset and runs one epoch of stages 1
and 6 (n_max 32, e_max 192, batches of 4), as the JAX CLI's does.

`--bf16` is the JAX CLI's mixed precision (bf16 backbone convolutions and
graph-side hot path, f32 parameters, optimizer state and losses; the
backward of the association matvec on bf16 features runs through K2 / K3
and K6 too). `--hyperedge` trains the third-order triangle term (batches
carry each view's Delaunay triangles) and `--cls-k-features` the
classifier's k statistics. Not ported (raises naming its ROADMAP.md item):
a mesh of more than one device. The JAX CLI's `warn_if_degraded_dispatch`
probes the TPU runtime and has no counterpart here.

Usage:
  python -m fpmatch_tpu_torch.cli.train --data-root dataset/Synthetic \\
      --stages 1,2,3,4,5,6 --epochs 10
  python -m fpmatch_tpu_torch.cli.train --smoke          # on the GPU
  python -m fpmatch_tpu_torch.cli.train --smoke --device cpu --thread-workers
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

import numpy as np


def _waits(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to fpmatch_tpu_torch yet (ROADMAP.md, {item})")


def build_loaders(cfg, data_root: str, dataset_name: str, device, length=None,
                  test_length=None):
    """train: augmented, shuffled; val: deterministic and cached (it is
    re-iterated every epoch); test: a seeded subsample for the periodic
    in-training evaluation. Batches arrive on `device` (prefetched on a
    side stream on a CUDA device)."""
    from ..data.benchmark import make_benchmark
    from ..data.pipeline import DataLoader, PairDataset

    loaders = {}
    for sets in ("train", "val", "test"):
        bench = make_benchmark(dataset_name, sets, root=data_root,
                               task="classify")
        pd = PairDataset(bench, cfg, length=length)
        if sets == "test" and test_length and len(pd.pairs) > test_length:
            keep = np.random.default_rng(0).choice(
                len(pd.pairs), size=test_length, replace=False)
            pd.pairs = [pd.pairs[i] for i in sorted(keep)]
        loaders[sets] = DataLoader(pd, cfg, shuffle=(sets == "train"),
                                   drop_last=True, cache=(sets != "train"),
                                   device=device, device_prefetch=True)
    return loaders


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the NGM matcher")
    ap.add_argument("--data-root", default="dataset/Synthetic")
    ap.add_argument("--dataset", default="Synthetic",
                    choices=["Synthetic", "L3SFV2Augmented", "PolyUDBII",
                             "PolyUDBI", "L3SF"])
    ap.add_argument("--stages", default="1,2,3,4,5,6",
                    help="comma-separated stage numbers to run")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override epochs per stage")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--length", type=int, default=None,
                    help="cap training pairs per epoch")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--log-dir", default=None,
                    help="write per-epoch metrics to <dir>/metrics.jsonl "
                         "(+ TensorBoard event files where available)")
    ap.add_argument("--init-from", default=None,
                    help="dir:name of a checkpoint to warm-start weights "
                         "from (e.g. checkpoints/run1:stage6_last)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--e-max", type=int, default=384)
    ap.add_argument("--univ", type=int, default=600)
    ap.add_argument("--node-taps", default="layer3",
                    help="comma-separated backbone node taps, e.g. "
                         "layer2,layer3 for stride-8+16 features")
    ap.add_argument("--passes", type=int, default=3,
                    help="loader passes per epoch")
    ap.add_argument("--numbered-checkpoints", action="store_true",
                    help="also save a numbered per-epoch snapshot")
    ap.add_argument("--smoke", action="store_true",
                    help="generate a tiny synthetic dataset and run 1 epoch "
                         "of stages 1+6 end-to-end")
    ap.add_argument("--test-length", type=int, default=1024,
                    help="seeded test-pair subsample for the periodic "
                         "in-training eval (full protocol: cli/evaluate.py)")
    ap.add_argument("--thread-workers", action="store_true",
                    help="use thread workers instead of worker processes")
    ap.add_argument("--n-devices", type=int, default=0,
                    help="data-parallel devices (only 0/1 is ported)")
    ap.add_argument("--mesh", default="dp",
                    help="mesh spec (only a one-device 'dp' is ported)")
    ap.add_argument("--cls-k-features", action="store_true",
                    help="feed the k statistics (k, matched fraction, "
                         "mean matched score) to the match classifier")
    ap.add_argument("--hyperedge", action="store_true",
                    help="enable the third-order (triangle hyperedge) "
                         "association term")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute in the backbone and the graph-side "
                         "hot path (params stay f32: f32 checkpoints load "
                         "unchanged)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to run on "
                         "the CPU)")
    return ap


def main(argv=None, on_stage_end=None):
    """Run the curriculum from the flags; returns the final test report.
    `on_stage_end(stage, history)` (Python callers only) is called after
    each stage."""
    args = build_parser().parse_args(argv)

    from .. import resolve_device

    if args.n_devices not in (0, 1) or args.mesh != "dp":
        raise _waits("training on a mesh of more than one device",
                     "Queue A: parallel/")
    device = resolve_device(args.device)    # fail before any work without a GPU

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s", stream=sys.stdout)
    log = logging.getLogger("fpmatch_tpu_torch.cli").info

    from ..core.config import Config, ShapeConfig, default_stages
    from ..models.ngm import build_model
    from ..train.loop import evaluate_verification, run_curriculum
    from . import TAP_CHANNELS

    cfg = Config(shapes=ShapeConfig(n_max=args.n_max, e_max=args.e_max,
                                    univ_size=args.univ))
    taps = tuple(args.node_taps.split(","))
    if taps != ("layer3",):
        feat = sum(TAP_CHANNELS[t] for t in taps) + 512
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, node_taps=taps),
            ngm=dataclasses.replace(cfg.ngm, node_feature_dim=feat))
    if args.cls_k_features:
        cfg = dataclasses.replace(
            cfg, ngm=dataclasses.replace(cfg.ngm, cls_k_features=True))
    if args.hyperedge:
        cfg = dataclasses.replace(
            cfg, ngm=dataclasses.replace(cfg.ngm, hyperedge=True))
    if args.bf16:
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"),
            ngm=dataclasses.replace(cfg.ngm, compute_dtype="bfloat16"))
    if args.batch_size:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          batch_size=args.batch_size))
    # fingerprint scans are grayscale: ship luma only
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, image_channels=1,
            worker_processes=not args.thread_workers))

    if args.smoke:
        import tempfile

        from ..data.generator import generate_synthetic_dataset
        root = tempfile.mkdtemp(prefix="fpm_smoke_") + "/Synthetic"
        generate_synthetic_dataset(root, fingers_per_split=(6, 3, 2),
                                   n_pores=60, seed=0, size=(320, 280))
        args.data_root = root
        if args.checkpoint_dir == "checkpoints":  # default: keep smoke out
            args.checkpoint_dir = root + "-ckpt"
        args.length = 8
        args.epochs = 1
        args.passes = 1
        args.stages = "1,6"
        cfg = dataclasses.replace(
            cfg, shapes=ShapeConfig(n_max=32, e_max=192, t_max=96,
                                    univ_size=64),
            data=dataclasses.replace(cfg.data, batch_size=4, num_workers=2))
        log(f"smoke dataset at {root}")

    stages = []
    for num in (int(s) for s in args.stages.split(",")):
        st = default_stages()[num - 1]
        if args.epochs:
            st = dataclasses.replace(st, num_epochs=args.epochs)
        stages.append(st)

    loaders = build_loaders(cfg, args.data_root, args.dataset, device,
                            length=args.length, test_length=args.test_length)
    log("initializing model…")
    model = build_model(cfg, device=device, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model ready: {n_params / 1e6:.1f}M params on {device}")
    if args.init_from:
        from ..train.checkpoints import restore_params, warm_start
        ckpt_dir, _, name = args.init_from.partition(":")
        sd, kept = warm_start(model.state_dict(),
                              restore_params(ckpt_dir, name or "stage6_last"))
        model.load_state_dict(sd)
        log(f"warm-started from {args.init_from}: {kept}/{len(sd)} tensors "
            f"restored (shape-mismatched tensors keep their fresh init)")

    metrics_logger = None
    if args.log_dir:
        from ..utils.logging import MetricsLogger
        metrics_logger = MetricsLogger(args.log_dir)
        log(f"metrics -> {args.log_dir}/metrics.jsonl")
    try:
        run_curriculum(model, stages, loaders["train"], loaders["val"],
                       test_loader=loaders["test"],
                       checkpoint_dir=args.checkpoint_dir,
                       passes_per_epoch=args.passes, log_fn=log,
                       metrics_logger=metrics_logger,
                       numbered_checkpoints=args.numbered_checkpoints,
                       on_stage_end=on_stage_end)
        report = evaluate_verification(model, stages[-1], loaders["test"])
    finally:
        if metrics_logger is not None:
            metrics_logger.close()
        for loader in loaders.values():
            loader.close()
    log(f"final test report: { {k: round(v, 4) for k, v in report.items()} }")
    return report


if __name__ == "__main__":
    main()
