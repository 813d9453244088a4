"""Overfit-one-sample check: trains the full model on a single synthetic
pair until matching accuracy saturates, the quickest check that the whole
gradient path learns. The JAX package's `cli/overfit.py` with the same flags
and printed lines, plus `--device` (default `cuda`; `cuda` without a GPU is
an error, never a silent CPU run).

One genuine pair of `--n-max - 8 .. --n-max - 3` keypoints on 128x160
images, B = 1, from `--seed` (which also seeds the weights); every
partition trains, backbone at a tenth of `--lr`, no warm-up. On a CUDA
device the association matvec runs through K2 forward and backward and its
edge gradient through K6.

Usage:
  python -m fpmatch_tpu_torch.cli.overfit --steps 100
  python -m fpmatch_tpu_torch.cli.overfit --steps 3 --device cpu
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Overfit the matcher on one synthetic pair")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--n-max", type=int, default=32)
    ap.add_argument("--univ", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to run on "
                         "the CPU)")
    return ap


def main(argv=None, on_step=None):
    """Run the steps; returns the final matching accuracy. `on_step(i,
    metrics)` (Python callers only) sees every step's metrics (tensors)."""
    args = build_parser().parse_args(argv)

    from .. import resolve_device
    from ..core.config import Config, ShapeConfig, StageConfig
    from ..data.synthetic import synthetic_pair_batch
    from ..models.ngm import build_model
    from ..train.state import create_state
    from ..train.step import make_train_step

    device = resolve_device(args.device)
    cfg = Config(shapes=ShapeConfig(n_max=args.n_max, e_max=args.n_max * 6,
                                    univ_size=args.univ))
    batch = synthetic_pair_batch(cfg, batch_size=1, seed=args.seed,
                                 n_range=(args.n_max - 8, args.n_max - 2),
                                 image_hw=(128, 160)).to(device)
    model = build_model(cfg, device=device, seed=args.seed)
    stage = StageConfig(name="overfit", lr=args.lr, backbone_lr=args.lr / 10,
                        k_lr=args.lr, cls_lr=args.lr, train_main=True,
                        train_k=True, train_cls=True, warmup_epochs=0)
    state = create_state(model, stage)
    step = make_train_step(model, stage)
    for i in range(args.steps):
        state, metrics = step(state, batch)
        if on_step is not None:
            on_step(i, metrics)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.4f} "
                  f"ks={float(metrics['ks_error']):.3f}")
    acc = float(metrics["accuracy"])
    print(f"final accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
