"""Train a pore detector end to end on synthetic impressions and write the
artifact set: the trained weights (`<out>/<arch>.npz`, the JAX package's
flat layout), `metrics.csv` (the validation grid search and the TEST I / II
final phases) and the CNN-against-DPF rows.

    python -m fpmatch_tpu_torch.scripts.train_poredet --arch net17nomax \
        [--out results/poredet_torch] [--device cpu]

The counterpart of the JAX package's `scripts/train_poredet.py` (reference
flow pore-detection/train.py: patch BCE -> full-image validation ->
threshold grid search -> TEST I / II), with the same flags and images
(`data.generator.render_impression` of fingers 9000.., 9500.., 9800..,
240 x 200, 70 pores, true pores only) plus `--device` (default `cuda`).
`--out` defaults to `results/poredet_torch`, beside the repo's trained
`results/poredet/net17nomax.npz`, which no run overwrites. The `.npz` loads
in `poredet.train.load_detector` here and in the JAX package's
`load_variables`.
"""
from __future__ import annotations

import argparse
import csv
import json
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="net13")
    ap.add_argument("--out", default="results/poredet_torch")
    ap.add_argument("--train-n", type=int, default=12)
    ap.add_argument("--val-n", type=int, default=4)
    ap.add_argument("--test-n", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    return ap


def render_set(seed0: int, n: int):
    """`n` impressions (fingers seed0.., impression 1001) and their true
    pores."""
    from ..data.generator import render_impression

    imgs, gts = [], []
    for i in range(n):
        img, pores, ids = render_impression(seed0 + i, 1001,
                                            out_size=(240, 200), n_pores=70)
        imgs.append(img)
        gts.append(pores[ids >= 0])        # true pores only (no spurious)
    return imgs, gts


def main(argv=None, log_fn=print) -> dict:
    """Run the flow; returns {"train": the per-epoch curve and the kept
    epoch, "grid", "phases", "rows" (metrics.csv's), "npz"}."""
    import numpy as np

    from ..poredet.architectures import receptive_field
    from ..poredet.dpf import detect_pores_dpf as dpf_compact
    from ..poredet.dpf import detect_pores_lemes
    from ..poredet.evaluate import aggregate_scores, detection_scores
    from ..poredet.train import (final_test_phases, grid_search_thresholds,
                                 save_variables, train_pore_detector)

    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    tr_imgs, tr_gts = render_set(9000, args.train_n)
    va_imgs, va_gts = render_set(9500, args.val_n)
    te_imgs, te_gts = render_set(9800, args.test_n)

    best = train_pore_detector(args.arch, tr_imgs, tr_gts, va_imgs, va_gts,
                               epochs=args.epochs, device=args.device,
                               log_fn=log_fn)
    model, window = best["model"], receptive_field(args.arch)
    grid = grid_search_thresholds(model, va_imgs, va_gts, window=window,
                                  log_fn=log_fn)
    log_fn(f"grid best: {grid}")
    phases = final_test_phases(
        model, {"TEST_I": (va_imgs, va_gts), "TEST_II": (te_imgs, te_gts)},
        window=window, probability=grid["probability"],
        nms_iou=grid["nms_iou"], log_fn=log_fn)
    npz = os.path.join(args.out, f"{args.arch}.npz")
    save_variables(npz, best["variables"])

    # classical baselines on the same test images
    rows = []
    for name, fn in (("dpf_compact", dpf_compact),
                     ("dpf_lemes", detect_pores_lemes)):
        per = [detection_scores(gt, np.asarray(fn(img), np.float32))
               for img, gt in zip(te_imgs, te_gts)]
        rows.append({"detector": name, **aggregate_scores(per)})
    for phase, rep in phases.items():
        rows.append({"detector": f"{args.arch}:{phase}", **rep})
    rows.append({"detector": f"{args.arch}:val_grid", **grid})

    cols = sorted({k for r in rows for k in r})
    with open(os.path.join(args.out, "metrics.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    log_fn(json.dumps(rows, default=float, indent=1))
    train = {k: best[k] for k in ("n_patches", "losses", "val_f", "step_ms",
                                  "epoch", "f_score")}
    return {"train": train, "grid": grid, "phases": phases, "rows": rows,
            "npz": npz, "model": model}


if __name__ == "__main__":
    main()
