"""Out-of-the-box pore detection CLI (reference pore_detect_clean.py): run a
trained patch CNN (or the DPF detector) over a dataset tree of `*.jpg`
images and write Coordinates/*.txt under `--out`, ready for the matching
data layer. With `--copy-into`, the files also go beside the images (the
reference's init_dataset.py role), so the matcher's dataset indexer picks
them up.

Same flags as the JAX package's `cli/detect_pores.py`, plus `--device`:
`--method cnn` runs the detector's forward on `--device` (default `cuda`;
`cuda` without a GPU is an error, never a silent CPU run); `--method dpf` is
host numpy / cv2 work in both packages. `--checkpoint` is read in the flat
`.npz` layout of `poredet.train.load_variables` (e.g.
`results/poredet/net17nomax.npz`): the JAX CLI's Flax msgpack files need
flax, which this package does not use, and raise here. Without a checkpoint
the CNN's weights are initialised from seed 0.

Example:
    python -m fpmatch_tpu_torch.cli.detect_pores --images photos/ \
        --method cnn --checkpoint results/poredet/net17nomax.npz --out Pred
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Detect pores in a tree of "
                                             "*.jpg images")
    ap.add_argument("--images", required=True, help="dataset image tree")
    ap.add_argument("--out", default="Prediction", help="output root")
    ap.add_argument("--method", default="dpf", choices=["dpf", "cnn"])
    ap.add_argument("--arch", default="net17nomax")
    ap.add_argument("--checkpoint", default=None,
                    help=".npz file of detector variables (cnn method)")
    ap.add_argument("--probability", type=float, default=0.65)
    ap.add_argument("--nms-iou", type=float, default=0.2)
    ap.add_argument("--copy-into", default=None,
                    help="also write .txt files next to the images "
                         "(init_dataset.py behaviour)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the cnn method (default cuda; pass "
                         "cpu to run on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import cv2

    from ..poredet.dpf import detect_pores_dpf
    from ..poredet.inference import write_coordinates

    image_root = Path(args.images)
    out_root = Path(args.out)

    if args.method == "cnn":
        import torch

        from .. import resolve_device
        from ..poredet.architectures import make_architecture, receptive_field
        from ..poredet.inference import detect_pores_in_image
        from ..poredet.train import load_detector

        window = receptive_field(args.arch)
        if args.checkpoint:
            model = load_detector(args.arch, args.checkpoint,
                                  device=args.device)
        else:
            dev = resolve_device(args.device)
            torch.manual_seed(0)
            model = make_architecture(args.arch).to(dev)

        def detector(img):
            coords, _ = detect_pores_in_image(
                model, img, probability=args.probability, window=window,
                nms_iou=args.nms_iou)
            return coords
    else:
        detector = detect_pores_dpf

    n = 0
    for img_path in sorted(image_root.rglob("*.jpg")):
        img = cv2.imread(str(img_path), cv2.IMREAD_GRAYSCALE)
        coords = detector(img)
        rel = img_path.relative_to(image_root).with_suffix(".txt")
        write_coordinates(str(out_root / rel), coords)
        if args.copy_into:
            dst = Path(args.copy_into) / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(out_root / rel, dst)
        n += 1
    print(f"detected pores in {n} images → {out_root}")
    return n


if __name__ == "__main__":
    main()
