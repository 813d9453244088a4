"""Tiled augmentation preview with keypoint overlay (the JAX package's
`cli/preview_augmentations.py`, host code with the same flags and output;
parity with the reference's preview_augmentations.py + tests/*_demo.py
visual demos): one tile per transform of `data.augmentation.TRANSFORMS`.

    python -m fpmatch_tpu_torch.cli.preview_augmentations [--image IMG]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None,
                    help="fingerprint image (default: synthesize one)")
    ap.add_argument("--out", default="results/augmentation_preview.png")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import cv2

    from ..data.augmentation import TRANSFORMS, apply_single_transform
    from ..data.dataset import find_annotation_file, read_keypoints
    from ..data.generator import render_fingerprint

    rng = np.random.default_rng(args.seed)
    if args.image:
        from pathlib import Path
        img = cv2.imread(args.image)
        anno_file = find_annotation_file(Path(args.image))
        kpts = read_keypoints(anno_file, "p") if anno_file else []
        annos = [[k["labels"], k["x"], k["y"]] for k in kpts]
    else:
        gray, pores = render_fingerprint(args.seed, size=(320, 280),
                                         n_pores=80)
        img = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
        annos = [[f"p{i}", float(x), float(y)]
                 for i, (x, y) in enumerate(pores)]

    tiles = []
    names = list(TRANSFORMS)
    for name in names:
        timg, tann = apply_single_transform(img, annos, name, rng)
        vis = timg.copy()
        for _, x, y in tann:
            cv2.circle(vis, (int(x), int(y)), 2, (0, 255, 0), -1)
        cv2.putText(vis, f"{name} ({len(tann)} kpts)", (6, 16),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 0, 255), 1)
        tiles.append(vis)

    cols = 4
    rows = int(np.ceil(len(tiles) / cols))
    h, w = tiles[0].shape[:2]
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = t
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cv2.imwrite(args.out, canvas)
    print(f"wrote {args.out} ({len(tiles)} transforms)")


if __name__ == "__main__":
    main()
