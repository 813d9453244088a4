"""Merge separate image/annotation trees into one dataset layout.

The JAX package's `cli/combine_dataset.py`, host code with the same flags
and outputs; parity with the reference's dataset/combine.py:1-53 (pairs `R*/xxx.jpg`
images with their `xxx.tsv` ground-truth files under a single root), made
generic: configurable roots, folder list, and annotation extensions.

Usage:
    python -m fpmatch_tpu_torch.cli.combine_dataset \
        --image-root "Pore ground truth/Fingerprint Images" \
        --anno-root  "Pore ground truth/Ground truth" \
        --target dataset/Synthetic
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

IMAGE_GLOBS = ("*.jpg", "*.png", "*.bmp")
ANNO_EXTS = (".tsv", ".csv", ".txt")


def combine_items(image_root: Path, anno_root: Path, target_root: Path,
                  folders) -> int:
    """Copy each folder's images plus matching annotation files into
    target_root/<folder>. Returns the number of image/annotation pairs."""
    n_pairs = 0
    for folder in folders:
        src_img = image_root / folder
        src_ann = anno_root / folder
        dst = target_root / folder
        dst.mkdir(parents=True, exist_ok=True)
        for pattern in IMAGE_GLOBS:
            for img in sorted(src_img.glob(pattern)):
                shutil.copy2(img, dst)
                ann = next((src_ann / (img.stem + e) for e in ANNO_EXTS
                            if (src_ann / (img.stem + e)).exists()), None)
                if ann is None:
                    print(f"warning: no annotation for {img.name}")
                    continue
                shutil.copy2(ann, dst)
                n_pairs += 1
    return n_pairs


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Merge image + annotation trees into a dataset layout")
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--anno-root", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--folders", default=",".join(f"R{i}" for i in range(1, 6)),
                    help="comma-separated subfolders (default R1..R5)")
    args = ap.parse_args(argv)
    n = combine_items(Path(args.image_root), Path(args.anno_root),
                      Path(args.target), args.folders.split(","))
    print(f"combined {n} image/annotation pairs into {args.target}")


if __name__ == "__main__":
    main()
