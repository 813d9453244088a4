"""Full-image pore inference: fully-convolutional sweep + NMS -> coordinates.

The counterpart of the JAX package's `poredet/inference.py` (reference
entireImage.py:13-156, pore_detect_clean.py:16-111): the valid-padded patch
CNN applied to a whole image gives a shrunken probability map; cells at or
above `probability` become fixed-size boxes that greedy IoU-NMS prunes; the
surviving boxes' corners, offset by the window's half size to undo the
valid-conv shrink, are the pore coordinates.

The forward runs on the model's device (one call per image); the map comes
back to the host, where the candidates are taken in `np.nonzero` row-major
order and pruned by the native `nms_fixed_boxes` (host C++, as in the JAX
package). `nms_boxes` is the plain numpy NMS the native one is held against
(and the one the Lemes DPF detector uses).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch


def nms_boxes(coords: np.ndarray, scores: np.ndarray, box_size: int,
              iou_threshold: float) -> np.ndarray:
    """Greedy NMS over equal-size square boxes anchored at `coords` (y, x).
    Returns indices of kept boxes (torchvision.ops.nms equivalent)."""
    if len(coords) == 0:
        return np.zeros((0,), np.int64)
    order = np.argsort(-scores, kind="stable")
    y = coords[:, 0].astype(np.float64)
    x = coords[:, 1].astype(np.float64)
    keep = []
    suppressed = np.zeros(len(coords), bool)
    area = float(box_size) * box_size
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        iy = np.maximum(0.0, box_size - np.abs(y - y[i]))
        ix = np.maximum(0.0, box_size - np.abs(x - x[i]))
        inter = iy * ix
        iou = inter / (2 * area - inter)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def probability_map(model, image: np.ndarray) -> np.ndarray:
    """One forward of the whole (H, W) uint8 image, `(1, 1, H, W) / 255` in
    float32 on the model's device; the (H', W') map on the host."""
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.asarray(image, np.float32))[None, None].to(dev)
    with torch.inference_mode():
        pred = model(x / 255.0)
    return pred[0, 0].cpu().numpy()


def candidates(pmap: np.ndarray, probability: float):
    """Cells at or above `probability`, row-major: ((m, 2) int32 (y, x),
    (m,) float32 scores)."""
    ys, xs = np.nonzero(pmap >= probability)
    return (np.stack([ys, xs], axis=1).astype(np.int32),
            pmap[ys, xs].astype(np.float32))


def detect_pores_in_image(model, image: np.ndarray, *,
                          probability: float = 0.65, window: int = 17,
                          nms_iou: float = 0.2,
                          box_size: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the detector over a full grayscale image.

    :param model: a `poredet.architectures` model (eval mode, on its device)
    :param image: (H, W) uint8
    :return: (pore xy coordinates in image space (n, 2) float32,
        probability map)
    """
    from .. import native

    pmap = probability_map(model, image)
    coords, scores = candidates(pmap, probability)
    keep = native.nms_fixed_boxes(coords, scores, box_size or window,
                                  nms_iou)
    half = window // 2
    # map cell (y, x) + half = pore centre in input-image space
    out = np.stack([coords[keep, 1] + half, coords[keep, 0] + half],
                   axis=1).astype(np.float32)
    return out, pmap


def write_coordinates(path: str, coords: np.ndarray) -> None:
    """Coordinates/*.txt output format (x,y per line — the matcher's .txt
    keypoint reader consumes this directly)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for x, y in coords:
            f.write(f"{float(x):.1f},{float(y):.1f}\n")


def detect_dataset(model, image_dir: str, out_dir: str, **kw) -> int:
    """pore_detect_clean.py equivalent: sweep a directory tree of `*.jpg`,
    write Coordinates/*.txt under `out_dir`. Returns the number of images."""
    import cv2

    image_dir = Path(image_dir)
    out_dir = Path(out_dir)
    n = 0
    for img_path in sorted(image_dir.rglob("*.jpg")):
        img = cv2.imread(str(img_path), cv2.IMREAD_GRAYSCALE)
        coords, _ = detect_pores_in_image(model, img, **kw)
        rel = img_path.relative_to(image_dir).with_suffix(".txt")
        write_coordinates(str(out_dir / rel), coords)
        n += 1
    return n
