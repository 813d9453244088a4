"""Patch dataset for pore-classifier training.

Parity with pore-detection/entryGiver.py + datasetPores.py: pore coordinates
are rasterized as (optionally soft) discs of radius r into a label map;
WINDOW_SIZE patches are extracted, centered on positives (pore centers) and
random negatives, balanced 1:1.

The port's own copy of the JAX package's module (host numpy / cv2 / scipy code,
the same in both packages).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def rasterize_pores(shape: Tuple[int, int], pores: np.ndarray,
                    radius: int = 2, soft: bool = False) -> np.ndarray:
    """(H, W) label map with discs of `radius` at pore centers
    (entryGiver.py:90-102)."""
    h, w = shape
    label = np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = (xx ** 2 + yy ** 2) <= radius ** 2
    if soft:
        vals = np.exp(-(xx ** 2 + yy ** 2) / max(radius, 1) ** 2) * disc
    else:
        vals = disc.astype(np.float32)
    for x, y in pores:
        cx, cy = int(round(x)), int(round(y))
        y0, y1 = max(cy - radius, 0), min(cy + radius + 1, h)
        x0, x1 = max(cx - radius, 0), min(cx + radius + 1, w)
        vy0, vx0 = y0 - (cy - radius), x0 - (cx - radius)
        patch = vals[vy0:vy0 + (y1 - y0), vx0:vx0 + (x1 - x0)]
        label[y0:y1, x0:x1] = np.maximum(label[y0:y1, x0:x1], patch)
    return label


def extract_balanced_patches(image: np.ndarray, pores: np.ndarray,
                             window: int = 17, radius: int = 2,
                             negatives_per_positive: float = 1.0,
                             rng: np.random.Generator = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced (patches, labels): positives centered on pores, negatives
    sampled off-pore (entryGiver.py:49-80). Returns
    ((N, window, window, 1) float in [0,1], (N,) float labels)."""
    rng = rng or np.random.default_rng(0)
    h, w = image.shape[:2]
    half = window // 2
    label_map = rasterize_pores((h, w), pores, radius=radius)

    patches, labels = [], []
    for x, y in pores:
        cx, cy = int(round(x)), int(round(y))
        if half <= cx < w - half and half <= cy < h - half:
            patches.append(image[cy - half:cy + half + 1,
                                 cx - half:cx + half + 1])
            labels.append(1.0)
    n_pos = len(patches)
    n_neg = int(np.ceil(n_pos * negatives_per_positive))
    tries = 0
    while n_neg > 0 and tries < 50 * max(n_neg, 1):
        cx = int(rng.integers(half, w - half))
        cy = int(rng.integers(half, h - half))
        tries += 1
        if label_map[cy, cx] > 0:
            continue
        patches.append(image[cy - half:cy + half + 1,
                             cx - half:cx + half + 1])
        labels.append(0.0)
        n_neg -= 1
    x = np.stack(patches).astype(np.float32)[..., None] / 255.0
    return x, np.asarray(labels, np.float32)
