"""The identity-geometry view of the JAX package's `data/augmentation.py`:
`standardize` (resize to 320x320, centre-crop to 240x320, keypoints kept
consistent). The augmentation transforms belong to training and are not
ported yet. `cv2` is imported inside the function that resizes, so modules
that import this one do not need it.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Annotation = List[List]  # [label, x, y]

STANDARD_SIZE = 320           # resize target before crop
CROP_W, CROP_H = 320, 240     # final geometry (W, H)


def _resize_and_crop(image: np.ndarray, annos: Annotation
                     ) -> Tuple[np.ndarray, Annotation]:
    """Resize to 320x320 then centre-crop to 240x320, dropping keypoints
    that leave the crop."""
    import cv2

    h, w = image.shape[:2]
    resized = cv2.resize(image, (STANDARD_SIZE, STANDARD_SIZE),
                         interpolation=cv2.INTER_LINEAR)
    sx, sy = STANDARD_SIZE / w, STANDARD_SIZE / h
    x0 = (STANDARD_SIZE - CROP_W) // 2
    y0 = (STANDARD_SIZE - CROP_H) // 2
    cropped = resized[y0:y0 + CROP_H, x0:x0 + CROP_W]
    out = []
    for lab, x, y in annos:
        nx, ny = x * sx - x0, y * sy - y0
        if 0 <= nx < CROP_W and 0 <= ny < CROP_H:
            out.append([lab, nx, ny])
    return cropped, out


def standardize(image: np.ndarray, annos: Annotation
                ) -> Tuple[np.ndarray, Annotation]:
    """Identity-geometry view."""
    return _resize_and_crop(image, annos)
