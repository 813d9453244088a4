"""Match visualization: the part of the JAX package's `utils/visualize.py`
that evaluation calls (`visualize_match` and its helpers; `cv2` is imported
inside the functions that draw). The heatmap and graph drawings are not
ported yet (ROADMAP.md, Queue A: remaining CLIs / utils).
"""
from __future__ import annotations

import numpy as np

NORM_MEANS = np.array([0.485, 0.456, 0.406], np.float32)
NORM_STD = np.array([0.229, 0.224, 0.225], np.float32)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """(H, W, 3|1) normalized float or raw uint8 -> uint8 RGB (loaders ship
    raw uint8, possibly single-channel luma, and normalize on the device)."""
    if img.dtype != np.uint8:
        img = np.clip((img * NORM_STD + NORM_MEANS) * 255.0,
                      0, 255).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


def draw_keypoints(img: np.ndarray, points: np.ndarray, n: int,
                   color=(0, 255, 0)) -> np.ndarray:
    import cv2

    out = img.copy()
    for x, y in points[:n]:
        cv2.circle(out, (int(x), int(y)), 3, color, -1)
    return out


def visualize_match(images: np.ndarray, points: np.ndarray, ns: np.ndarray,
                    perm: np.ndarray, label: float, prob: float,
                    path: str, unknown_label: bool = False) -> None:
    """Side-by-side pair with match lines from the predicted permutation.

    :param images: (2, H, W, 3|1) batch images (normalized float or uint8)
    :param points: (2, N, 2); ns: (2,); perm: (N, N) hard assignment
    """
    import cv2

    img1 = draw_keypoints(denormalize_image(images[0]), points[0], int(ns[0]))
    img2 = draw_keypoints(denormalize_image(images[1]), points[1], int(ns[1]),
                          color=(255, 120, 0))
    canvas = np.concatenate([img1, img2], axis=1)
    off = img1.shape[1]
    rows, cols = np.nonzero(perm[:int(ns[0]), :int(ns[1])])
    for i, j in zip(rows, cols):
        p1 = points[0][i]
        p2 = points[1][j]
        cv2.line(canvas, (int(p1[0]), int(p1[1])),
                 (int(p2[0]) + off, int(p2[1])), (0, 200, 255), 1)
    tag = "score" if unknown_label else \
        ("genuine" if label > 0.5 else "imposter")
    cv2.putText(canvas, f"{tag}  p={prob:.3f}  matches={len(rows)}",
                (8, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    cv2.imwrite(path, cv2.cvtColor(canvas, cv2.COLOR_RGB2BGR))
