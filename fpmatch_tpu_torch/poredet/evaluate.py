"""Pore-detection evaluation: bidirectional nearest-neighbor correspondence.

Parity with pore-detection/validate.py:64-206: a predicted pore is a true
detection iff it is the nearest prediction to some ground-truth pore AND that
ground-truth pore is its nearest ground truth (mutual NN); precision/recall/
F-score over all images.

The port's own copy of the JAX package's module (host numpy / cv2 / scipy code,
the same in both packages).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree


def mutual_nearest_detections(gt: np.ndarray, pred: np.ndarray
                              ) -> Tuple[int, int]:
    """Returns (#true detections, #false detections among matched GT)."""
    if len(gt) == 0 or len(pred) == 0:
        return 0, 0
    pred_tree = cKDTree(pred)
    gt_tree = cKDTree(gt)
    _, gt_to_pred = pred_tree.query(gt)     # nearest prediction per GT
    _, pred_to_gt = gt_tree.query(pred)     # nearest GT per prediction
    true_det = 0
    for g in range(len(gt)):
        p = gt_to_pred[g]
        if pred_to_gt[p] == g:
            true_det += 1
    false_det = len(gt) - true_det
    return true_det, false_det


def detection_scores(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    td, fd = mutual_nearest_detections(gt, pred)
    n_pred = len(pred)
    n_gt = len(gt)
    precision = td / n_pred if n_pred else 0.0
    recall = td / n_gt if n_gt else 0.0
    f = (2 * precision * recall / (precision + recall)
         if precision + recall else 0.0)
    return {"true_detections": td, "false_detections": fd,
            "precision": precision, "recall": recall, "f_score": f,
            "n_pred": n_pred, "n_gt": n_gt}


def aggregate_scores(per_image: Sequence[Dict[str, float]]) -> Dict[str, float]:
    td = sum(s["true_detections"] for s in per_image)
    n_pred = sum(s["n_pred"] for s in per_image)
    n_gt = sum(s["n_gt"] for s in per_image)
    precision = td / n_pred if n_pred else 0.0
    recall = td / n_gt if n_gt else 0.0
    f = (2 * precision * recall / (precision + recall)
         if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f_score": f,
            "n_images": len(per_image)}
