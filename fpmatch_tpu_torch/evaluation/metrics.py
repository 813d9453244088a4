"""Matching + verification metrics: the counterpart of the JAX package's
`evaluation/metrics.py`.

Matching metrics take padded (B, S1, S2) tensors + per-sample valid counts;
verification metrics (ROC/EER/FAR/FRR) are host-side numpy over collected
scores, copied as they are.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.masking import rect_mask


def _masked_sum(x, ns1, ns2):
    m = rect_mask(ns1, ns2, x.shape[1], x.shape[2])
    return torch.sum(torch.where(m, x, 0.0), dim=(1, 2))


def matching_recall(pred_perm, gt_perm, ns1, ns2):
    """TP / #GT-matches per sample."""
    tp = _masked_sum(pred_perm * gt_perm, ns1, ns2)
    gt = _masked_sum(gt_perm, ns1, ns2)
    return tp / torch.clamp(gt, min=1.0)


def matching_precision(pred_perm, gt_perm, ns1, ns2):
    """TP / #predicted-matches per sample."""
    tp = _masked_sum(pred_perm * gt_perm, ns1, ns2)
    pred = _masked_sum(pred_perm, ns1, ns2)
    return tp / torch.clamp(pred, min=1.0)


def matching_accuracy(pred_perm, gt_perm, ns1, ns2):
    return matching_recall(pred_perm, gt_perm, ns1, ns2)


def matching_f1(pred_perm, gt_perm, ns1, ns2):
    r = matching_recall(pred_perm, gt_perm, ns1, ns2)
    p = matching_precision(pred_perm, gt_perm, ns1, ns2)
    return 2 * r * p / torch.clamp(r + p, min=1e-8)


def objective_score(pred_perm, aff_fn):
    """x'Kx matching objective; `aff_fn` applies the factorized K to a
    vectorized assignment."""
    v = pred_perm[..., None]
    return torch.sum(pred_perm * aff_fn(v)[..., 0], dim=(-1, -2))


def pck(pred_points, gt_points, ns, dist_threshs):
    """Percentage of correct keypoints at distance thresholds."""
    n = pred_points.shape[1]
    mask = torch.arange(n, device=ns.device)[None, :] < ns[:, None]
    d = torch.linalg.norm(pred_points - gt_points, dim=-1)
    total = torch.clamp(torch.sum(ns), min=1)
    return torch.stack([
        torch.sum(torch.where(mask, (d <= t).float(), 0.0)) / total
        for t in dist_threshs])


# ------------------------------------------------------------------ host side

def roc_curve(labels: np.ndarray, scores: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC from genuine(1)/imposter(0) scores. Returns (fpr, tpr, thresh)."""
    order = np.argsort(-scores, kind="stable")
    labels = np.asarray(labels)[order].astype(np.float64)
    scores = np.asarray(scores)[order].astype(np.float64)
    tps = np.cumsum(labels)
    fps = np.cumsum(1.0 - labels)
    P = max(labels.sum(), 1e-12)
    Nn = max((1.0 - labels).sum(), 1e-12)
    # keep last index of each distinct threshold
    distinct = np.r_[np.nonzero(np.diff(scores))[0], len(scores) - 1]
    tpr = np.r_[0.0, tps[distinct] / P]
    fpr = np.r_[0.0, fps[distinct] / Nn]
    thresh = np.r_[np.inf, scores[distinct]]
    return fpr, tpr, thresh


def auc(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.trapezoid(y, x))


def eer(labels: np.ndarray, scores: np.ndarray
        ) -> Tuple[float, float]:
    """Equal error rate and its threshold (FNR == FPR crossing)."""
    fpr, tpr, thresh = roc_curve(labels, scores)
    fnr = 1.0 - tpr
    i = int(np.nanargmin(np.abs(fnr - fpr)))
    return float((fpr[i] + fnr[i]) / 2.0), float(thresh[i])


def pr_curve(labels: np.ndarray, scores: np.ndarray):
    order = np.argsort(-scores, kind="stable")
    labels = np.asarray(labels)[order].astype(np.float64)
    tps = np.cumsum(labels)
    fps = np.cumsum(1.0 - labels)
    precision = tps / np.maximum(tps + fps, 1e-12)
    recall = tps / max(labels.sum(), 1e-12)
    return np.r_[1.0, precision], np.r_[0.0, recall]


def pr_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    p, r = pr_curve(labels, scores)
    return float(np.sum(np.diff(r) * p[1:]))


def verification_metrics(labels: np.ndarray, scores: np.ndarray
                         ) -> Dict[str, float]:
    """The full binary-classifier report at the EER threshold:
    accuracy/precision/recall/F1, ROC-AUC, PR-AUC, FAR, FRR."""
    labels = np.asarray(labels).astype(np.float64)
    scores = np.asarray(scores).astype(np.float64)
    fpr, tpr, _ = roc_curve(labels, scores)
    eer_val, thr = eer(labels, scores)
    preds = (scores >= thr).astype(np.float64)
    tp = float(np.sum(preds * labels))
    fp = float(np.sum(preds * (1 - labels)))
    fn = float(np.sum((1 - preds) * labels))
    tn = float(np.sum((1 - preds) * (1 - labels)))
    acc = (tp + tn) / max(len(labels), 1)
    prec = tp / max(tp + fp, 1e-12)
    rec = tp / max(tp + fn, 1e-12)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    far = fp / max(fp + tn, 1e-12)
    frr = fn / max(fn + tp, 1e-12)
    return {
        "accuracy": acc, "precision": prec, "recall": rec, "f1": f1,
        "roc_auc": auc(fpr, tpr), "pr_auc": pr_auc(labels, scores),
        "far": far, "frr": frr, "eer": eer_val, "threshold": thr,
    }


# ---------------------------------------------------- clustering metrics

def clustering_accuracy(pred_labels: np.ndarray, gt_labels: np.ndarray
                        ) -> float:
    """Best-permutation clustering accuracy via LAP over the confusion
    matrix."""
    pred_labels = np.asarray(pred_labels)
    gt_labels = np.asarray(gt_labels)
    pu = np.unique(pred_labels)
    gu = np.unique(gt_labels)
    conf = np.zeros((len(pu), len(gu)))
    for i, p in enumerate(pu):
        for j, g in enumerate(gu):
            conf[i, j] = np.sum((pred_labels == p) & (gt_labels == g))
    from ..native import lap_maximize_batch

    out = lap_maximize_batch(conf[None].astype(np.float32),
                             np.array([len(pu)]), np.array([len(gu)]))
    return float((out[0] * conf).sum() / len(gt_labels))


def rand_index(pred_labels: np.ndarray, gt_labels: np.ndarray) -> float:
    """Rand index between two label assignments."""
    pred_labels = np.asarray(pred_labels)
    gt_labels = np.asarray(gt_labels)
    n = len(pred_labels)
    same_p = pred_labels[:, None] == pred_labels[None, :]
    same_g = gt_labels[:, None] == gt_labels[None, :]
    agree = (same_p == same_g)
    iu = np.triu_indices(n, k=1)
    return float(agree[iu].mean()) if n > 1 else 1.0


def clustering_purity(pred_labels: np.ndarray, gt_labels: np.ndarray
                      ) -> float:
    pred_labels = np.asarray(pred_labels)
    gt_labels = np.asarray(gt_labels)
    total = 0
    for p in np.unique(pred_labels):
        members = gt_labels[pred_labels == p]
        if len(members):
            _, counts = np.unique(members, return_counts=True)
            total += counts.max()
    return float(total / len(gt_labels))
