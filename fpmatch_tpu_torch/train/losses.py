"""Masked loss functions (the JAX package's `train/losses.py`; reference
src/loss_func.py).

Losses take padded (B, S1, S2) matrices + per-sample valid counts and reduce
as the reference does: summed over valid cells and normalized by the summed
source-node counts (the permutation family), or averaged per batch.
`permutation_loss` is the one the training and evaluation paths run; the
others are library losses with the JAX package's normalisers.
"""
from __future__ import annotations

import torch

from ..ops.masking import rect_mask

# must be representable against 1.0 in fp32: with eps below machine epsilon
# clamp(p, EPS, 1 - EPS) is a no-op at the top end and a fully converged cell
# (p == 1.0 exactly) makes the BCE compute 0 * (-inf) = NaN
EPS = 1e-7


def _valid_mask(ns1, ns2, s1: int, s2: int):
    return rect_mask(ns1, ns2, s1, s2)


def permutation_loss(pred_dsmat, gt_perm, ns1, ns2, group=None):
    """Masked binary cross-entropy between the predicted doubly-stochastic
    matrix and the GT permutation; sum over valid cells / sum(ns1).

    `group` (a rank grid's data group): the batch is this rank's slice of
    the global batch, and sum(ns1) is the global batch's; the ranks' losses
    then add up to the global batch's loss."""
    m = _valid_mask(ns1, ns2, pred_dsmat.shape[1], pred_dsmat.shape[2])
    p = torch.clamp(pred_dsmat, EPS, 1.0 - EPS)
    ce = -(gt_perm * torch.log(p) + (1.0 - gt_perm) * torch.log1p(-p))
    total = torch.sum(torch.where(m, ce, 0.0))
    den = torch.sum(ns1).to(pred_dsmat.dtype)
    if group is not None:
        import torch.distributed as dist

        den = den.detach().clone()
        dist.all_reduce(den, group=group)
    return total / torch.clamp(den, min=1.0)


def _per_source_node(total, pred, ns1):
    return total / torch.clamp(torch.sum(ns1).to(pred.dtype), min=1.0)


def cross_entropy_loss(pred_dsmat, gt_perm, ns1, ns2):
    """Row-wise cross entropy against the GT column (loss_func.py:62-113):
    -sum log(p[i, gt_col(i)]) over matched rows / sum(ns1)."""
    m = _valid_mask(ns1, ns2, pred_dsmat.shape[1], pred_dsmat.shape[2])
    p = torch.clamp(pred_dsmat, EPS, 1.0 - EPS)
    row_has_match = torch.sum(torch.where(m, gt_perm, 0.0), dim=2) > 0
    picked = torch.sum(torch.where(m, gt_perm * torch.log(p), 0.0), dim=2)
    total = -torch.sum(torch.where(row_has_match, picked, 0.0))
    return _per_source_node(total, pred_dsmat, ns1)


def focal_loss(pred_dsmat, gt_perm, ns1, ns2, gamma: float = 0.0,
               alpha: float = 0.5):
    """Focal variant of the permutation BCE (loss_func.py:216-271)."""
    m = _valid_mask(ns1, ns2, pred_dsmat.shape[1], pred_dsmat.shape[2])
    p = torch.clamp(pred_dsmat, EPS, 1.0 - EPS)
    pos = -alpha * ((1 - p) ** gamma) * gt_perm * torch.log(p)
    neg = -(1 - alpha) * (p ** gamma) * (1 - gt_perm) * torch.log1p(-p)
    total = torch.sum(torch.where(m, pos + neg, 0.0))
    return _per_source_node(total, pred_dsmat, ns1)


def inner_product_loss(pred_dsmat, gt_perm, ns1, ns2):
    """-<pred, gt> over valid cells / sum(ns1) (loss_func.py:318-348)."""
    m = _valid_mask(ns1, ns2, pred_dsmat.shape[1], pred_dsmat.shape[2])
    total = -torch.sum(torch.where(m, pred_dsmat * gt_perm, 0.0))
    return _per_source_node(total, pred_dsmat, ns1)


def hamming_loss(pred_perm, gt_perm, ns1, ns2):
    """Differentiable Hamming distance between a (soft) permutation and the
    GT (loss_func.py:349-386), batch mean."""
    m = _valid_mask(ns1, ns2, pred_perm.shape[1], pred_perm.shape[2])
    ham = pred_perm * (1.0 - gt_perm) + (1.0 - pred_perm) * gt_perm
    return torch.mean(torch.sum(torch.where(m, ham, 0.0), dim=(1, 2)))


def offset_loss(p_src, p_tgt_pred, p_tgt_gt, ns, norm: float = 1.0):
    """Robust endpoint offset loss between predicted and GT displacements
    (loss_func.py:174-215): the masked sum of the Euclidean distances
    (sqrt(|d|^2 + 1e-12)) / sum(ns). p_* (B, N, 2), ns (B,)."""
    n = p_src.shape[1]
    mask = (torch.arange(n, device=p_src.device)[None, :]
            < ns.reshape(-1, 1))[..., None]
    d = (p_tgt_pred - p_tgt_gt) / norm
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)[..., None]
    total = torch.sum(torch.where(mask, dist, 0.0))
    return total / torch.clamp(torch.sum(ns).to(p_src.dtype), min=1.0)


def bce_with_logits(logits, labels):
    """Numerically stable binary cross entropy on logits (mean)."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def distill_infonce(feat_student, feat_teacher, ns, tau: float = 0.07):
    """InfoNCE distillation between per-node embeddings of two models, one
    graph (loss_func.py Distill_InfoNCE): positives are same-node pairs,
    negatives all other valid nodes. feat_* (N, D), ns a scalar count."""
    n = feat_student.shape[0]
    mask = torch.arange(n, device=feat_student.device) < ns
    fs = feat_student / torch.clamp(
        torch.linalg.norm(feat_student, dim=-1, keepdim=True), min=1e-8)
    ft = feat_teacher / torch.clamp(
        torch.linalg.norm(feat_teacher, dim=-1, keepdim=True), min=1e-8)
    logits = fs @ ft.T / tau
    logits = torch.where(mask[None, :], logits, -1e9)
    logp = torch.log_softmax(logits, dim=-1)
    pos = torch.diagonal(logp)
    return -torch.sum(torch.where(mask, pos, 0.0)) / torch.clamp(
        torch.sum(mask).to(feat_student.dtype), min=1.0)


def distill_quadratic_contrast(sim_student, sim_teacher, ns1, ns2):
    """Quadratic-contrast distillation on similarity matrices (loss_func.py
    Distill_QuadraticContrast): the teacher's (no gradient) pairwise
    similarity structure matched in the least-squares sense, mean over the
    valid cells."""
    m = _valid_mask(ns1, ns2, sim_student.shape[1], sim_student.shape[2])
    d = (sim_student - sim_teacher.detach()) ** 2
    return torch.sum(torch.where(m, d, 0.0)) / torch.clamp(
        torch.sum(m.to(sim_student.dtype)), min=1.0)


def permutation_loss_hung(pred_dsmat, pred_perm, gt_perm, ns1, ns2):
    """Hungarian-attention permutation loss (loss_func.py:114-173, BBGM):
    the BCE restricted to the attention set, the union of the discrete
    prediction (no gradient) and the ground truth."""
    m = _valid_mask(ns1, ns2, pred_dsmat.shape[1], pred_dsmat.shape[2])
    att = torch.maximum(pred_perm.detach(), gt_perm)
    p = torch.clamp(pred_dsmat, EPS, 1.0 - EPS)
    ce = -(gt_perm * torch.log(p) + (1.0 - gt_perm) * torch.log1p(-p)) * att
    total = torch.sum(torch.where(m, ce, 0.0))
    return _per_source_node(total, pred_dsmat, ns1)
