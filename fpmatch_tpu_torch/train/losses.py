"""Masked loss functions: the part of the JAX package's `train/losses.py`
that its training and evaluation paths run (`permutation_loss`). The other
losses, which no JAX path calls, are not ported yet (ROADMAP.md, Queue A:
training).

Losses take padded (B, S1, S2) matrices + per-sample valid counts: summed
over valid cells, normalized by the summed source-node counts.
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
