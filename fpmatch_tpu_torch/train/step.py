"""Eval steps with stage-conditional loss composition: the inference half of
the JAX package's `train/step.py`, as plain functions under
`torch.inference_mode()` (no jit, no state object: the model carries its
weights).

  stage 6       -> cls only
  stages 4, 5   -> ks + cls
  otherwise     -> perm + ks + cls
through the StageConfig.loss_{perm,ks,cls} flags. The train step is not
ported yet (ROADMAP.md, Queue A: training).

The JAX package binds a UNIV plan to its model; here the model takes the plan
per call, so every step carries `univ_plan` down to the forward. A step built
without it sends a UNIV request's aggregations down the bucket route.
"""
from __future__ import annotations

import torch

from ..core.config import StageConfig
from ..evaluation.metrics import matching_accuracy
from ..models.ngm import NGMNet, PairBatch
from .losses import permutation_loss

EVAL_OUTPUTS = ("cls_prob", "k_prob", "perm_mat", "ds_mat")


def loss_and_metrics(model: NGMNet, batch: PairBatch, stage: StageConfig,
                     train: bool = False, hungarian_mask=None, univ_plan=None):
    """Forward + the stage's loss terms + matching accuracy. Returns
    (total, (metrics, out)); every value is a tensor on the batch's device.
    `univ_plan` (a `kernels.assoc_univ_v3` plan, B == 1) routes the
    aggregations through the UNIV kernel, as `NGMNet.forward`'s does.
    """
    if train:
        raise NotImplementedError(
            "the train step (train-mode BatchNorm, backward kernels) is not "
            "ported to fpmatch_tpu_torch yet (ROADMAP.md, Queue A: training)")
    with torch.inference_mode():
        out = model(batch, hungarian_mask=hungarian_mask,
                    univ_plan=univ_plan)
        n1 = batch.n_nodes[:, 0]
        n2 = batch.n_nodes[:, 1]
        perm_loss = permutation_loss(out["ds_mat"], batch.gt_perm, n1, n2)
        total = torch.zeros((), device=perm_loss.device)
        if stage.loss_perm:
            total = total + perm_loss
        if stage.loss_ks:
            total = total + out["ks_loss"]
        if stage.loss_cls:
            total = total + out["cls_loss"]
        acc = torch.mean(matching_accuracy(out["perm_mat"], batch.gt_perm,
                                           n1, n2))
    metrics = {
        "loss": perm_loss,
        "total_loss": total,
        "ks_loss": out["ks_loss"],
        "ks_error": out["ks_error"],
        "cls_loss": out["cls_loss"],
        "accuracy": acc,
    }
    return total, (metrics, out)


def make_eval_step(model: NGMNet, stage: StageConfig, univ_plan=None):
    """eval_step(batch) -> (metrics, {cls_prob, k_prob, perm_mat, ds_mat})."""

    def eval_step(batch: PairBatch):
        _, (metrics, out) = loss_and_metrics(model, batch, stage,
                                             univ_plan=univ_plan)
        return metrics, {k: out[k] for k in EVAL_OUTPUTS}

    return eval_step


def make_eval_step_masked(model: NGMNet, stage: StageConfig, univ_plan=None):
    """Eval step whose greedy fill ranks by `hungarian_mask * ds_mat`: the
    second pass of the host-Hungarian discretization round-trip (the mask
    comes from `ops.hungarian.hungarian_host` on the first pass's `ds_mat`).
    A UNIV request passes its plan here too, so both passes take the UNIV
    route."""

    def eval_step(batch: PairBatch, hungarian_mask):
        _, (metrics, out) = loss_and_metrics(model, batch, stage,
                                             hungarian_mask=hungarian_mask,
                                             univ_plan=univ_plan)
        return metrics, {k: out[k] for k in EVAL_OUTPUTS}

    return eval_step
