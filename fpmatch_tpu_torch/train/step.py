"""Train and eval steps with stage-conditional loss composition: the JAX
package's `train/step.py` as plain functions (no jit: the model carries its
weights, `train.state.TrainState` the optimizer).

  stage 6       -> cls only
  stages 4, 5   -> ks + cls
  otherwise     -> perm + ks + cls
through the StageConfig.loss_{perm,ks,cls} flags.

The train step differentiates only the stage's live partitions (the others
get `requires_grad=False` from `train.state.make_optimizer`): in the k-only
and cls-only stages 2, 4 and 6 no backward runs through the backbone or the
association GNN, so the backward kernels of `ops.assoc` run in stages 1, 3
and 5 only. With `cfg.train.bn_follows_trainability` the frozen partitions'
BatchNorm stays on its running statistics.

The JAX package binds a UNIV plan to its model; here the model takes the plan
per call, so every step carries `univ_plan` down to the forward. A step built
without it sends a UNIV request's aggregations down the bucket route.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.config import StageConfig
from ..evaluation.metrics import matching_accuracy
from ..models.ngm import NGMNet, PairBatch
from .losses import permutation_loss
from .state import TrainState, clip_by_global_norm_

EVAL_OUTPUTS = ("cls_prob", "k_prob", "perm_mat", "ds_mat")


def loss_and_metrics(model: NGMNet, batch: PairBatch, stage: StageConfig,
                     train: bool = False, hungarian_mask=None, univ_plan=None):
    """Forward + the stage's loss terms + matching accuracy. Returns
    (total, (metrics, out)); every value is a tensor on the batch's device.
    `univ_plan` (a `kernels.assoc_univ_v3` plan, B == 1) routes the
    aggregations through the UNIV kernel, as `NGMNet.forward`'s does.
    """
    bn_kw = {}
    if train and model.cfg.train.bn_follows_trainability:
        # frozen partitions keep their BatchNorm on the running statistics
        bn_kw = dict(bn_main=stage.train_main, bn_cls=stage.train_cls)
    with contextlib.nullcontext() if train else torch.inference_mode():
        out = model(batch, train=train, hungarian_mask=hungarian_mask,
                    univ_plan=univ_plan, **bn_kw)
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


def make_train_step(model: NGMNet, stage: StageConfig):
    """train_step(state, batch) -> (state, metrics): one forward in train
    mode, the backward of the stage's loss through its live partitions,
    optax-style global-norm clipping (`stage.grad_clip`) and one AdamW step
    of `state.optimizer` (made for this stage by `train.state.create_state`,
    which also set which parameters require a gradient). Metrics are
    detached tensors on the batch's device."""

    def train_step(state: TrainState, batch: PairBatch):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        total, (metrics, _) = loss_and_metrics(model, batch, stage,
                                               train=True)
        total.backward()
        if stage.grad_clip is not None:
            clip_by_global_norm_([p for g in opt.param_groups
                                  for p in g["params"]], stage.grad_clip)
        opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


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
