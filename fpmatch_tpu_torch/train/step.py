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

Under a rank grid (`grid`, `parallel.distributed.RankGrid`: the batch is this
rank's slice of the global batch) the steps compute what the JAX package's
GSPMD step computes on the global batch: the permutation loss divides by the
global sum(ns1), the batch means (`cls_loss`, `ks_loss`, `ks_error`,
`accuracy`) are scaled by 1 / D, so the ranks' losses add up to the global
one; the metrics are summed over the data group (every rank reports the
global values), and the train step sums the gradients over the data group
before clipping (`sync_gradients`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..core.config import StageConfig
from ..evaluation.metrics import matching_accuracy
from ..models.ngm import NGMNet, PairBatch
from ..utils.profiling import backward_spans, span
from .losses import permutation_loss
from .state import TrainState, clip_by_global_norm_

EVAL_OUTPUTS = ("cls_prob", "k_prob", "perm_mat", "ds_mat")


def loss_and_metrics(model: NGMNet, batch: PairBatch, stage: StageConfig,
                     train: bool = False, hungarian_mask=None, univ_plan=None,
                     grid=None):
    """Forward + the stage's loss terms + matching accuracy. Returns
    (total, (metrics, out)); every value is a tensor on the batch's device.
    `univ_plan` (a `kernels.assoc_univ_v3` plan, B == 1) routes the
    aggregations through the UNIV kernel, as `NGMNet.forward`'s does.
    Under `grid`, `total` is this rank's share of the global loss and the
    metrics are the global batch's (see the module docstring).
    """
    group = None if grid is None else grid.data_group
    scale = 1.0 if grid is None else 1.0 / grid.data
    bn_kw = {}
    if train and model.cfg.train.bn_follows_trainability:
        # frozen partitions keep their BatchNorm on the running statistics
        bn_kw = dict(bn_main=stage.train_main, bn_cls=stage.train_cls)
    with contextlib.nullcontext() if train else torch.inference_mode():
        out = model(batch, train=train, hungarian_mask=hungarian_mask,
                    univ_plan=univ_plan, **bn_kw)
        with span("step.loss"):
            n1 = batch.n_nodes[:, 0]
            n2 = batch.n_nodes[:, 1]
            perm_loss = permutation_loss(out["ds_mat"], batch.gt_perm, n1,
                                         n2, group=group)
            ks_loss = out["ks_loss"] * scale
            cls_loss = out["cls_loss"] * scale
            total = torch.zeros((), device=perm_loss.device)
            if stage.loss_perm:
                total = total + perm_loss
            if stage.loss_ks:
                total = total + ks_loss
            if stage.loss_cls:
                total = total + cls_loss
            acc = torch.mean(matching_accuracy(out["perm_mat"], batch.gt_perm,
                                               n1, n2)) * scale
            metrics = {
                "loss": perm_loss,
                "total_loss": total,
                "ks_loss": ks_loss,
                "ks_error": out["ks_error"] * scale,
                "cls_loss": cls_loss,
                "accuracy": acc,
            }
            if group is not None:
                summed = torch.stack([v.detach().float() for v in
                                      metrics.values()])
                dist.all_reduce(summed, group=group)
                metrics = dict(zip(metrics, summed.unbind()))
    return total, (metrics, out)


def sync_gradients(params, grid) -> None:
    """Sum the gradients over the grid's data group (one flat all-reduce);
    with more than one edge rank, then take the edge group's first rank's
    sums on every rank of the group, so that the ranks of an edge group,
    which compute the same gradients, keep bit-identical weights even where
    a CUDA backward's atomics round differently from rank to rank."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=grid.data_group)
    if grid.edge > 1:
        dist.broadcast(flat, src=grid.d * grid.edge, group=grid.edge_group)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


def make_train_step(model: NGMNet, stage: StageConfig, grid=None):
    """train_step(state, batch) -> (state, metrics): one forward in train
    mode, the backward of the stage's loss through its live partitions,
    (under `grid`) the gradients summed over the data group, optax-style
    global-norm clipping (`stage.grad_clip`) and one AdamW step of
    `state.optimizer` (made for this stage by `train.state.create_state`,
    which also set which parameters require a gradient). Metrics are
    detached tensors on the batch's device."""

    def train_step(state: TrainState, batch: PairBatch):
        with span("train_step", str(state.step)):
            opt = state.optimizer
            opt.zero_grad(set_to_none=True)
            total, (metrics, _) = loss_and_metrics(model, batch, stage,
                                                   train=True, grid=grid)
            with backward_spans(total, "train_step.backward"):
                total.backward()
            params = [p for g in opt.param_groups for p in g["params"]]
            if grid is not None:
                with span("train_step.grad_sync"):
                    sync_gradients(params, grid)
            if stage.grad_clip is not None:
                with span("train_step.clip"):
                    clip_by_global_norm_(params, stage.grad_clip)
            with span("train_step.optimizer"):
                opt.step()
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model: NGMNet, stage: StageConfig, univ_plan=None,
                   grid=None):
    """eval_step(batch) -> (metrics, {cls_prob, k_prob, perm_mat, ds_mat}).
    Under `grid` the metrics are the global batch's, the outputs this
    rank's slice's."""

    def eval_step(batch: PairBatch):
        _, (metrics, out) = loss_and_metrics(model, batch, stage,
                                             univ_plan=univ_plan, grid=grid)
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
