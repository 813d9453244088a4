"""Training state: the model's parameter partitions, the per-stage optimizer,
global-norm gradient clipping and learning-rate access — the counterpart of
the JAX package's `train/state.py`.

Parameters are partitioned by top-level module name into four groups —
backbone / main (graph-matching trunk) / k (AFA-U head) / cls (match
classifier) — each with its own learning rate, so the host-side warmup +
plateau scheduler can retune them. A stage's frozen partitions are out of the
optimizer altogether (no update, no weight decay, no moments) and their
parameters get `requires_grad=False`, so no backward runs through them (the
JAX package differentiates only the live partitions, `argnums=0`).

The optimizer is `torch.optim.AdamW` with optax.adamw's numbers (beta 0.9 /
0.999, eps 1e-8, decoupled weight decay 1e-2 on every parameter of a trained
partition): the same update, p - lr (m_hat / (sqrt(v_hat) + eps) + wd p).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Iterable, List

import torch

from ..core.config import StageConfig

K_MODULES = ("afau",)
CLS_MODULES = ("match_cls",)
BACKBONE_MODULES = ("backbone",)
PARTITIONS = ("backbone", "main", "k", "cls")
WEIGHT_DECAY = 1e-2


def partition_of(name: str) -> str:
    """Partition of a top-level module name."""
    if name in K_MODULES:
        return "k"
    if name in CLS_MODULES:
        return "cls"
    if name in BACKBONE_MODULES:
        return "backbone"
    return "main"


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """Every parameter's name -> its partition, by the top-level module
    name (the JAX package labels the leaves of its parameter tree)."""
    return {name: partition_of(name.split(".", 1)[0])
            for name, _ in model.named_parameters()}


def live_partitions(stage: StageConfig) -> Dict[str, bool]:
    return {"backbone": stage.train_main, "main": stage.train_main,
            "k": stage.train_k, "cls": stage.train_cls}


def base_lrs(stage: StageConfig) -> Dict[str, float]:
    return {"backbone": stage.backbone_lr, "main": stage.lr,
            "k": stage.k_lr, "cls": stage.cls_lr}


def partition_params(model: torch.nn.Module
                     ) -> Dict[str, List[torch.nn.Parameter]]:
    """{partition: its parameters}, by the model's top-level children."""
    out: Dict[str, List[torch.nn.Parameter]] = {p: [] for p in PARTITIONS}
    for name, child in model.named_children():
        out[partition_of(name)].extend(child.parameters())
    return out


def make_optimizer(model: torch.nn.Module, stage: StageConfig
                   ) -> torch.optim.AdamW:
    """AdamW over the stage's live partitions, one parameter group each
    (`group["partition"]` names it), at the stage's base learning rates.
    Sets `requires_grad` of every parameter to its partition's liveness and
    drops gradients left by an earlier stage."""
    live = live_partitions(stage)
    lrs = base_lrs(stage)
    groups = []
    for part, params in partition_params(model).items():
        for p in params:
            p.requires_grad_(live[part])
            p.grad = None
        if live[part] and params:
            groups.append({"params": params, "lr": lrs[part],
                           "partition": part})
    if not groups:
        raise ValueError(f"stage {stage.name} trains no partition")
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """Scale the gradients in place as optax.clip_by_global_norm does:
    g -> g if ||g|| < max_norm else (g / ||g||) * max_norm, ||g|| over every
    gradient together (`torch.nn.utils.clip_grad_norm_` divides by
    ||g|| + 1e-6 instead). No host synchronisation. Returns ||g||."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def set_learning_rates(optimizer: torch.optim.Optimizer,
                       new_lrs: Dict[str, float]) -> None:
    """Partition name -> new absolute learning rate; names of partitions
    the optimizer does not train are ignored."""
    for g in optimizer.param_groups:
        if g["partition"] in new_lrs:
            g["lr"] = float(new_lrs[g["partition"]])


def get_learning_rates(optimizer: torch.optim.Optimizer) -> Dict[str, float]:
    return {g["partition"]: float(g["lr"]) for g in optimizer.param_groups}


@dataclass
class TrainState:
    """The model (weights and BatchNorm statistics live in it), the stage's
    optimizer and the step count."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def snapshot(self) -> dict:
        """Deep copies of the weights, the optimizer state and the step:
        what best-state tracking keeps."""
        return {"model": copy.deepcopy(self.model.state_dict()),
                "optimizer": copy.deepcopy(self.optimizer.state_dict()),
                "step": self.step}

    def restore(self, snap: dict) -> None:
        """Load a snapshot back (copies: the snapshot stays untouched)."""
        self.model.load_state_dict(snap["model"])
        self.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))
        self.step = snap["step"]


def create_state(model: torch.nn.Module, stage: StageConfig) -> TrainState:
    """A fresh optimizer for `stage` over `model` (whose weights carry over
    from the previous stage)."""
    return TrainState(model, make_optimizer(model, stage), 0)
