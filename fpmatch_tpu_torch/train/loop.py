"""Stage-curriculum trainer: the counterpart of the JAX package's
`train/loop.py`.

Per stage: a fresh optimizer over the stage's trainable partitions, warmup ->
plateau learning-rate schedule, per-epoch training (`passes_per_epoch` passes
over the loader) + validation, best-state tracking (deep copies) with reload
of the best state on a learning-rate drop, early stopping, the periodic test
evaluation, and `{stage}_best` / `{stage}_last` (optionally numbered)
checkpoints. A stage ends with the model holding its best state, which the
next stage starts from.

`train_step_ms` / `train_pairs_per_s` are timed from the second step of an
epoch to its last, on the host clock, with the device synchronised before
each reading on a CUDA device.

Under a rank grid (`grid`) every rank trains and validates its slice of each
batch (the metrics, and so the schedule, early stopping and best state, are
the global batch's on every rank); rank 0 alone writes the checkpoints (its
model's own state_dict, which loads into a one-device model) and runs the
periodic test evaluation (given the test loader only there: whole batches,
no row plan, the one-device route), and a barrier follows each. Logging is
the caller's: it gives the other ranks a silent `log_fn`.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import StageConfig
from ..evaluation.metrics import verification_metrics
from ..models.ngm import NGMNet
from .checkpoints import save_checkpoint
from .scheduler import WarmupPlateau
from .state import TrainState, base_lrs, create_state, set_learning_rates
from .step import make_eval_step, make_train_step

logger = logging.getLogger("fpmatch_tpu_torch.train")


@dataclass
class EpochStats:
    metrics: Dict[str, float] = field(default_factory=dict)

    def update(self, batch_metrics: Dict):
        for k, v in batch_metrics.items():
            v = float(v)
            if k in self.metrics:
                n = self.metrics[f"_n_{k}"]
                self.metrics[k] = (self.metrics[k] * n + v) / (n + 1)
                self.metrics[f"_n_{k}"] = n + 1
            else:
                self.metrics[k] = v
                self.metrics[f"_n_{k}"] = 1

    def get(self) -> Dict[str, float]:
        return {k: v for k, v in self.metrics.items()
                if not k.startswith("_n_")}


def _sync(model: torch.nn.Module) -> None:
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def train_stage(model: NGMNet, state: TrainState, stage: StageConfig,
                train_loader, val_loader, *, test_loader=None,
                checkpoint_dir: Optional[str] = None,
                passes_per_epoch: int = 3, eval_every: int = 5,
                early_stop_patience: int = 10,
                log_fn: Callable[[str], None] = logger.info,
                metrics_logger=None, numbered_checkpoints: bool = False,
                grid=None):
    """Run one curriculum stage; returns (state holding the best weights,
    history). Under `grid`, checkpoints are written by rank 0 only."""
    on_grid = {} if grid is None else {"grid": grid}
    train_step = make_train_step(model, stage, **on_grid)
    eval_step = make_eval_step(model, stage, **on_grid)
    if grid is not None and grid.rank != 0:
        checkpoint_dir = None
    sched = WarmupPlateau(base_lrs=base_lrs(stage),
                          warmup_epochs=stage.warmup_epochs,
                          factor=stage.lr_decay, patience=stage.patience)

    best_val = float("inf")
    best = state.snapshot()
    bad_epochs = 0
    history: List[Dict[str, float]] = []

    for epoch in range(stage.start_epoch, stage.num_epochs):
        t0 = time.time()
        stats = EpochStats()
        n_steps = n_pairs = 0
        t_first = None
        for _ in range(passes_per_epoch):
            for batch in train_loader:
                state, metrics = train_step(state, batch)
                if t_first is None:
                    # the first step pays the one-time costs: the window
                    # starts after it
                    _sync(model)
                    t_first = time.time()
                else:
                    n_steps += 1
                    n_pairs += int(batch.batch_size)
                stats.update(metrics)
        if n_steps:
            _sync(model)
            train_secs = time.time() - t_first
        train_metrics = stats.get()

        vstats = EpochStats()
        for batch in val_loader:
            metrics, _ = eval_step(batch)
            vstats.update(metrics)
        val_metrics = vstats.get()
        val_loss = val_metrics.get("total_loss", float("inf"))

        lrs = sched.step(val_loss)
        set_learning_rates(state.optimizer, lrs)

        if val_loss < best_val:
            best_val = val_loss
            best = state.snapshot()
            bad_epochs = 0
            if checkpoint_dir:
                save_checkpoint(checkpoint_dir, f"{stage.name}_best", state,
                                extra={"stage": stage.name, "epoch": epoch})
        else:
            bad_epochs += 1

        if sched.reduced:
            # reload the best state on a learning-rate drop
            state.restore(best)
            set_learning_rates(state.optimizer, lrs)

        row = {"epoch": epoch, "time_s": time.time() - t0,
               **{f"train_{k}": v for k, v in train_metrics.items()},
               **{f"val_{k}": v for k, v in val_metrics.items()}}
        if n_steps:
            row["train_pairs_per_s"] = n_pairs / max(train_secs, 1e-9)
            row["train_step_ms"] = 1e3 * train_secs / n_steps
        history.append(row)
        if metrics_logger is not None:
            metrics_logger.log_scalars(
                epoch, {k: v for k, v in row.items() if k != "epoch"},
                prefix=f"{stage.name}/")
        log_fn(f"[{stage.name}] epoch {epoch}: "
               f"train_loss={train_metrics.get('total_loss', 0):.4f} "
               f"val_loss={val_loss:.4f} "
               f"acc={train_metrics.get('accuracy', 0):.4f} "
               f"({row['time_s']:.1f}s"
               + (f", {row['train_pairs_per_s']:.2f} pairs/s, "
                  f"{row['train_step_ms']:.1f} ms/step" if n_steps else "")
               + ")")

        if checkpoint_dir:
            save_checkpoint(checkpoint_dir, f"{stage.name}_last", state,
                            extra={"stage": stage.name, "epoch": epoch})
            if numbered_checkpoints:
                save_checkpoint(checkpoint_dir,
                                f"{stage.name}_epoch{epoch:04d}", state,
                                extra={"stage": stage.name, "epoch": epoch})
        _barrier(grid)

        if (epoch + 1) % eval_every == 0:
            if test_loader is not None:
                tm = evaluate_verification(model, stage, test_loader)
                log_fn(f"[{stage.name}] epoch {epoch} test: "
                       f"EER={tm.get('eer', float('nan')):.4f} "
                       f"ROC-AUC={tm.get('roc_auc', float('nan')):.4f}")
            _barrier(grid)

        if bad_epochs >= early_stop_patience:
            log_fn(f"[{stage.name}] early stop at epoch {epoch}")
            break

    state.restore(best)
    return state, history


def _barrier(grid) -> None:
    if grid is not None:
        dist.barrier()


def run_curriculum(model: NGMNet, stages, train_loader, val_loader, *,
                   test_loader=None, checkpoint_dir: Optional[str] = None,
                   metrics_logger=None,
                   on_stage_end: Optional[Callable] = None, **kw):
    """Run the multi-stage curriculum: each stage starts from the previous
    stage's best weights and BatchNorm statistics with a fresh optimizer.
    `on_stage_end(stage, history)` is called after each stage. Returns
    (final state, {stage name: history})."""
    all_history = {}
    state = None
    for stage in stages:
        state, hist = train_stage(model, create_state(model, stage), stage,
                                  train_loader, val_loader,
                                  test_loader=test_loader,
                                  checkpoint_dir=checkpoint_dir,
                                  metrics_logger=metrics_logger, **kw)
        all_history[stage.name] = hist
        if on_stage_end is not None:
            on_stage_end(stage, hist)
    return state, all_history


def evaluate_verification(model: NGMNet, stage: StageConfig, loader
                          ) -> Dict[str, float]:
    """Genuine / impostor scores over a loader -> the ROC / EER report. The
    score is the fused cls_prob * k_prob, as `cli.evaluate --score fused`."""
    eval_step = make_eval_step(model, stage)
    labels, scores, k_probs = [], [], []
    match_stats = EpochStats()
    for batch in loader:
        metrics, out = eval_step(batch)
        match_stats.update(metrics)
        labels.append(_np(batch.label))
        scores.append(_np(out["cls_prob"]))
        k_probs.append(_np(out["k_prob"]))
    labels = np.concatenate(labels)
    scores = np.concatenate(scores) * np.concatenate(k_probs)
    report: Dict[str, float] = dict(match_stats.get())
    if len(np.unique(labels)) == 2:
        report.update(verification_metrics(labels, scores))
    report["n_pairs"] = float(len(labels))
    return report
