"""Host-side learning-rate scheduling: linear warmup into reduce-on-plateau.
A pure-Python copy of the JAX package's `train/scheduler.py`; the loop pushes
the resulting rates into the optimizer through
`train.state.set_learning_rates`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class WarmupPlateau:
    base_lrs: Dict[str, float]
    warmup_epochs: int = 1
    factor: float = 0.5
    patience: int = 3
    min_lr: float = 1e-7
    best: float = float("inf")
    bad_epochs: int = 0
    epoch: int = 0
    scale: float = 1.0
    reduced: bool = field(default=False)

    def step(self, val_loss: float) -> Dict[str, float]:
        """Advance one epoch with the validation loss; returns the rates to
        apply. `reduced` flags a drop this epoch (the loop then reloads the
        best weights)."""
        self.epoch += 1
        self.reduced = False
        if self.epoch <= self.warmup_epochs:
            warm = self.epoch / max(self.warmup_epochs, 1)
            return {k: v * warm * self.scale for k, v in self.base_lrs.items()}
        if val_loss < self.best - 1e-8:
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor,
                                 self.min_lr / max(max(
                                     self.base_lrs.values()), 1e-12))
                self.bad_epochs = 0
                self.reduced = True
        return {k: max(v * self.scale, self.min_lr)
                for k, v in self.base_lrs.items()}
