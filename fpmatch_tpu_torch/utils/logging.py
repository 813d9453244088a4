"""Metrics logging for `cli.train --log-dir`: JSONL always, TensorBoard event
files where `torch.utils.tensorboard` imports (the JSONL stream is the source
of truth). The counterpart of the JAX package's `utils/logging.py`."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:       # tensorboard absent: JSONL only
                self._tb = None

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    prefix: str = ""):
        row = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}" if prefix else k
            row[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), step)
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
