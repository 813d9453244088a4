"""Checkpoints in the port's own format: `torch.save(state_dict)` at
`<dir>/<name>.pt` plus the `checkpoint.json` sidecar (`latest`, curriculum
metadata) that the JAX package's `train/checkpoints.py` keeps. Importing an
orbax checkpoint is not ported yet (ROADMAP.md, Queue A: checkpoints import);
weights cross over through `convert.from_flax_variables`.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional


def _path(ckpt_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{name}.pt")


def save_checkpoint(ckpt_dir: str, name: str, model_or_state_dict,
                    extra: Optional[Dict] = None) -> str:
    """Save a model's (or a given) state_dict under `ckpt_dir/name.pt` and
    record it as `latest` in the JSON sidecar. Returns the file path."""
    import torch

    sd = model_or_state_dict
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
    path = _path(ckpt_dir, name)
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)
    meta = read_meta(ckpt_dir)
    meta["latest"] = name
    if extra:
        meta.update(extra)
    with open(os.path.join(os.path.abspath(ckpt_dir), "checkpoint.json"),
              "w") as f:
        json.dump(meta, f, indent=2)
    return path


def restore_params(ckpt_dir: str, name: str) -> Dict:
    """The state_dict saved as `ckpt_dir/name.pt`, on the CPU."""
    import torch

    return torch.load(_path(ckpt_dir, name), map_location="cpu",
                      weights_only=True)


def read_meta(ckpt_dir: str) -> Dict:
    meta_path = os.path.join(os.path.abspath(ckpt_dir), "checkpoint.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}
