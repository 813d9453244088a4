"""Checkpoints in the port's own format: `torch.save(state_dict)` at
`<dir>/<name>.pt`, the optimizer's state (when a `train.state.TrainState` is
saved) at `<dir>/<name>.opt.pt`, plus the `checkpoint.json` sidecar
(`latest`, curriculum metadata) that the JAX package's
`train/checkpoints.py` keeps. `warm_start` is its shape-tolerant load.

A matcher trained by the JAX package comes across without orbax: on the
JAX side its orbax checkpoint is written out as a flat `.npz` with that
package's `poredet.train.save_variables("ckpt/stage6_best.npz",
train.checkpoints.restore_loose("ckpt", "stage6_best"))` (keys
`params/...`, `batch_stats/...`, `step`), which `import_flax_npz`
converts (`convert.from_flax_variables`). `restore_params` reads
`<name>.npz` where `<name>.pt` is absent, so the CLIs' `--checkpoint-dir`
takes such a directory as it is.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple


def _path(ckpt_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{name}.pt")


def save_checkpoint(ckpt_dir: str, name: str, model_or_state_dict,
                    extra: Optional[Dict] = None) -> str:
    """Save a model's (or a given) state_dict under `ckpt_dir/name.pt` and
    record it as `latest` in the JSON sidecar. A TrainState saves its
    model's weights there and its optimizer's state (with the step) in
    `ckpt_dir/name.opt.pt`. Returns the weights' file path."""
    import torch

    sd = model_or_state_dict
    opt = None
    if hasattr(sd, "optimizer"):
        opt = {"optimizer": sd.optimizer.state_dict(), "step": sd.step}
        sd = sd.model
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
    path = _path(ckpt_dir, name)
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)
    if opt is not None:
        torch.save(opt, _path(ckpt_dir, name + ".opt"))
    meta = read_meta(ckpt_dir)
    meta["latest"] = name
    if extra:
        meta.update(extra)
    with open(os.path.join(os.path.abspath(ckpt_dir), "checkpoint.json"),
              "w") as f:
        json.dump(meta, f, indent=2)
    return path


def import_flax_npz(path, cfg=None) -> Dict:
    """The state_dict of the JAX package's variables in the flat `.npz` at
    `path` (its `step` ignored): checked against `NGMNet(cfg)` by
    `convert.from_flax_variables` where `cfg` is given, else converted by
    name only (no `num_batches_tracked`), for the shape-tolerant
    `warm_start`."""
    from ..convert import (flax_tree_to_state_dict, from_flax_variables,
                           read_flax_npz)

    variables = read_flax_npz(path)
    if cfg is not None:
        return from_flax_variables(variables, cfg)
    return flax_tree_to_state_dict(variables["params"],
                                   variables.get("batch_stats"))


def restore_params(ckpt_dir: str, name: str, cfg=None) -> Dict:
    """The state_dict saved as `ckpt_dir/name.pt`, on the CPU; where that
    file is absent, the JAX package's variables in `ckpt_dir/name.npz`
    (`import_flax_npz`, checked against `NGMNet(cfg)` when `cfg` is
    given)."""
    import torch

    path = _path(ckpt_dir, name)
    npz = path[:-len(".pt")] + ".npz"
    if not os.path.exists(path) and os.path.exists(npz):
        return import_flax_npz(npz, cfg)
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(ckpt_dir: str, name: str, state) -> None:
    """Load `name`'s weights and optimizer state into a TrainState (resume
    of the same stage)."""
    import torch

    state.model.load_state_dict(restore_params(ckpt_dir, name))
    opt = torch.load(_path(ckpt_dir, name + ".opt"), map_location="cpu",
                     weights_only=True)
    state.optimizer.load_state_dict(opt["optimizer"])
    state.step = int(opt["step"])


def warm_start(state_dict: Dict, restored: Dict) -> Tuple[Dict, int]:
    """Copy restored tensors into `state_dict` wherever name and shape match
    (the shape-tolerant load of the JAX package's `warm_start`, which lets
    the architecture change between runs). Returns (new state_dict, number
    of tensors restored)."""
    out, kept = dict(state_dict), 0
    for k, v in state_dict.items():
        r = restored.get(k)
        if r is not None and tuple(r.shape) == tuple(v.shape):
            out[k] = r.to(dtype=v.dtype, device=v.device)
            kept += 1
    return out, kept


def read_meta(ckpt_dir: str) -> Dict:
    meta_path = os.path.join(os.path.abspath(ckpt_dir), "checkpoint.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}
