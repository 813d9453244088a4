"""Weights carried across: a Flax `variables` tree of the JAX package's
`NGMNet`, handed over as numpy arrays, becomes a `state_dict` of this
package's `NGMNet`.

The two models name their children alike, so the mapping is by path:

  Dense  `kernel` (in, out)        -> `weight` (out, in)
  Conv   `kernel` HWIO             -> `weight` OIHW
  BatchNorm `scale` / `bias`       -> `weight` / `bias`
  batch_stats `mean` / `var`       -> `running_mean` / `running_var`
  raw parameters (`conv{i}_weight`, `conv{i}_root`, `conv{i}_bias`,
  `mix{1,2}_{weight,bias}`, `norm{1,2}_{scale,bias}`, AFA-I's
  `weight_matrix`, `weight_matrix_block`)  -> carried by name

`pore_variables_to_state_dict` does the same for the pore detector.

The caller converts its tree to numpy first (e.g.
`jax.tree_util.tree_map(np.asarray, variables)`); nothing here imports JAX.
Activations need no conversion: both packages keep images and feature maps
channels-last at their public boundaries (the pore detector's is a (H, W)
image, `poredet.inference.detect_pores_in_image`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.config import Config


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def read_flax_npz(path) -> Dict:
    """A flat `.npz` of a Flax variable tree (keys `/`-joined paths, as the
    JAX package's `poredet.train.save_variables` writes any tree) back into
    nested numpy dicts."""
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            *mods, leaf = key.split("/")
            node = out
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    return out


def flax_tree_to_state_dict(params: Mapping, batch_stats: Mapping = None
                            ) -> Dict[str, torch.Tensor]:
    """The naming rules above applied to any Flax module's variables (no
    check against a torch module)."""
    out: Dict[str, torch.Tensor] = {}

    def put(path, name, arr):
        out[".".join(path + (name,))] = torch.from_numpy(
            np.array(arr, dtype=np.float32, copy=True))

    for path, arr in _flatten(params):
        *mod, leaf = path
        mod = tuple(mod)
        if leaf == "kernel" and arr.ndim == 2:
            put(mod, "weight", arr.T)
        elif leaf == "kernel" and arr.ndim == 4:
            put(mod, "weight", arr.transpose(3, 2, 0, 1))
        elif leaf == "scale":
            put(mod, "weight", arr)
        else:                       # bias, raw parameters
            put(mod, leaf, arr)
    for path, arr in _flatten(batch_stats or {}):
        *mod, leaf = path
        put(tuple(mod), {"mean": "running_mean", "var": "running_var"}[leaf],
            arr)
    return out


def from_flax_variables(variables: Mapping, cfg: Config
                        ) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} of numpy arrays -> state_dict for
    `models.ngm.NGMNet(cfg)` (for backbone kind "none" with the feature
    width of the tree's `backbone.proj`). Raises if the converted keys or
    shapes do not cover the model's own state_dict exactly."""
    from .models.ngm import NGMNet

    out = flax_tree_to_state_dict(variables["params"],
                                  variables.get("batch_stats"))
    proj = out.get("backbone.proj.weight")
    feature_dim = None if proj is None else proj.shape[1]
    want = NGMNet(cfg, feature_dim=feature_dim).state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            out.setdefault(k, torch.zeros_like(v))
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    bad = sorted(k for k in set(want) & set(out)
                 if tuple(want[k].shape) != tuple(out[k].shape))
    if missing or extra or bad:
        raise ValueError(
            f"converted tree does not match NGMNet(cfg): missing={missing} "
            f"unexpected={extra} shape-mismatch={bad}")
    return out


def pore_variables_to_state_dict(variables: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """A pore detector's Flax variables (`{"params", "batch_stats"}` of numpy
    arrays, as `poredet.train.load_variables` reads them) -> state_dict of
    the port's `poredet.architectures` model of the same variant: conv
    kernels HWIO -> OIHW, BatchNorm scale / bias -> weight / bias, mean / var
    -> running statistics (the port's modules carry the Flax names, so the
    mapping is by path), `num_batches_tracked` 0."""
    out = flax_tree_to_state_dict(variables["params"],
                                  variables.get("batch_stats"))
    for k in [k for k in out if k.endswith(".running_mean")]:
        out[k[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.zeros((), dtype=torch.long)
    return out


def state_dict_to_pore_variables(state_dict: Mapping) -> Dict:
    """The inverse of `pore_variables_to_state_dict`: a pore detector's
    state_dict -> {"params": ..., "batch_stats": ...} nested by module, of
    float32 numpy arrays in Flax's layouts (conv weights OIHW -> kernels
    HWIO; a BatchNorm's weight / bias -> scale / bias, its running mean /
    var -> batch_stats mean / var; `num_batches_tracked` dropped), as the
    JAX package's `poredet.train.save_variables` takes them."""
    bn = {k[:-len(".running_mean")] for k in state_dict
          if k.endswith(".running_mean")}
    out: Dict = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        mod, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        # a copy: on the CPU .numpy() would share the live parameter
        arr = np.array(t.detach().cpu().float().numpy(), copy=True)
        if leaf in ("running_mean", "running_var"):
            tree, leaf = out["batch_stats"], leaf[len("running_"):]
        else:
            tree = out["params"]
            if leaf == "weight" and mod in bn:
                leaf = "scale"
            elif leaf == "weight":
                leaf = "kernel"
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for m in mod.split("."):
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
