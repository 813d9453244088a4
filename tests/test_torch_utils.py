"""Shared helpers of the tests that hold the PyTorch port (fpmatch_tpu_torch)
against the JAX package (fpmatch_tpu) on the CPU: inputs are made with numpy
from a seed and handed to both; weights are initialised by Flax and carried
across with `fpmatch_tpu_torch.convert`."""
import copy
import dataclasses
import functools

import numpy as np
import torch

import jax

from fpmatch_tpu.core import config as jc
from fpmatch_tpu_torch.convert import flax_tree_to_state_dict
from fpmatch_tpu_torch.core import config as tc


def tiny_jax_config(n_max=12, e_max=64, univ=16, **ngm_kw):
    """`__graft_entry__._tiny_config`-sized model: micro ResNet (8/16 wide,
    1 block per stage), 32-wide graph features, few Sinkhorn iterations."""
    return jc.Config(
        shapes=jc.ShapeConfig(n_max=n_max, e_max=e_max, t_max=16,
                              univ_size=univ),
        backbone=jc.BackboneConfig(stem_channels=8,
                                   stage_channels=(8, 8, 16, 16),
                                   blocks_per_stage=1),
        ngm=dataclasses.replace(
            jc.NGMConfig(), node_feature_dim=32, global_state_dim=32,
            gnn_feat=(8, 8, 8), sk_iter=4, sk_layer_iter=4,
            topk_extra_iter=2, afa_reg_hidden=4, **ngm_kw))


def to_torch_config(cfg) -> tc.Config:
    """The port's Config with the same field values as a JAX-package one."""
    return tc.Config(
        shapes=tc.ShapeConfig(**dataclasses.asdict(cfg.shapes)),
        backbone=tc.BackboneConfig(**dataclasses.asdict(cfg.backbone)),
        ngm=tc.NGMConfig(**dataclasses.asdict(cfg.ngm)),
        data=tc.DataConfig(**dataclasses.asdict(cfg.data)))


def flax_init(module, *args, **kw):
    """`module.init(PRNGKey(0), *args, **kw)` under `jax.jit`: the same Flax
    init, compiled once instead of dispatched op by op (the eager init of
    the whole model takes a minute or more on the CPU)."""
    return jax.jit(functools.partial(module.init, **kw))(
        jax.random.PRNGKey(0), *args)


def shared_init(jcfg):
    """`flax_init(JNet(jcfg), batch, train=False)` as numpy trees, one
    jitted init per process for the configs that differ only in their
    shape buckets (n_max, e_max, t_max) or their temperature: Flax draws
    each parameter from the PRNG key folded with the module's path, so the
    values depend on the widths and options, not on those fields or on the
    batch (a parameter whose shape did would fail the converter's shape
    check). A fresh copy per call."""
    key = dataclasses.replace(
        jcfg, shapes=dataclasses.replace(jcfg.shapes, n_max=16, e_max=96,
                                         t_max=16),
        ngm=dataclasses.replace(jcfg.ngm, sk_tau=0.05))
    return copy.deepcopy(_shared_init(key))


@functools.cache
def _shared_init(jcfg):
    from fpmatch_tpu.data.synthetic import synthetic_pair_batch
    from fpmatch_tpu.models.ngm import NGMNet

    batch = synthetic_pair_batch(jcfg, 1, n_range=(8, 12),
                                 image_hw=(32, 48), seed=1)
    return np_tree(flax_init(NGMNet(jcfg), batch, train=False))


def tiny_widths(cfg):
    """A port Config (a CLI's) at tiny_jax_config's widths; its shapes,
    data settings, dtypes and model options (hyperedge, cls_k_features)
    kept."""
    tiny = to_torch_config(tiny_jax_config())
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(tiny.backbone,
                                          dtype=cfg.backbone.dtype),
        ngm=dataclasses.replace(tiny.ngm,
                                compute_dtype=cfg.ngm.compute_dtype,
                                hyperedge=cfg.ngm.hyperedge,
                                cls_k_features=cfg.ngm.cls_k_features))


def build_tiny(monkeypatch):
    """Make the port's CLIs build their model at tiny widths
    (`tiny_widths`); returns the list of (config, model, state_dict) of
    every model they build."""
    from fpmatch_tpu_torch.models import ngm as t_ngm

    seen = []
    real = t_ngm.build_model

    def build(cfg, *a, **k):
        cfg = tiny_widths(cfg)
        model = real(cfg, *a, **k)
        seen.append((cfg, model, k.get("state_dict")))
        return model

    monkeypatch.setattr(t_ngm, "build_model", build)
    return seen


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load_into(module, params, batch_stats=None):
    sd = flax_tree_to_state_dict(np_tree(params), np_tree(batch_stats or {}))
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    module.load_state_dict(sd)
    return module.eval()


def randomize_batch_stats(variables, seed=0):
    """Fresh Flax BatchNorm statistics are mean 0 / var 1, which would hide a
    swapped or dropped statistic: give every one a random value."""
    rng = np.random.default_rng(seed)
    v = np_tree(variables)

    def rnd(path, a):
        leaf = path[-1].key
        if leaf == "mean":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(rnd, v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def damp_afau_mixing(variables, factor=0.1):
    """The AFA-U score-mixing MLPs initialise to U(-10, 10): attention
    logits in the hundreds, i.e. a near-hard argmax whose winner flips on
    float32 rounding noise. Parity of the two implementations is a statement
    about the arithmetic, so the whole-model tests scale these four tensors
    down to a well-conditioned range (the isolated AFA-U test keeps them)."""
    v = np_tree(variables)
    for blk in ("row_block", "col_block"):
        mha = v["params"]["afau"][blk]["mha"]
        for k in list(mha):
            mha[k] = mha[k] * factor
    return v


def t2n(x):
    return x.detach().cpu().numpy()


def test_config_trees_have_the_same_fields_and_defaults():
    """The port keeps its own copy of the config tree; the converter, the
    CLIs and these tests rely on equal field names and defaults."""
    for name in ("ShapeConfig", "BackboneConfig", "NGMConfig", "DataConfig",
                 "StageConfig", "TrainConfig", "MeshConfig"):
        assert dataclasses.asdict(getattr(jc, name)()) == \
            dataclasses.asdict(getattr(tc, name)()), name
    assert dataclasses.asdict(jc.Config()) == dataclasses.asdict(tc.Config())
    cfg = tiny_jax_config(sk_tau=0.05)
    assert dataclasses.asdict(to_torch_config(cfg))["ngm"] == \
        dataclasses.asdict(cfg)["ngm"]
