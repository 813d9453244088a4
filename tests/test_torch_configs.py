"""The matcher's other backbones on the CPU, the port against the JAX
package: `backbone.kind` "vgg16" and "vgg16_bn" (`models/vgg.py`, full VGG16
widths on 32x48 images, node_feature_dim 1024 = the two 512-channel taps)
and "none" (precomputed keypoint features through `NoBackbone`), each
model's whole forward on a B = 3 batch (n1 == n2, n1 < n2, an impostor
n1 > n2), weights carried across by `convert.from_flax_variables`.

Bounds as test_torch_ngm's: every output key within 1e-4 (AFA-U's keys
1e-3), sk_tau 0.05 with damped AFA-U mixing and random BatchNorm
statistics, the greedy picks up to ties of the JAX ranking map
(test_torch_hyperedge._replay_jax_picks).
"""
import dataclasses

import numpy as np
import pytest
import torch

from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu_torch.convert import from_flax_variables
from fpmatch_tpu_torch.models.ngm import NGMNet, build_model
from fpmatch_tpu_torch.models.vgg import NoBackbone, VGG16Backbone
from test_torch_hyperedge import _jax_forward, _replay_jax_picks
from test_torch_ngm import _compare, _mixed_batch, _torch_batch
from test_torch_utils import (damp_afau_mixing, flax_init, np_tree,
                              randomize_batch_stats, tiny_jax_config,
                              to_torch_config)

FEATURES = 20           # width of the precomputed features of kind "none"


def _config(kind):
    cfg = tiny_jax_config(sk_tau=0.05)
    ngm = cfg.ngm
    if kind.startswith("vgg"):
        ngm = dataclasses.replace(ngm, node_feature_dim=1024)
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, kind=kind), ngm=ngm)


@pytest.mark.parametrize("kind", ["vgg16", "vgg16_bn", "none"])
def test_ngm_backbone_kinds_match_jax(kind, monkeypatch):
    jcfg = _config(kind)
    batch = _mixed_batch(jcfg, seed=3)
    if kind == "none":
        rng = np.random.default_rng(8)
        feats = rng.normal(size=batch.points.shape[:3] + (FEATURES,))
        batch = batch._replace(features=feats.astype(np.float32))
    v = np_tree(damp_afau_mixing(randomize_batch_stats(
        flax_init(JNet(jcfg), batch, train=False))))
    want = _jax_forward(jcfg, v, batch)
    tcfg = to_torch_config(jcfg)
    sd = from_flax_variables(v, tcfg)
    net = build_model(tcfg, device="cpu", state_dict=sd)
    if kind == "none":
        assert isinstance(net.backbone, NoBackbone)
        assert set(v["params"]["backbone"]) == {"proj", "global"}
        assert net.backbone.proj.in_features == FEATURES
    else:
        assert isinstance(net.backbone, VGG16Backbone)
        bns = [k for k in sd if k.startswith("backbone.bn")]
        assert bool(bns) == (kind == "vgg16_bn")
        assert len([k for k in sd if k.startswith("backbone.conv")
                    and k.endswith(".bias")]) == 13
    tb = _torch_batch(batch).to("cpu")
    _replay_jax_picks(monkeypatch, want)
    got = net(tb)
    _compare(want, got, 1e-4)
    if kind == "none":
        # the pathway reads the features, not the images
        monkeypatch.undo()
        blank = net(tb._replace(images=torch.zeros_like(tb.images)))
        assert torch.equal(blank["Kp"], got["Kp"])


def test_backbone_kinds_need_their_inputs():
    """Kind "none" needs the feature width (from the caller or from a
    state_dict); an unknown kind is refused as the JAX model refuses it."""
    tcfg = to_torch_config(_config("none"))
    with pytest.raises(ValueError, match="feature_dim"):
        NGMNet(tcfg)
    net = NGMNet(tcfg, feature_dim=7)
    assert net.backbone.proj.in_features == 7
    again = build_model(tcfg, device="cpu", state_dict=net.state_dict())
    assert again.backbone.proj.in_features == 7
    bad = dataclasses.replace(tcfg, backbone=dataclasses.replace(
        tcfg.backbone, kind="resnet50"))
    with pytest.raises(ValueError, match="unknown backbone kind"):
        NGMNet(bad)


@pytest.mark.parametrize("bn", [True, False])
def test_vgg16_bf16_backbone_matches_jax(rng, bn):
    """`--bf16`: bf16 convolutions with the bias added in bf16 after the
    rounded convolution, f32 BatchNorms (random statistics). The three
    outputs against the JAX module in bf16 (exact rounding,
    test_torch_bf16.compile_exact) within 2**-6 of their largest value:
    the taps bf16 (taken before the BatchNorm), the global feature f32 with
    BatchNorm and bf16 without, as the JAX module gives them."""
    import jax
    import jax.numpy as jnp

    from fpmatch_tpu.models.vgg import VGG16Backbone as JVGG
    from test_torch_bf16 import OP_BOUND, compile_exact, rel
    from test_torch_utils import load_into

    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    jm = JVGG(batch_norm=bn, dtype=jnp.bfloat16)
    v = randomize_batch_stats(jax.jit(jm.init)(jax.random.PRNGKey(2), x)) \
        if bn else np_tree(jax.jit(jm.init)(jax.random.PRNGKey(2), x))
    want = compile_exact(lambda v, x: jm.apply(v, x, train=False), v, x)
    net = load_into(VGG16Backbone(batch_norm=bn, dtype=torch.bfloat16),
                    v["params"], v.get("batch_stats"))
    (nodes,), edges, glob = net(torch.from_numpy(x))
    for got, w in zip((nodes, edges, glob), want):
        assert str(got.dtype).split(".")[-1] == str(w.dtype)
        assert tuple(got.shape) == w.shape
        assert rel(got.detach().float().numpy(), np.asarray(w, np.float32)) \
            <= OP_BOUND
