"""Patch-CNN pore detector architecture family as `nn.Module`s (NCHW).

The counterpart of the JAX package's `poredet/architectures.py`: 18 variants
built from LayerBlock = valid conv (no bias) -> ReLU -> BatchNorm [-> 3x3/1
max-pool] (reference template.py:3-27; ReLU before BatchNorm is the
reference's order):

  net{13,15,17,19}{max,nomax}    plain stacks sized for receptive fields
                                 13/15/17/19 px (e.g. net17nomax.py:5-33)
  resnet{13,15,17,19}{max,nomax} the same with centre-cropped residual adds
  gabriel                        small FCN with channel doubling + dropout
  su                             fully-convolutionalized FC net (su.py)

All are fully convolutional with valid padding: applied to a whole
fingerprint they give a shrunken probability map, which is how full-image
inference works. Input (B, 1, H, W) float in [0, 1], output (B, 1, H', W').

Children carry the Flax module names (`LayerBlock_{i}.Conv_0`,
`LayerBlock_{i}.BatchNorm_0`, the head `Conv_0`), so a Flax variable tree
maps onto the state_dict by path (`convert.pore_variables_to_state_dict`,
and back with `convert.state_dict_to_pore_variables`).

The mode is the module's (`model.train()` / `model.eval()`), where the JAX
package passes `train=`. Eval: BatchNorm reads its running statistics and
dropout is off. Train (patch training, `poredet.train`): BatchNorm has
`flax.linen.BatchNorm(momentum=0.9)`'s semantics (`models.backbone.
BatchNorm2d`: biased batch statistics normalize and move the running ones),
and gabriel's `Dropout(0.2)` keeps an activation with probability 0.8,
scaled by 1 / 0.8, drawn from the model's `dropout_generator` (a
`torch.Generator` on the activations' device; None: torch's default one).
`lecun_init_` draws the weights as Flax's default initialisers do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.backbone import BatchNorm2d

DROPOUT = 0.2          # gabriel's dropout rate


class LayerBlock(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 max_pool: bool = False):
        super().__init__()
        self.kernel, self.max_pool = kernel, max_pool
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x):
        x = self.BatchNorm_0(F.relu(self.Conv_0(x)), self.training)
        if self.max_pool:
            x = F.max_pool2d(x, self.kernel, stride=1)
        return x


def _blocks(module: nn.Module, widths, **kw):
    """Add LayerBlock_0..n-1 taking widths[i] -> widths[i + 1] channels."""
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        module.add_module(f"LayerBlock_{i}", LayerBlock(a, b, **kw))
    return len(widths) - 1


class PlainPoreNet(nn.Module):
    """net{N}{max,nomax}: (layers - 1) LayerBlocks + a 3x3 sigmoid conv
    head with bias."""

    def __init__(self, features: int = 40, num_layers: int = 8,
                 max_pool: bool = False):
        super().__init__()
        self.n_blocks = _blocks(self, [1] + [features] * (num_layers - 1),
                                max_pool=max_pool)
        self.Conv_0 = nn.Conv2d(features, 1, 3)

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"LayerBlock_{i}")(x)
        return torch.sigmoid(self.Conv_0(x))


class ResPoreNet(nn.Module):
    """resnet{N}{max,nomax}: LayerBlocks with centre-cropped residual adds."""

    def __init__(self, features: int = 40, num_layers: int = 8,
                 max_pool: bool = False):
        super().__init__()
        self.crop = 2 if max_pool else 1
        self.n_blocks = _blocks(self, [1] + [features] * (num_layers - 1),
                                max_pool=max_pool)
        self.Conv_0 = nn.Conv2d(features, 1, 3)

    def forward(self, x):
        x = self.LayerBlock_0(x)
        c = self.crop
        for i in range(1, self.n_blocks):
            y = getattr(self, f"LayerBlock_{i}")(x)
            x = x[:, :, c:-c, c:-c] + y
        return torch.sigmoid(self.Conv_0(x))


class GabrielNet(nn.Module):
    """Small FCN (gabriel.py): 3 pooled blocks, dropout (train mode only),
    a 5x5 head with bias, BatchNorm after the head."""

    dropout_generator = None

    def __init__(self, features: int = 40):
        super().__init__()
        f = features
        self.n_blocks = _blocks(self, [1, f, 2 * f, 4 * f], max_pool=True)
        self.Conv_0 = nn.Conv2d(4 * f, 1, 5)
        self.BatchNorm_0 = BatchNorm2d(1)

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"LayerBlock_{i}")(x)
        if self.training:
            keep = torch.rand(x.shape, generator=self.dropout_generator,
                              device=x.device) < 1.0 - DROPOUT
            x = torch.where(keep, x / (1.0 - DROPOUT), 0.0)
        return torch.sigmoid(self.BatchNorm_0(self.Conv_0(x), self.training))


class SuNet(nn.Module):
    """Su et al. 2017 fully-convolutionalized net (su.py:21-50): widths
    64, 64, 128, 128, 256, 256, 512, then 4096 and a 1x1 last block."""

    def __init__(self):
        super().__init__()
        widths = [1] + [2 ** ((i + 1) // 2 + 5) for i in range(1, 8)] + [4096]
        n = _blocks(self, widths)
        self.add_module(f"LayerBlock_{n}", LayerBlock(4096, 1, kernel=1))
        self.n_blocks = n + 1

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"LayerBlock_{i}")(x)
        return torch.sigmoid(x)


# receptive field -> number of layers for the plain / residual stacks
_RF_TO_LAYERS = {13: 6, 15: 7, 17: 8, 19: 9}

ARCHITECTURES = (
    [f"net{rf}{suffix}" for rf in (13, 15, 17, 19)
     for suffix in ("max", "nomax")]
    + [f"resnet{rf}{suffix}" for rf in (13, 15, 17, 19)
       for suffix in ("max", "nomax")]
    + ["gabriel", "su"]
)


def make_architecture(name: str, features: int = 40) -> nn.Module:
    """Factory over all 18 variants (reference util/utils.py:68-114), in
    eval mode."""
    name = name.lower()
    if name == "gabriel":
        return GabrielNet(features=features).eval()
    if name == "su":
        return SuNet().eval()
    residual = name.startswith("resnet")
    body = name.removeprefix("resnet" if residual else "net")
    max_pool = body.endswith("max") and not body.endswith("nomax")
    rf = int(body.removesuffix("nomax" if body.endswith("nomax") else "max"))
    if rf not in _RF_TO_LAYERS:
        raise ValueError(f"unknown architecture {name}")
    cls = ResPoreNet if residual else PlainPoreNet
    return cls(features=features, num_layers=_RF_TO_LAYERS[rf],
               max_pool=max_pool).eval()


@torch.no_grad()
def lecun_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisers, drawn from `generator` (on the CPU; the
    weights are then copied to the model's device): conv kernels LeCun
    normal (a normal of std sqrt(1 / fan_in) / 0.8796 truncated at two of
    its std, fan_in = in_channels * kh * kw), zero biases, BatchNorm scale 1
    and bias 0 with running mean 0 and variance 1. Returns the model."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            w = torch.empty(m.weight.shape)
            # the std of a standard normal truncated to [-2, 2]
            std = math.sqrt(1.0 / m.weight[0].numel()) / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def receptive_field(name: str) -> int:
    name = name.lower()
    if name in ("gabriel", "su"):
        return 17
    body = name.removeprefix("resnet" if name.startswith("resnet") else "net")
    return int(body.removesuffix("nomax" if body.endswith("nomax") else "max"))
