"""VGG16 backbones (with and without BatchNorm) and the non-image pathway
`NoBackbone`, the counterparts of the JAX package's `models/vgg.py`.

`VGG16Backbone` has the matcher's taps: node features at the third
convolution of stage 4 (stride 8, 512 channels), edge features at the second
convolution of stage 5 (stride 16, 512 channels), both taken before that
convolution's BatchNorm and ReLU, and the global feature as the max over the
last map. Child names equal the Flax module's (`conv{s}_{c}`, `bn{s}_{c}`),
which is what the weight converter relies on. As `models/backbone.py`: NCHW
inside, channels-last at the boundary; `dtype` is the Flax module's compute
dtype (bf16 convolutions, f32 BatchNorms).

`NoBackbone` takes precomputed per-keypoint features (B, N, F) instead of
images: a Dense projection to the node features and a masked max-pool,
projected, as the global feature.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .backbone import BatchNorm2d, conv

# (channels, convolutions) per stage
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Backbone(nn.Module):
    OUT_CHANNELS = VGG_STAGES[-1][0]    # of the edge map and the global

    def __init__(self, batch_norm: bool = True, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.batch_norm, self.dtype = batch_norm, dtype
        prev = in_channels
        for si, (ch, n_convs) in enumerate(VGG_STAGES):
            for ci in range(n_convs):
                tag = f"{si + 1}_{ci + 1}"
                self.add_module(f"conv{tag}",
                                nn.Conv2d(prev, ch, 3, padding=1))
                if batch_norm:
                    self.add_module(f"bn{tag}", BatchNorm2d(ch))
                prev = ch

    def forward(self, x: torch.Tensor, train: bool = False):
        """:param x: (B, H, W, 3) normalized images, channels-last
        :param train: BatchNorm in train mode (batch statistics)
        :return: ((node map (B, H/8, W/8, 512),), edge map (B, H/16, W/16,
                  512), global feature (B, 512))"""
        y = x.permute(0, 3, 1, 2)
        if y.device.type == "cpu":
            y = y.contiguous()
        nodes = edges = None
        for si, (_, n_convs) in enumerate(VGG_STAGES):
            for ci in range(n_convs):
                tag = f"{si + 1}_{ci + 1}"
                y = conv(getattr(self, f"conv{tag}"), y, self.dtype)
                if (si, ci) == (3, 2):
                    nodes = y
                if (si, ci) == (4, 1):
                    edges = y
                if self.batch_norm:
                    y = getattr(self, f"bn{tag}")(y, train)
                y = torch.relu(y)
            if si < len(VGG_STAGES) - 1:
                y = nn.functional.max_pool2d(y, 2, stride=2)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return (nhwc(nodes),), nhwc(edges), y.amax(dim=(2, 3))


class NoBackbone(nn.Module):
    """Node features = Dense(`out_dim`) of the precomputed features, masked;
    global = Dense(`global_dim`) of their masked max over the valid
    keypoints (0 where a graph has none)."""

    def __init__(self, in_features: int, out_dim: int = 768,
                 global_dim: int = 512):
        super().__init__()
        self.proj = nn.Linear(in_features, out_dim)
        # `global` is a Python keyword: the child is reached by getattr
        self.add_module("global", nn.Linear(out_dim, global_dim))

    def forward(self, feats: torch.Tensor, node_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:param feats: (G, N, F) float32; node_mask: (G, N) float
        :return: node features (G, N, out_dim), global (G, global_dim)"""
        x = self.proj(feats) * node_mask[..., None]
        neg = torch.where(node_mask[..., None] > 0, x, -torch.inf)
        pooled = neg.amax(dim=1)
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
        return x, getattr(self, "global")(pooled)
