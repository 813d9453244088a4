"""ResNet-18 backbone split into the three chunks the matcher consumes:

  node feature maps — one per tap (default layer3: stride 16, 256 channels)
  edge feature map  — layer4 output, stride 32, 512 channels
  global feature    — global max-pool of layer4, 512-d

Own implementation (no torchvision). Inside, tensors are NCHW as PyTorch's
convolutions want them; the public boundary is channels-last like the JAX
package's, so one numpy batch feeds both: images come in as (B, H, W, 3) and
feature maps go out as (B, H_f, W_f, C). Child names equal the Flax module's
(conv1, bn1, layer{i}_{b}, downsample_conv, downsample_bn), which is what the
weight converter relies on. BatchNorm runs in either mode, chosen per call
(`forward(x, train)`, as the Flax module's argument): running statistics, or
Flax's train mode (see `BatchNorm2d`).

`dtype` is the Flax module's compute dtype: with bf16 every convolution
casts its input and its f32 kernel to bf16 and gives bf16 (`conv`), while
every BatchNorm works and gives f32 (Flax's `BatchNorm(dtype=float32)`), so
the ReLUs, the residual sums, the max-pool and the three outputs are f32.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def conv(layer: nn.Conv2d, x: torch.Tensor,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`flax.linen.Conv(dtype=dtype)` over the f32 parameters of `layer`:
    input, kernel and bias cast to `dtype`, the result in it (bf16: the
    convolution rounded, then the bias added in bf16, as Flax adds it)."""
    if dtype == torch.float32:
        return layer(x)
    y = nn.functional.conv2d(x.to(dtype), layer.weight.to(dtype), None,
                             layer.stride, layer.padding)
    if layer.bias is None:
        return y
    return y + layer.bias.to(dtype).reshape(1, -1, 1, 1)


def batch_stats(x, mask, group):
    """Biased per-channel (mean, var) of x (B, C, H, W) over the cells
    where `mask` (B, 1, H, W; None: everywhere) is 1, taken over the batch
    slices of all ranks of `group`: the count, the sum and then the
    centered sum of squares are summed over the group, with a gradient
    through each sum (`parallel.distributed.all_reduce_sum`)."""
    from ..parallel.distributed import all_reduce_sum

    m = torch.ones_like(x[:, :1]) if mask is None else mask
    cnt = torch.clamp(all_reduce_sum((m * torch.ones_like(x)).sum(
        dim=(0, 2, 3)), group), min=1.0)
    mean = all_reduce_sum((x * m).sum(dim=(0, 2, 3)), group) / cnt
    dev = torch.square(x - mean.reshape(1, -1, 1, 1)) * m
    var = all_reduce_sum(dev.sum(dim=(0, 2, 3)), group) / cnt
    return mean, var


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with `flax.linen.BatchNorm`'s semantics (momentum 0.9, eps
    1e-5), the mode given per call, on a float32 copy of its input (its
    output is float32 whatever the input's dtype). `train=False`: the running statistics.
    `train=True`: the biased batch statistics normalize, and the running
    statistics move to `0.9 old + 0.1 batch` with the BIASED batch variance
    (`nn.BatchNorm2d` would fold in the unbiased one, drifting from the JAX
    package by n / (n - 1) every step). Same parameters and buffers as
    `nn.BatchNorm2d`, so state_dicts are unchanged.

    `group` (set by `NGMNet` under a rank grid: its data group): train-mode
    statistics are those of the global batch, the batch slices of the
    group's ranks together (`batch_stats`), as under the JAX package's
    GSPMD-sharded batch."""

    group = None

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x, train: bool = False):
        x = x.float()
        if not train:
            return nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        if self.group is None:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = batch_stats(x, None, self.group)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        shp = (1, -1, 1, 1)
        y = (x - mean.reshape(shp)) * torch.rsqrt(var.reshape(shp) + self.eps)
        return y * self.weight.reshape(shp) + self.bias.reshape(shp)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(channels)
        self.has_downsample = in_channels != channels or stride != 1
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_channels, channels, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = BatchNorm2d(channels)

    def forward(self, x, train: bool = False):
        dt = self.dtype
        y = torch.relu(self.bn1(conv(self.conv1, x, dt), train))
        y = self.bn2(conv(self.conv2, y, dt), train)
        if self.has_downsample:
            x = self.downsample_bn(conv(self.downsample_conv, x, dt), train)
        return torch.relu(y + x)


class ResNet18Backbone(nn.Module):
    """Truncated ResNet-18 with the matcher's output taps. `node_taps`
    selects the stages that contribute node features."""

    def __init__(self, node_taps: Tuple[str, ...] = ("layer3",),
                 stem_channels: int = 64,
                 stage_channels: Tuple[int, int, int, int] = (64, 128, 256,
                                                              512),
                 blocks_per_stage: int = 2, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.node_taps = tuple(node_taps)
        self.blocks_per_stage = blocks_per_stage
        self.conv1 = nn.Conv2d(in_channels, stem_channels, 7, stride=2,
                               padding=3, bias=False)
        self.bn1 = BatchNorm2d(stem_channels)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        prev = stem_channels
        for i, ch in enumerate(stage_channels):
            stride = 1 if i == 0 else 2
            for b in range(blocks_per_stage):
                self.add_module(f"layer{i + 1}_{b}",
                                BasicBlock(prev, ch, stride if b == 0 else 1,
                                           dtype))
                prev = ch

    def forward(self, x: torch.Tensor, train: bool = False):
        """:param x: (B, H, W, 3) normalized images, channels-last (float32,
            or already cast to the compute dtype)
        :param train: BatchNorm in train mode (batch statistics)
        :return: (tuple of node feature maps (B, H_f, W_f, C), one per tap;
                  edge map (B, H/32, W/32, C4); global feature (B, C4))"""
        y = x.permute(0, 3, 1, 2)
        if y.device.type == "cpu":
            # NCHW in memory on the CPU: the CPU build's backward of a 1x1
            # stride-2 convolution (the downsample) over a channels-last
            # input corrupts the heap at narrow widths (8 -> 16 channels)
            y = y.contiguous()
        y = self.pool(torch.relu(self.bn1(conv(self.conv1, y, self.dtype),
                                          train)))
        taps = {}
        for i in range(4):
            for b in range(self.blocks_per_stage):
                y = getattr(self, f"layer{i + 1}_{b}")(y, train)
            taps[f"layer{i + 1}"] = y
        edges = taps["layer4"]
        global_feat = edges.amax(dim=(2, 3))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return (tuple(nhwc(taps[t]) for t in self.node_taps), nhwc(edges),
                global_feat)


def load_torch_resnet18(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision-layout ResNet-18 `state_dict` (`conv1.weight`,
    `bn1.*`, `layerX.Y.{conv,bn}{1,2}.*`, `layerX.Y.downsample.{0,1}.*`;
    the classifier `fc.*` is dropped) -> a `state_dict` of
    `ResNet18Backbone` at the default widths (`layerX_Y.downsample_conv` /
    `downsample_bn`), the counterpart of the JAX package's converter into
    Flax trees. Convolutions stay OIHW; `num_batches_tracked` is taken
    where the input has it, else 0. Imports no torchvision: the caller
    loads the file."""
    def t(k):                       # a copy, from a tensor or an array
        return torch.tensor(np.asarray(state_dict[k]))

    out: Dict[str, torch.Tensor] = {}

    def bn(src, dst):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = t(f"{src}.{leaf}").float()
        nbt = f"{src}.num_batches_tracked"
        out[f"{dst}.num_batches_tracked"] = (
            t(nbt).long() if nbt in state_dict
            else torch.zeros((), dtype=torch.long))

    out["conv1.weight"] = t("conv1.weight").float()
    bn("bn1", "bn1")
    for layer in range(1, 5):
        for blk in range(2):
            src, dst = f"layer{layer}.{blk}", f"layer{layer}_{blk}"
            for i in (1, 2):
                out[f"{dst}.conv{i}.weight"] = \
                    t(f"{src}.conv{i}.weight").float()
                bn(f"{src}.bn{i}", f"{dst}.bn{i}")
            if f"{src}.downsample.0.weight" in state_dict:
                out[f"{dst}.downsample_conv.weight"] = \
                    t(f"{src}.downsample.0.weight").float()
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
    return out
