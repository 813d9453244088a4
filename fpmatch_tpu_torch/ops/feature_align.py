"""Bilinear feature alignment (point sampling of a feature map), batch-native.

Mapping (the JAX package's, deliberately not the original research code's):
x is scaled by W_f / W, y by H_f / H, half-pixel aligned.
"""
from __future__ import annotations

import torch


def feature_align(feat: torch.Tensor, points: torch.Tensor,
                  ori_size: tuple) -> torch.Tensor:
    """Sample feature vectors at keypoint locations.

    :param feat: (B, H_f, W_f, C) channels-last feature maps
    :param points: (B, N, 2) xy keypoint coordinates in original-image pixels
    :param ori_size: (W, H) of the original image
    :return: (B, N, C) sampled features (padded points sample at (0, 0);
             callers mask downstream)
    """
    B, h_f, w_f, C = feat.shape
    w, h = ori_size
    # half-pixel centres: original pixel p maps to feature coord (p - s/2)/s
    sx = w / w_f
    sy = h / h_f
    x = (points[..., 0] - sx / 2.0) / sx
    y = (points[..., 1] - sy / 2.0) / sy

    x0 = torch.clamp(torch.floor(x), 0, w_f - 1)
    y0 = torch.clamp(torch.floor(y), 0, h_f - 1)
    x1 = torch.clamp(x0 + 1, 0, w_f - 1)
    y1 = torch.clamp(y0 + 1, 0, h_f - 1)

    flat = feat.reshape(B, h_f * w_f, C)

    def take(yi, xi):
        idx = (yi.long() * w_f + xi.long())[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    Ia, Ib, Ic, Id = take(y0, x0), take(y1, x0), take(y0, x1), take(y1, x1)

    xc = torch.clamp(x, 0.0, w_f - 1.0)
    yc = torch.clamp(y, 0.0, h_f - 1.0)
    wx1 = xc - x0
    wy1 = yc - y0
    wa = ((1 - wx1) * (1 - wy1))[..., None].to(feat.dtype)
    wb = ((1 - wx1) * wy1)[..., None].to(feat.dtype)
    wc = (wx1 * (1 - wy1))[..., None].to(feat.dtype)
    wd = (wx1 * wy1)[..., None].to(feat.dtype)
    return Ia * wa + Ib * wb + Ic * wc + Id * wd


def normalize_over_channels(x: torch.Tensor, dim: int = -1,
                            eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the channel axis."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)
