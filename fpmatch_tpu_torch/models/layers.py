"""Matcher building blocks: spline message passing, affinity layer,
association-graph GNN layers, match classifier — batch-native nn.Modules on
(B, N1, N2, C)-shaped association features.

Parameter and child names equal the Flax modules' (the weight converter
carries them across by name). BatchNorm takes its mode per call (`train`),
as the Flax modules do; the embedded Sinkhorn is recomputed in the backward
(`torch.utils.checkpoint`), as the Flax layers' `remat_sk` does.

Mixed precision (`--bf16`) follows the Flax modules' explicit casts, not an
autocast: parameters stay float32, and a layer built with `dtype=bf16` casts
its input and parameters at use (`dense`, Flax's `nn.Dense(dtype=)`).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.assoc import (assoc_aggregate_mean, assoc_tri_degree,
                         assoc_tri_matvec)
from ..ops.sinkhorn import sinkhorn_batch
from ..ops.spline import spline_conv
from .backbone import batch_stats


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`flax.linen.Dense(dtype=dtype)` over the float32 parameters of
    `layer`: the input, the kernel and the bias are cast to `dtype` and the
    result is in it (bf16: the product rounded, then the bias added in bf16,
    as Flax's `dot_general` then `y + bias`). float32: the layer as it is,
    on a float32 input."""
    if dtype == torch.float32:
        return layer(x.float())
    y = nn.functional.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class SplineNet(nn.Module):
    """`num_layers` SplineConv layers (dim=2, kernel 5, max aggregation) with
    a 0.1 residual blend."""

    def __init__(self, features: int = 768, kernel_size: int = 5,
                 num_layers: int = 2):
        super().__init__()
        self.features, self.kernel_size = features, kernel_size
        self.num_layers = num_layers
        k_total = kernel_size ** 2
        for i in range(num_layers):
            self.register_parameter(f"conv{i}_weight", nn.Parameter(
                torch.zeros(k_total, features, features)))
            self.register_parameter(f"conv{i}_root", nn.Parameter(
                torch.zeros(features, features)))
            self.register_parameter(f"conv{i}_bias", nn.Parameter(
                torch.zeros(features)))

    def forward(self, x, src, dst, edge_attr, edge_mask, node_mask):
        """x: (G, N, F), float32 or bf16 (the convolutions run in x's dtype,
        their parameters cast at use); returns x + 0.1 * SConv(x), masked."""
        h = x
        for i in range(self.num_layers):
            h = spline_conv(h, src, dst, edge_attr,
                            getattr(self, f"conv{i}_weight"),
                            getattr(self, f"conv{i}_root"),
                            getattr(self, f"conv{i}_bias"),
                            edge_mask, node_mask,
                            kernel_size=self.kernel_size)
            if i < self.num_layers - 1:
                h = torch.relu(h)
        return (x + 0.1 * h) * node_mask[..., None].to(x.dtype)


class InnerProductAffinity(nn.Module):
    """Global-feature-gated inner-product affinity
    `softplus(X diag(tanh(A w)) Y^T) - 0.5`; output f32. With bf16 X / Y the
    gated X is rounded to bf16 and the product is formed in f32 from the
    bf16 operands, never rounded to bf16 (the Flax einsum's
    `preferred_element_type=f32`; bf16 x bf16 products are exact in f32, so
    on the card this needs TF32 matmul off, torch's default)."""

    def __init__(self, dim: int, global_dim: int):
        super().__init__()
        self.A = nn.Linear(global_dim, dim)

    def forward(self, X, Y, weights, mask=None):
        """X: (B, n1, d), Y: (B, n2, d), weights: (B, gdim)."""
        coeff = torch.tanh(self.A(weights))
        res = torch.einsum("bid,bjd->bij",
                           (X * coeff[:, None, :].to(X.dtype)).float(),
                           Y.float())
        res = nn.functional.softplus(res) - 0.5
        if mask is not None:
            res = res * mask
        return res


def remat(fn, *args):
    """fn(*args), recomputed in the backward instead of keeping its
    intermediates (`jax.checkpoint`'s counterpart; the numbers are the
    same) when a gradient is wanted; plain fn(*args) otherwise."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class AssocGNNLayerBatched(nn.Module):
    """One association-graph convolution whose sparse mean aggregation
    (K^T vec(X) / rownnz) is computed by the CALLER: the UNIV serving route
    feeds the CUDA kernel's result here. lin_l(agg) + lin_r(X) + a 2-layer
    self MLP, plus the embedded-Sinkhorn channel. `dtype` is the compute
    dtype: with bf16 the input is cast to it, every Dense runs in it
    (`dense`) and the output is bf16; the Sinkhorn channel always runs in
    f32 and is cast back."""

    def __init__(self, in_features: int, out_features: int = 16,
                 sk_channel: int = 1, sk_iter: int = 20,
                 sk_tau: float = 0.05, dtype: torch.dtype = torch.float32,
                 hyperedge: bool = False):
        super().__init__()
        self.sk_channel, self.sk_iter, self.sk_tau = sk_channel, sk_iter, \
            sk_tau
        self.dtype = dtype
        self.lin_l = nn.Linear(in_features, out_features)
        self.lin_r = nn.Linear(in_features, out_features, bias=False)
        if hyperedge:
            self.lin_t = nn.Linear(in_features, out_features, bias=False)
        self.self0 = nn.Linear(in_features, out_features)
        self.self1 = nn.Linear(out_features, out_features)
        if sk_channel:
            self.classifier = nn.Linear(out_features, sk_channel)

    def forward(self, X, agg, kp_present, n1, n2, tagg=None):
        """X, agg: (B, N1, N2, C_in); kp_present: (B, N1, N2); n1, n2: (B,).
        `tagg` (hyperedge layers): the mean-aggregated triangle term, added
        through `lin_t` after lin_l + lin_r."""
        cdt = self.dtype
        Xc = X.to(cdt)
        x1 = dense(self.lin_l, agg, cdt) + dense(self.lin_r, Xc, cdt)
        if tagg is not None:
            x1 = x1 + dense(self.lin_t, tagg, cdt)
        h = torch.relu(dense(self.self1,
                             torch.relu(dense(self.self0, Xc, cdt)), cdt))
        x1 = x1 + h
        if self.sk_channel:
            sk_in = dense(self.classifier, x1, cdt)

            def sk_fn(x):
                return sinkhorn_batch(x, n1, n2, tau=self.sk_tau,
                                      max_iter=self.sk_iter, dummy_row=True)

            chans = [remat(sk_fn, sk_in[..., c].float())
                     for c in range(self.sk_channel)]
            x1 = torch.cat([x1, torch.stack(chans, dim=-1).to(x1.dtype)],
                           dim=-1)
        return x1 * kp_present[..., None].to(x1.dtype)


class AssocGNNLayer(AssocGNNLayerBatched):
    """The bucket-scale layer: computes the factorized mean aggregation over
    K^T itself (`ops.assoc.assoc_aggregate_mean`: the K2 / K3 kernels on a
    CUDA tensor, the plain ops on a CPU one) from X in the compute dtype (its
    result is f32). Same parameters as `AssocGNNLayerBatched`."""

    def forward(self, X, Kp, Ke, g1_src, g1_dst, g2_src, g2_dst, kp_present,
                e1_mask, e2_mask, n1, n2, Kt=None, tri1=None, tri2=None,
                t1_mask=None, t2_mask=None):
        """With `Kt` (B, T1, T2) and the triangle lists / masks (hyperedge
        layers), the triangle term `assoc_tri_matvec(X, Kt, ...) / max(tdeg,
        1)` is computed from X as it comes in (f32 in the first layer, the
        compute dtype after it), not from its compute-dtype copy."""
        Xc = X.to(self.dtype)
        agg = assoc_aggregate_mean(Xc, Kp, Ke, g1_src, g1_dst, g2_src, g2_dst,
                                   kp_present, e1_mask, e2_mask,
                                   transpose=True)
        tagg = None
        if Kt is not None:
            tdeg = assoc_tri_degree(t1_mask, t2_mask, tri1, tri2,
                                    X.shape[1], X.shape[2])
            tagg = assoc_tri_matvec(X, Kt, tri1, tri2) \
                / torch.clamp(tdeg, min=1.0)[..., None]
        return super().forward(Xc, agg, kp_present, n1, n2, tagg)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (B, C, H, W) whose train-mode statistics are computed
    over the valid region only (`mask` (B, 1, H, W) in {0, 1}), so training
    normalization does not depend on the padding bucket. `train=True`:
    the biased masked statistics normalize and the running statistics move to
    `0.9 old + 0.1 batch`; `train=False`: the running statistics, which do
    not look at the mask. With `group` (a rank grid's data group, set by
    `NGMNet`) the masked statistics are those of the global batch
    (`backbone.batch_stats`)."""

    group = None

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, mask=None, train: bool = False):
        shp = (1, -1, 1, 1)
        if train:
            if self.group is None:
                cnt = torch.clamp(mask.sum(), min=1.0)
                mean = (x * mask).sum(dim=(0, 2, 3)) / cnt
                var = (torch.square(x - mean.reshape(shp)) * mask
                       ).sum(dim=(0, 2, 3)) / cnt
            else:
                mean, var = batch_stats(x, mask, self.group)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(shp)) * torch.rsqrt(var.reshape(shp) + self.eps)
        return y * self.weight.reshape(shp) + self.bias.reshape(shp)


class MatchClassifier(nn.Module):
    """Genuine/impostor classifier: a small CNN over the masked match map
    with masked pooling, so logits do not depend on the padding bucket."""

    def __init__(self, channels: Tuple[int, ...] = (16, 32),
                 extra_features: int = 0):
        super().__init__()
        self.channels = tuple(channels)
        prev = 1
        for i, ch in enumerate(self.channels):
            self.add_module(f"conv{i}", nn.Conv2d(prev, ch, 3, padding=1))
            self.add_module(f"bn{i}", MaskedBatchNorm(ch))
            prev = ch
        self.fc = nn.Linear(prev + extra_features, 1)

    @staticmethod
    def _level_mask(h, w, shift, n1, n2, dtype):
        """(B, 1, h, w) validity of a map downscaled by 2**shift: ceil(n /
        2**shift) rows / columns per sample."""
        rows = torch.arange(h, device=n1.device)[None, :, None]
        cols = torch.arange(w, device=n1.device)[None, None, :]
        d = 1 << shift
        vr = torch.ceil(n1 / d).to(torch.int32)[:, None, None]
        vc = torch.ceil(n2 / d).to(torch.int32)[:, None, None]
        return ((rows < vr) & (cols < vc)).to(dtype)[:, None]

    def forward(self, match_mat, n1, n2, train: bool = False,
                extra_features=None):
        """match_mat: (B, S1, S2); n1, n2: (B,) valid counts -> (B,) logits.
        `train`: BatchNorm in train mode (masked batch statistics).
        `extra_features` (B, F), F the constructor's `extra_features`:
        scalars appended to the pooled vector before `fc` (the model's
        `cls_k_features` statistics)."""
        x = match_mat[:, None]
        for i in range(len(self.channels)):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            m = self._level_mask(x.shape[2], x.shape[3], i, n1, n2, x.dtype)
            # zero the invalid region: it would carry bias/BN constants whose
            # interaction with the conv's zero padding depends on the bucket
            x = getattr(self, f"bn{i}")(x, m, train) * m
            x = nn.functional.max_pool2d(x, 2, stride=2)
        m = self._level_mask(x.shape[2], x.shape[3], len(self.channels), n1,
                             n2, x.dtype)
        pooled = (x * m).sum(dim=(2, 3)) / torch.clamp(m.sum(dim=(2, 3)),
                                                       min=1.0)
        if extra_features is not None:
            pooled = torch.cat([pooled, extra_features], dim=-1)
        return self.fc(pooled)[..., 0]


class BilinearAffinity(nn.Module):
    """Bilinear affinity M = X A_s Y^T with A_s = (A + A^T) / 2 of a
    learnable square A initialized at the identity (reference
    src/model/pca_affinity.py:8-32, the PCA-GM affinity; a library layer,
    not wired into NGMNet)."""

    def __init__(self, dim: int):
        super().__init__()
        self.A = nn.Parameter(torch.eye(dim))

    def forward(self, X, Y, mask=None):
        """X (..., N1, D), Y (..., N2, D) -> (..., N1, N2), times `mask`
        where given."""
        res = torch.einsum("...id,de,...je->...ij", X,
                           (self.A + self.A.T) / 2, Y)
        return res if mask is None else res * mask


class DenseAssocGNNLayer(nn.Module):
    """Dense-K association convolution (reference GNNLayer, gnn.py:11-87):
    the row-normalized adjacency of K's nonzeros, times K, applied to a
    two-layer node transform, plus a two-layer self transform; for problems
    small enough to materialize K (`ops.assoc.assoc_dense`). A library
    alternative to `AssocGNNLayer`."""

    def __init__(self, in_features: int, out_features: int = 16):
        super().__init__()
        self.n_fc0 = nn.Linear(in_features, out_features)
        self.n_fc1 = nn.Linear(out_features, out_features)
        self.self0 = nn.Linear(in_features, out_features)
        self.self1 = nn.Linear(out_features, out_features)

    def forward(self, K, X, mask):
        """K (..., M, M) dense affinity; X (..., M, C); mask (..., M) of the
        valid association nodes -> (..., M, out_features)."""
        m = mask.to(K.dtype)
        A = (K > 0).to(K.dtype) * m[..., None, :] * m[..., :, None]
        A = A / torch.clamp(A.sum(dim=-1, keepdim=True), min=1.0)
        x1 = torch.relu(self.n_fc1(torch.relu(self.n_fc0(X))))
        h = torch.relu(self.self1(torch.relu(self.self0(X))))
        return ((A * K) @ x1 + h) * m[..., None]
