"""AFA-U attention module predicting k (the number of true matches),
batch-native.

One bipartite cross-attention layer whose attention scores mix the q.k dot
products with the Sinkhorn cost matrix through a tiny per-head 2 -> 16 -> 1
MLP, followed by Add & InstanceNorm and a feed-forward block; row / column
embeddings are max-pooled over the valid nodes and fed to two small MLP heads
whose averaged logit gives k / min(n1, n2). Attention softmax and
instance-norm statistics are masked to valid nodes. Parameter names equal the
Flax modules'.

SimGNN's AFA-I parts (`TensorNetworkModule`, `DenseAttentionModule`) are
here too, as in the JAX package; the matcher does not use them.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.masking import NEG_INF, length_mask


def masked_instance_norm(x, mask, scale, bias, eps=1e-5):
    """InstanceNorm over the node axis with validity mask.
    x: (B, n, d); mask: (B, n)."""
    m = mask[..., None].to(x.dtype)
    cnt = torch.clamp(m.sum(dim=(1, 2), keepdim=True), min=1.0)
    mean = (x * m).sum(dim=1, keepdim=True) / cnt
    var = (((x - mean) ** 2) * m).sum(dim=1, keepdim=True) / cnt
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias) * m


class MixedScoreAttention(nn.Module):
    """Cross-set multi-head attention with per-head score mixing."""

    def __init__(self, head_num: int = 16, qkv_dim: int = 16,
                 ms_hidden: int = 16):
        super().__init__()
        self.qkv_dim = qkv_dim
        self.mix1_weight = nn.Parameter(torch.zeros(head_num, 2, ms_hidden))
        self.mix1_bias = nn.Parameter(torch.zeros(head_num, ms_hidden))
        self.mix2_weight = nn.Parameter(torch.zeros(head_num, ms_hidden, 1))
        self.mix2_bias = nn.Parameter(torch.zeros(head_num, 1))

    def forward(self, q, k, v, cost, col_mask):
        """q: (B, H, R, D), k/v: (B, H, C, D), cost: (B, R, C),
        col_mask: (B, C) -> (B, H, R, D)."""
        dot = torch.einsum("bhrd,bhcd->bhrc", q, k) / math.sqrt(
            float(self.qkv_dim))
        w1 = self.mix1_weight[None, :, None, None]        # (1, H, 1, 1, 2, M)
        ms1 = torch.relu(dot[..., None] * w1[..., 0, :]
                         + cost[:, None, :, :, None] * w1[..., 1, :]
                         + self.mix1_bias[None, :, None, None, :])
        ms2 = (torch.einsum("bhrcm,hm->bhrc", ms1, self.mix2_weight[..., 0])
               + self.mix2_bias[None, :, None, :])        # (B, H, R, C)
        cm = col_mask[:, None, None, :]
        ms2 = torch.where(cm, ms2, NEG_INF)
        w = torch.softmax(ms2, dim=-1)
        w = torch.where(cm, w, 0.0)
        return torch.einsum("bhrc,bhcd->bhrd", w, v)


class EncodingBlock(nn.Module):
    """One side of the bipartite encoder."""

    def __init__(self, embedding_dim: int = 600, head_num: int = 16,
                 qkv_dim: int = 16, ff_hidden: int = 256,
                 ms_hidden: int = 16):
        super().__init__()
        self.head_num, self.qkv_dim = head_num, qkv_dim
        hd = head_num * qkv_dim
        self.Wq = nn.Linear(embedding_dim, hd, bias=False)
        self.Wk = nn.Linear(embedding_dim, hd, bias=False)
        self.Wv = nn.Linear(embedding_dim, hd, bias=False)
        self.mha = MixedScoreAttention(head_num, qkv_dim, ms_hidden)
        self.combine = nn.Linear(hd, embedding_dim)
        self.norm1_scale = nn.Parameter(torch.ones(embedding_dim))
        self.norm1_bias = nn.Parameter(torch.zeros(embedding_dim))
        self.ff1 = nn.Linear(embedding_dim, ff_hidden)
        self.ff2 = nn.Linear(ff_hidden, embedding_dim)
        self.norm2_scale = nn.Parameter(torch.ones(embedding_dim))
        self.norm2_bias = nn.Parameter(torch.zeros(embedding_dim))

    def forward(self, row_emb, col_emb, cost, row_mask, col_mask):
        """row_emb: (B, R, D), col_emb: (B, C, D), cost: (B, R, C)."""
        B, h, d = row_emb.shape[0], self.head_num, self.qkv_dim

        def heads(x):
            return x.reshape(B, x.shape[1], h, d).transpose(1, 2)

        att = self.mha(heads(self.Wq(row_emb)), heads(self.Wk(col_emb)),
                       heads(self.Wv(col_emb)), cost, col_mask)
        att = att.transpose(1, 2).reshape(B, row_emb.shape[1], h * d)
        out1 = masked_instance_norm(row_emb + self.combine(att), row_mask,
                                    self.norm1_scale, self.norm1_bias)
        ff = self.ff2(torch.relu(self.ff1(out1)))
        return masked_instance_norm(out1 + ff, row_mask, self.norm2_scale,
                                    self.norm2_bias)


class AFAUEncoder(nn.Module):
    """Full AFA-U head: bipartite encoder + pooled k regressors.
    Returns k in [0, 1] per sample."""

    def __init__(self, univ_size: int = 600, reg_hidden: int = 8):
        super().__init__()
        self.univ_size = univ_size
        self.row_block = EncodingBlock(univ_size)
        self.col_block = EncodingBlock(univ_size)
        self.final_row_fc1 = nn.Linear(univ_size, reg_hidden)
        self.final_row_fc2 = nn.Linear(reg_hidden, 1)
        self.final_col_fc1 = nn.Linear(univ_size, reg_hidden)
        self.final_col_fc2 = nn.Linear(reg_hidden, 1)

    def forward(self, cost, n1, n2):
        """cost: (B, S1, S2) Sinkhorn output; n1, n2: (B,) -> (B,)."""
        B, s1, s2 = cost.shape
        row_mask = length_mask(n1, s1)
        col_mask = length_mask(n2, s2)
        # one-hot position init for columns (positions beyond univ_size get
        # a zero row), zeros for rows
        row_emb = torch.zeros((B, s1, self.univ_size), dtype=cost.dtype,
                              device=cost.device)
        eye = torch.zeros((s2, self.univ_size), dtype=cost.dtype,
                          device=cost.device)
        d = min(s2, self.univ_size)
        eye[:d, :d] = torch.eye(d, dtype=cost.dtype, device=cost.device)
        col_emb = eye[None] * col_mask[..., None].to(cost.dtype)

        row_out = self.row_block(row_emb, col_emb, cost, row_mask, col_mask)
        col_out = self.col_block(col_emb, row_emb, cost.transpose(1, 2),
                                 col_mask, row_mask)

        g_row = torch.where(row_mask[..., None], row_out, NEG_INF).amax(dim=1)
        g_col = torch.where(col_mask[..., None], col_out, NEG_INF).amax(dim=1)
        k_logit = 0.5 * (
            self.final_row_fc2(torch.relu(self.final_row_fc1(g_row)))
            + self.final_col_fc2(torch.relu(self.final_col_fc1(g_col))))
        return torch.sigmoid(k_logit[..., 0])


def _glorot_uniform_(w: torch.Tensor) -> torch.Tensor:
    """Flax's `glorot_uniform` (fan_in = shape[-2], fan_out = shape[-1],
    each times the product of the leading axes)."""
    rf = math.prod(w.shape[:-2])
    fan = (w.shape[-2] + w.shape[-1]) * rf
    bound = math.sqrt(6.0 / fan)
    with torch.no_grad():
        return w.uniform_(-bound, bound)


class TensorNetworkModule(nn.Module):
    """SimGNN tensor network: a similarity vector from two graph embeddings
    (reference afau.py:303-347; AFA-I component)."""

    def __init__(self, filters: int, tensor_neurons: int = 16):
        super().__init__()
        self.weight_matrix = nn.Parameter(_glorot_uniform_(
            torch.empty(filters, filters, tensor_neurons)))
        self.weight_matrix_block = nn.Parameter(_glorot_uniform_(
            torch.empty(tensor_neurons, 2 * filters)))
        self.bias = nn.Parameter(torch.zeros(tensor_neurons))

    def forward(self, emb1, emb2):
        """emb1 / emb2: (B, filters) graph-level embeddings ->
        (B, tensor_neurons)."""
        scoring = torch.einsum("bi,ijt,bj->bt", emb1, self.weight_matrix,
                               emb2)
        block = torch.cat([emb1, emb2], dim=-1) @ self.weight_matrix_block.T
        return torch.relu(scoring + block + self.bias)


class DenseAttentionModule(nn.Module):
    """SimGNN dense attention pooling to a graph-level embedding
    (reference afau.py:350-399)."""

    def __init__(self, filters: int):
        super().__init__()
        self.weight_matrix = nn.Parameter(_glorot_uniform_(
            torch.empty(filters, filters)))

    def forward(self, x, mask=None):
        """x: (B, N, filters); mask: (B, N) validity -> (B, filters). The
        mean is over the valid nodes, divided by max(count, 1)."""
        if mask is not None:
            m = mask.to(x.dtype)
            cnt = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
            mean = (x * m[..., None]).sum(1) / cnt
        else:
            mean = x.mean(1)
        g = torch.tanh(mean @ self.weight_matrix)
        koefs = torch.sigmoid(torch.einsum("bnf,bf->bn", x, g))
        w = koefs[..., None] * x
        if mask is not None:
            w = w * m[..., None]
        return w.sum(1)
