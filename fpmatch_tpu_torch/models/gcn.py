"""Alternative graph-convolution layers (the JAX package's `models/gcn.py`;
reference src/model/gcn.py: Gconv, ChannelIndependentConv (CIE, ICLR'20)
and the Siamese wrapper; library layers that NGMNet does not wire).
Batch-native on padded edge lists: x (B, N, F), src / dst (B, E) with padded
slots aliasing node 0, edge_mask (B, E), node_mask (B, N).

The segment sums over `dst` are products with one-hot matrices, whose
order of summation is fixed (no atomics on a CUDA tensor), so the card and
the CPU sum alike. Children carry the Flax names (`a_fc`, `u_fc`,
`node_fc`, `node_sfc`, `edge_fc`, `gconv`); `convert.flax_tree_to_state_dict`
carries Flax weights across.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def _segment_mean(msg, dst, edge_mask, n: int):
    """sum over edges of msg (B, E, F) into their dst node, divided by the
    node's count of real in-edges (at least 1)."""
    onehot = nn.functional.one_hot(dst.long(), n).to(msg.dtype)   # (B,E,N)
    w = onehot * edge_mask.to(msg.dtype)[..., None]
    agg = torch.einsum("ben,bef->bnf", w, msg)
    deg = w.sum(dim=1)
    return agg / torch.clamp(deg, min=1.0)[..., None]


class Gconv(nn.Module):
    """Kipf-Welling-style convolution: (D^-1 A) relu(a(x)) + relu(u(x))
    (reference gcn.py:8-40), A the adjacency of the padded edge list."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.a_fc = nn.Linear(in_features, out_features)
        self.u_fc = nn.Linear(in_features, out_features)

    def forward(self, x, src, dst, edge_mask, node_mask):
        ax = torch.relu(self.a_fc(x))
        ux = torch.relu(self.u_fc(x))
        msg = torch.gather(ax, 1, src.long()[..., None].expand(
            -1, -1, ax.shape[-1]))
        out = _segment_mean(msg, dst, edge_mask, x.shape[1]) + ux
        return out * node_mask[..., None].to(out.dtype)


class ChannelIndependentConv(nn.Module):
    """CIE layer: node and edge channels update each other (reference
    gcn.py:41-111). Returns (node features (B, N, out), edge features
    (B, E, out)), both masked."""

    def __init__(self, in_features: int, edge_features: int,
                 out_features: int):
        super().__init__()
        self.node_fc = nn.Linear(in_features, out_features)
        self.node_sfc = nn.Linear(in_features, out_features)
        self.edge_fc = nn.Linear(edge_features, out_features)

    def forward(self, x, edge_feat, src, dst, edge_mask, node_mask):
        x1 = self.node_fc(x)
        x2 = self.node_sfc(x)
        e1 = torch.relu(self.edge_fc(edge_feat))
        em = edge_mask.to(x1.dtype)[..., None]
        src_x1 = torch.gather(x1, 1, src.long()[..., None].expand(
            -1, -1, x1.shape[-1]))
        # node update: source-node features gated by the edge features
        msg = torch.relu(src_x1) * e1 * em
        node = _segment_mean(msg, dst, edge_mask, x.shape[1]) \
            + torch.relu(x2)
        return node * node_mask[..., None].to(node.dtype), e1 * em


class SiameseGconv(nn.Module):
    """One Gconv, its parameters shared, applied to both graphs of a pair."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.gconv = Gconv(in_features, out_features)

    def forward(self, pair_inputs: Tuple) -> Tuple:
        return tuple(self.gconv(*args) for args in pair_inputs)
