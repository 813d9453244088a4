"""B-spline kernel message passing math (SplineCNN, Fey et al. CVPR'18),
batch-native: degree-1 open splines (the matcher's: dim=2, kernel_size=5).

A pseudo-coordinate u in [0, 1] activates the two adjacent knots floor(u*m)
and floor(u*m)+1 (m = kernel_size - 1) with hat weights (1-frac, frac); in
2-D each edge activates 4 of the K = kernel_size**2 kernel weight matrices.
All K projections of the node features are computed once with one batched
matmul, then each edge takes its 4 active taps as row gathers from the
(N*K, C_out) projection table — the sparse basis is never densified.
Pseudo-coordinates of other than 2 dimensions (no model path) take the
dense basis `spline_basis` instead, as in the JAX package.
"""
from __future__ import annotations

import torch

NEG = -1e30


def spline_basis(u: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Dense degree-1 open B-spline basis.

    :param u: (E, D) pseudo-coordinates in [0, 1]
    :return: (E, kernel_size**D) basis weights, 2**D non-zeros per edge,
             flattened with dim 0 SLOWEST
    """
    e, d = u.shape
    m = kernel_size - 1
    p = torch.clamp(u, 0.0, 1.0) * m
    k0 = torch.clamp(torch.floor(p), 0, m - 1).long()          # (E, D)
    frac = p - k0
    onehot0 = torch.nn.functional.one_hot(k0, kernel_size).to(u.dtype)
    onehot1 = torch.nn.functional.one_hot(k0 + 1, kernel_size).to(u.dtype)
    per_dim = onehot0 * (1.0 - frac)[..., None] + onehot1 * frac[..., None]
    basis = per_dim[:, 0, :]
    for dim in range(1, d):
        basis = (basis[:, :, None] * per_dim[:, dim, None, :]).reshape(e, -1)
    return basis


def _tap_messages(x, src, edge_attr, weight, edge_mask, kernel_size: int):
    """2-D pseudo-coordinates: each edge's 4 active taps as row gathers from
    the (G*N*K, C_out) table of the node features' projections on all K
    kernels. Returns the (G, E, C_out) messages."""
    G, n, _ = x.shape
    E = src.shape[1]
    c_out = weight.shape[-1]
    K = kernel_size ** 2
    m = kernel_size - 1
    p = torch.clamp(edge_attr, 0.0, 1.0) * m                   # (G, E, 2)
    k0 = torch.clamp(torch.floor(p), 0, m - 1).long()
    frac = p - k0
    xw = torch.einsum("gni,sio->gnso", x, weight)              # (G, N, K, Co)
    table = xw.reshape(G * n * K, c_out)
    offs = (torch.arange(G, device=x.device) * (n * K))[:, None]
    base = src.long() * K + offs                               # (G, E)
    emask = edge_mask.to(x.dtype)
    msg = torch.zeros((G, E, c_out), dtype=x.dtype, device=x.device)
    for a in (0, 1):                                           # dim-0 taps
        wa = (1.0 - frac[..., 0]) if a == 0 else frac[..., 0]
        for b in (0, 1):                                       # dim-1 taps
            wb = (1.0 - frac[..., 1]) if b == 0 else frac[..., 1]
            # cell flattening matches spline_basis (dim 0 SLOWEST): learned
            # kernel banks bind this order
            cell = kernel_size * (k0[..., 0] + a) + (k0[..., 1] + b)
            w_e = (wa * wb * emask).to(x.dtype)
            rows = table.index_select(0, (base + cell).reshape(-1))
            msg = msg + w_e[..., None] * rows.reshape(G, E, c_out)
    return msg


def spline_conv(x: torch.Tensor, src, dst, edge_attr: torch.Tensor,
                weight: torch.Tensor, root_weight: torch.Tensor,
                bias: torch.Tensor, edge_mask: torch.Tensor,
                node_mask: torch.Tensor, kernel_size: int = 5,
                aggr: str = "max") -> torch.Tensor:
    """One SplineConv layer on a batch of padded edge-list graphs.

    out[i] = aggr_{e: dst[e]=i} sum_s B_s(u_e) * (x[src[e]] @ W_s)
             + x[i] @ W_root + b

    :param x: (G, N, C_in) node features of G graphs
    :param src, dst: (G, E) integer edge endpoints (padded slots alias node 0)
    :param edge_attr: (G, E, D) pseudo-coordinates (D = 2: the 4 taps of
        each edge gathered; other D: the dense basis contraction)
    :param weight: (K, C_in, C_out), K = kernel_size**D; root_weight
        (C_in, C_out); bias (C_out,)
    :param edge_mask: (G, E) bool; node_mask: (G, N) bool
    """
    G, n, _ = x.shape
    E = src.shape[1]
    c_out = weight.shape[-1]
    weight = weight.to(x.dtype)
    if edge_attr.shape[-1] == 2:
        msg = _tap_messages(x, src, edge_attr, weight, edge_mask,
                            kernel_size)
    else:
        # other dimensions: the dense basis contraction (JAX's fallback)
        D = edge_attr.shape[-1]
        basis = (spline_basis(edge_attr.reshape(G * E, D), kernel_size)
                 .reshape(G, E, -1) * edge_mask[..., None]).to(x.dtype)
        xs = torch.gather(x, 1, src.long()[..., None].expand(
            -1, -1, x.shape[-1]))
        msg = torch.einsum("ges,gei,sio->geo", basis, xs, weight)

    seg = (dst.long() + torch.arange(G, device=x.device)[:, None] * n
           ).reshape(-1)
    if aggr == "max":
        msg = torch.where(edge_mask[..., None], msg, NEG)
        # rows that receive no edge keep the NEG they start with; those and
        # rows whose edges are all masked become 0 (isolated nodes)
        agg = torch.full((G * n, c_out), NEG, dtype=x.dtype, device=x.device)
        agg.scatter_reduce_(0, seg[:, None].expand(-1, c_out),
                            msg.reshape(G * E, c_out), "amax",
                            include_self=True)
        agg = torch.where(agg <= NEG / 2, 0.0, agg)
    elif aggr in ("add", "mean"):
        msg = msg * edge_mask[..., None].to(x.dtype)
        agg = torch.zeros((G * n, c_out), dtype=x.dtype, device=x.device)
        agg.index_add_(0, seg, msg.reshape(G * E, c_out))
        if aggr == "mean":
            deg = torch.zeros((G * n,), dtype=x.dtype, device=x.device)
            deg.index_add_(0, seg, edge_mask.to(x.dtype).reshape(-1))
            agg = agg / torch.clamp(deg, min=1.0)[:, None]
    else:
        raise ValueError(f"unknown aggregation: {aggr}")

    out = agg.reshape(G, n, c_out) + x @ root_weight.to(x.dtype) \
        + bias.to(x.dtype)
    return out * node_mask[..., None].to(x.dtype)


def edge_pseudo_coords(points: torch.Tensor, src, dst,
                       rescale: float) -> torch.Tensor:
    """Edge pseudo-coordinates: 0.5*(P_src - P_dst)/rescale + 0.5, clipped
    to [0, 1]. points (G, N, 2); src, dst (G, E) -> (G, E, 2)."""
    idx_s = src.long()[..., None].expand(-1, -1, 2)
    idx_d = dst.long()[..., None].expand(-1, -1, 2)
    diff = 0.5 * (torch.gather(points, 1, idx_s)
                  - torch.gather(points, 1, idx_d)) / rescale + 0.5
    return torch.clamp(diff, 0.0, 1.0)


def hyperedge_angle_attrs(x: torch.Tensor, tri: torch.Tensor,
                          tri_mask: torch.Tensor) -> torch.Tensor:
    """Triangle-angle hyperedge attributes: for each triangle (i, j, k) the
    cosines of its three corner angles in feature space.

    :param x: (G, N, F) node features; tri: (G, T, 3) corner indices;
        tri_mask: (G, T) validity (float)
    :return: (G, T, 3) cosines, zero on padded slots
    """
    F = x.shape[-1]
    corner = lambda k: torch.gather(
        x, 1, tri[..., k].long()[..., None].expand(-1, -1, F))
    a, b, c = corner(0), corner(1), corner(2)
    v01 = a - b
    v02 = a - c
    v12 = b - c

    def norm(v):
        # safe norm: padded triangles alias node 0, so v == 0 exactly and
        # d|v|/dv would be NaN there (0 * NaN poisons the masked slots'
        # gradient); the max inside the sqrt keeps it finite
        return torch.sqrt(torch.clamp((v * v).sum(-1), min=1e-12))

    cos1 = (v01 * v02).sum(-1) / (norm(v01) * norm(v02))
    cos2 = (-v01 * v12).sum(-1) / (norm(v01) * norm(v12))
    cos3 = (v12 * v02).sum(-1) / (norm(v12) * norm(v02))
    return torch.stack([cos1, cos2, cos3], dim=-1) * tri_mask[..., None]
