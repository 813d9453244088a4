"""Model FLOPs of a pair, from the configuration and the pair's own node
and edge counts, whatever implements them.

Counted (2 FLOPs a multiply-add): the backbone's convolutions at the image
size of both views (a convolution's output cells x its kernel's size x
input x output channels); the spline convolutions (each valid edge's 4
active B-spline taps and each valid node's root product); the affinities
(the global gates, Kp over n1 x n2 and Ke over e1 x e2 at the feature
width); each association-GNN layer's K^T contraction (C (e1 e2 + n1 n2))
and its dense layers over the n1 x n2 valid cells; the final score layer;
AFA-U's projections, attention products and score-mixing MLP over the
valid rows and columns; the match classifier's two convolutions.
Not counted: elementwise work, normalizations, pooling, Sinkhorn, soft
top-k and the greedy fill (`PERF.md` says so). A training step counts 3x
the forward: the backward is twice the forward of the live partitions,
and in stage 3 every partition is live.
"""
from __future__ import annotations

VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def _conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def backbone_flops(cfg: dict, image_hw) -> float:
    """FLOPs of the backbone on one image."""
    bb = cfg["backbone"]
    H, W = image_hw
    total = 0.0

    def conv(h, w, cin, cout, k, stride, pad):
        nonlocal total
        ho, wo = _conv_out(h, k, stride, pad), _conv_out(w, k, stride, pad)
        total += 2.0 * ho * wo * cin * cout * k * k
        return ho, wo

    if bb["kind"] == "resnet18":
        h, w = conv(H, W, 3, bb["stem_channels"], 7, 2, 3)
        h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)     # max pool
        prev = bb["stem_channels"]
        for i, ch in enumerate(bb["stage_channels"]):
            for b in range(bb["blocks_per_stage"]):
                stride = 2 if (i > 0 and b == 0) else 1
                h2, w2 = conv(h, w, prev, ch, 3, stride, 1)
                conv(h2, w2, ch, ch, 3, 1, 1)
                if prev != ch or stride != 1:
                    conv(h, w, prev, ch, 1, stride, 0)
                h, w, prev = h2, w2, ch
        return total
    if bb["kind"] in ("vgg16", "vgg16_bn"):
        h, w, prev = H, W, 3
        for si, (ch, n) in enumerate(VGG_STAGES):
            for _ in range(n):
                conv(h, w, prev, ch, 3, 1, 1)
                prev = ch
            if si < len(VGG_STAGES) - 1:
                h, w = h // 2, w // 2
        return total
    raise ValueError(f"no FLOP count for backbone {bb['kind']!r}")


def graph_flops(cfg: dict, n1: int, n2: int, e1: int, e2: int) -> float:
    """FLOPs of everything after the backbone for one pair."""
    ngm = cfg["ngm"]
    F = ngm["node_feature_dim"]
    bb = cfg["backbone"]
    gdim = 2 * (bb["stage_channels"][-1] if bb["kind"] == "resnet18"
                else VGG_STAGES[-1][0])
    f = 0.0
    for n, e in ((n1, e1), (n2, e2)):
        f += ngm["spline_layers"] * 2.0 * F * F * (4 * e + n)
    f += 2 * 2.0 * gdim * F                       # the two gates
    f += 2.0 * F * (n1 * n2 + e1 * e2)            # Kp, Ke
    cells = n1 * n2
    c_in = 1
    for out in ngm["gnn_feat"]:
        f += 2.0 * c_in * (e1 * e2 + cells)       # K^T vec(X)
        f += 2.0 * cells * (3 * c_in * out + out * out + out * ngm["sk_emb"])
        c_in = out + ngm["sk_emb"]
    f += 2.0 * cells * c_in                       # final scores
    # AFA-U: two encoder sides over the valid rows / columns
    D, hd = cfg["shapes"]["univ_size"], ngm["afa_head_num"] * ngm["afa_qkv_dim"]
    ff, ms = ngm["afa_ff_hidden"], ngm["afa_ms_hidden"]
    for r, c in ((n1, n2), (n2, n1)):
        f += 2.0 * D * hd * (r + 2 * c)           # Wq, Wk, Wv
        f += 2 * 2.0 * r * c * hd                  # q.k and weights.v
        f += 2.0 * ngm["afa_head_num"] * r * c * (2 * ms + ms)   # mixing MLP
        f += 2.0 * r * hd * D                      # combine
        f += 2 * 2.0 * r * D * ff                  # feed-forward
    f += 2 * 2.0 * D * ngm["afa_reg_hidden"]
    # match classifier: 3x3 convolutions at full and half resolution
    ch = ngm["match_cls_channels"]
    f += 2.0 * 9 * 1 * ch[0] * cells
    f += 2.0 * 9 * ch[0] * ch[1] * (-(-n1 // 2)) * (-(-n2 // 2))
    return f


def pair_flops(cfg: dict, image_hw, n1, n2, e1, e2) -> float:
    """Forward FLOPs of one pair (two images)."""
    return 2 * backbone_flops(cfg, image_hw) + graph_flops(cfg, n1, n2, e1,
                                                           e2)


def batch_flops(cfg: dict, image_hw, n_nodes, n_edges) -> float:
    """Forward FLOPs of a batch, from its (B, 2) node and edge counts."""
    return sum(pair_flops(cfg, image_hw, int(a[0]), int(a[1]), int(b[0]),
                          int(b[1])) for a, b in zip(n_nodes, n_edges))


TRAIN_FACTOR = 3.0      # forward + backward (2x the forward) of a step
