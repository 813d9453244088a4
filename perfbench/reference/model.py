"""The plain reference of the matcher: the neural-graph-matching network of a
configuration file, written out in float32 PyTorch operations.

It takes the configuration as the JSON dict of `perfbench/configs/`, the
weights as a flat {name: tensor} dict (the names of the program's
`state_dict`, which the benchmark made from the seed and hands to both
sides), and a batch of padded pairs as a dict of tensors. It imports nothing
of the program: every quantity the program derives from the inputs (masks,
degrees, edge grouping, the association matrix) is worked out here again, in
its own way where a plainer one exists:

  * the association product K^T vec(X) is formed from one-hot incidence
    matrices of the four edge lists (dense matmuls), not from grouped edges;
  * the spline convolution gathers each edge's 4 active B-spline taps
    from the projections of its source node, by (node, tap) index;
  * batch norms, alignment, Sinkhorn, soft top-k, AFA-U, the greedy fill
    and the match classifier follow the model's published equations.

Set `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` to False around a call (the benchmark's
`reference.no_tf32`): the reference is float32 throughout.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions on the card (no TF32) inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Params:
    """The weights under one prefix: `p["conv1.weight"]`, `p.sub("bn1")`."""

    def __init__(self, flat, prefix=""):
        self.flat, self.prefix = flat, prefix

    def __getitem__(self, key):
        return self.flat[self.prefix + key]

    def sub(self, name):
        return Params(self.flat, f"{self.prefix}{name}.")

    def has(self, key):
        return self.prefix + key in self.flat


# ------------------------------------------------------------------ helpers
def lin(p, x):
    """y = x W^T + b of a linear layer's weights `p` (bias optional)."""
    y = x @ p["weight"].t()
    return y + p["bias"] if p.has("bias") else y


def lengths_mask(n, size):
    return torch.arange(size, device=n.device) < n.reshape(-1, 1)


def safe_logsumexp(x, mask, dim):
    """logsumexp over `dim` of the entries where `mask`; -inf where there
    are none, with a finite gradient there."""
    xm = torch.where(mask, x, NEG_INF)
    m = torch.amax(xm, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.where(mask, torch.exp(xm - m), 0.0), dim=dim,
                  keepdim=True)
    return torch.where(s > 0, torch.log(torch.clamp(s, min=1e-38)) + m,
                       NEG_INF)


def l2_normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def batch_norm(p, x, train, mask=None, eps=1e-5):
    """Batch norm of NCHW `x`: biased statistics of the batch (over the
    cells where `mask`, (B, 1, H, W), is 1) in train mode, the running
    statistics otherwise."""
    shp = (1, -1, 1, 1)
    if not train:
        mean, var = p["running_mean"], p["running_var"]
    elif mask is None:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.square(x - mean.reshape(shp)).mean(dim=(0, 2, 3))
    else:
        cnt = torch.clamp(mask.sum(), min=1.0)
        mean = (x * mask).sum(dim=(0, 2, 3)) / cnt
        var = (torch.square(x - mean.reshape(shp)) * mask).sum(
            dim=(0, 2, 3)) / cnt
    y = (x - mean.reshape(shp)) / torch.sqrt(var.reshape(shp) + eps)
    return y * p["weight"].reshape(shp) + p["bias"].reshape(shp)


# ---------------------------------------------------------------- backbones
def resnet18(p, cfg, x, train):
    """Truncated ResNet-18 (no classifier): node maps of the configured
    taps, the layer-4 map and its global max; x (G, 3, H, W)."""
    bb = cfg["backbone"]
    y = F.conv2d(x, p["conv1.weight"], stride=2, padding=3)
    y = F.max_pool2d(torch.relu(batch_norm(p.sub("bn1"), y, train)), 3, 2, 1)
    taps, prev = {}, bb["stem_channels"]
    for i, ch in enumerate(bb["stage_channels"]):
        for b in range(bb["blocks_per_stage"]):
            q = p.sub(f"layer{i + 1}_{b}")
            stride = 2 if (i > 0 and b == 0) else 1
            h = torch.relu(batch_norm(q.sub("bn1"), F.conv2d(
                y, q["conv1.weight"], stride=stride, padding=1), train))
            h = batch_norm(q.sub("bn2"), F.conv2d(
                h, q["conv2.weight"], padding=1), train)
            if prev != ch or stride != 1:
                y = batch_norm(q.sub("downsample_bn"), F.conv2d(
                    y, q["downsample_conv.weight"], stride=stride), train)
            y = torch.relu(h + y)
            prev = ch
        taps[f"layer{i + 1}"] = y
    return ([taps[t] for t in bb["node_taps"]], taps["layer4"],
            taps["layer4"].amax(dim=(2, 3)))


def vgg16(p, cfg, x, train):
    """VGG16 (with batch norm for kind vgg16_bn): node map at conv4_3 and
    edge map at conv5_2, both before their batch norm; global = max of the
    last map."""
    use_bn = cfg["backbone"]["kind"] == "vgg16_bn"
    y, nodes, edges = x, None, None
    for si, (_, n_convs) in enumerate(VGG_STAGES):
        for ci in range(n_convs):
            tag = f"{si + 1}_{ci + 1}"
            y = F.conv2d(y, p[f"conv{tag}.weight"], p[f"conv{tag}.bias"],
                         padding=1)
            if (si, ci) == (3, 2):
                nodes = y
            if (si, ci) == (4, 1):
                edges = y
            if use_bn:
                y = batch_norm(p.sub(f"bn{tag}"), y, train)
            y = torch.relu(y)
        if si < len(VGG_STAGES) - 1:
            y = F.max_pool2d(y, 2, 2)
    return [nodes], edges, y.amax(dim=(2, 3))


# ---------------------------------------------------------------- graph side
def align(fmap, pts, rescale):
    """Bilinear samples of NCHW `fmap` at keypoints `pts` (G, N, 2) in image
    pixels, half-pixel centred; (G, N, C)."""
    G, C, hf, wf = fmap.shape
    W, H = rescale
    sx, sy = W / wf, H / hf
    x = (pts[..., 0] - sx / 2) / sx
    y = (pts[..., 1] - sy / 2) / sy
    x0 = torch.clamp(torch.floor(x), 0, wf - 1)
    y0 = torch.clamp(torch.floor(y), 0, hf - 1)
    x1 = torch.clamp(x0 + 1, 0, wf - 1)
    y1 = torch.clamp(y0 + 1, 0, hf - 1)
    fx = torch.clamp(x, 0, wf - 1) - x0
    fy = torch.clamp(y, 0, hf - 1) - y0
    flat = fmap.flatten(2)                                 # (G, C, hf*wf)

    def at(yi, xi):
        idx = (yi * wf + xi).long()[:, None, :].expand(-1, C, -1)
        return torch.gather(flat, 2, idx).transpose(1, 2)  # (G, N, C)

    w = lambda a: a[..., None]
    return (at(y0, x0) * w((1 - fx) * (1 - fy)) + at(y1, x0) * w((1 - fx) * fy)
            + at(y0, x1) * w(fx * (1 - fy)) + at(y1, x1) * w(fx * fy))


def spline_taps(u, kernel_size):
    """The degree-1 open B-spline basis of 2-D pseudo-coordinates u
    (..., 2) at its 4 non-zero taps: (index, weight) pairs, the index
    into the kernel_size**2 kernels with the first coordinate slowest."""
    m = kernel_size - 1
    pos = torch.clamp(u, 0.0, 1.0) * m
    k0 = torch.clamp(torch.floor(pos), 0, m - 1)
    frac = pos - k0
    taps = []
    for a in (0, 1):
        for b in (0, 1):
            w = ((frac[..., 0] if a else 1 - frac[..., 0])
                 * (frac[..., 1] if b else 1 - frac[..., 1]))
            idx = (k0[..., 0] + a) * kernel_size + (k0[..., 1] + b)
            taps.append((idx.long(), w))
    return taps


def spline_layer(x, src, dst, pseudo, emask, nmask, weight, root, bias,
                 kernel_size):
    """out[i] = max over valid edges e into i of sum_s B_s(u_e) x[src_e] W_s
    (0 without any), + x[i] W_root + b; masked. The basis is non-zero at 4
    kernels an edge."""
    G, N, _ = x.shape
    K, _, c_out = weight.shape
    proj = torch.einsum("gni,sio->gnso", x, weight).reshape(G, N * K, c_out)
    msg = 0
    for idx, w in spline_taps(pseudo, kernel_size):
        rows = (src.long() * K + idx)[..., None].expand(-1, -1, c_out)
        msg = msg + (w * emask)[..., None] * torch.gather(proj, 1, rows)
    msg = torch.where(emask[..., None], msg, NEG_INF)
    agg = torch.full((G, N, c_out), NEG_INF, device=x.device, dtype=x.dtype)
    agg = agg.scatter_reduce(1, dst.long()[..., None].expand_as(msg), msg,
                             "amax", include_self=True)
    agg = torch.where(torch.isfinite(agg), agg, 0.0)
    return (agg + x @ root + bias) * nmask[..., None]


def affinity(p, X, Y, w, mask):
    """softplus(X diag(tanh(A w)) Y^T) - 0.5, masked."""
    coeff = torch.tanh(lin(p.sub("A"), w))
    res = torch.einsum("bid,bjd->bij", X * coeff[:, None, :], Y)
    return (F.softplus(res) - 0.5) * mask


def one_hot(idx, n, valid):
    """(B, E, n) incidence of an edge list, zero rows for padded slots."""
    return F.one_hot(idx.long(), n).to(torch.get_default_dtype()) \
        * valid[..., None]


def assoc_transpose_product(X, Kp, Ke, S1, D1, S2, D2):
    """K^T vec(X) of the association matrix
    K = diag(vec Kp) + sum_{e1,e2} Ke[e1,e2] e_(src1,src2) e_(dst1,dst2)^T:
    Y[a, j] = Kp[a, j] X[a, j] + sum_{e1: dst1=a, e2: dst2=j} Ke[e1, e2]
    X[src1(e1), src2(e2)], per channel, from the incidence matrices."""
    gathered = torch.einsum("bea,bajc,bfj->befc", S1, X, S2)
    return (torch.einsum("bea,befc,bfj->bajc", D1, Ke[..., None] * gathered,
                         D2) + Kp[..., None] * X)


def sinkhorn(s, n1, n2, tau, iters):
    """Square-bucket Sinkhorn of each sample's valid (n1, n2) block in log
    space, padded to max(n1, n2) with dummy entries of log-value -100 on the
    short side; rows first (columns first for n1 > n2); zero outside the
    valid block."""
    B, S, _ = s.shape
    r = torch.arange(S, device=s.device).reshape(1, S, 1)
    c = torch.arange(S, device=s.device).reshape(1, 1, S)
    n1 = n1.reshape(B, 1, 1)
    n2 = n2.reshape(B, 1, 1)
    valid = (r < n1) & (c < n2)
    rows_first = n1 <= n2
    dummy = torch.where(rows_first, (r >= n1) & (r < n2) & (c < n2),
                        (c >= n2) & (c < n1) & (r < n1))
    region = valid | dummy
    ls = torch.where(valid, s / tau, NEG_INF)
    ls = torch.where(dummy, -100.0, ls)
    # columns-first samples: transpose, normalize rows first, transpose back
    ls = torch.where(rows_first, ls, ls.transpose(1, 2))
    reg = torch.where(rows_first, region, region.transpose(1, 2))

    def norm(t, dim):
        out = t - torch.nan_to_num(safe_logsumexp(t, reg, dim), neginf=0.0)
        return torch.where(reg, out, NEG_INF)

    for i in range(iters):
        ls = norm(ls, -1 if i % 2 == 0 else -2)
    ls = torch.where(rows_first, ls, ls.transpose(1, 2))
    return torch.where(valid, torch.exp(ls), 0.0)


def soft_topk(scores, k, n1, n2, tau, iters, extra):
    """Soft top-k of each sample's valid scores: each score's distances to
    the sample's min and max are a 2-channel map, normalized in log space
    to row mass 1 per score and channel masses [n1 n2 - k, k]; after
    `iters` steps, `extra` more steps, each applied only while some valid
    entry is above 0 (log scale); the max channel, zero for k = 0."""
    B, S1, S2 = scores.shape
    valid = lengths_mask(n1, S1)[:, :, None] & lengths_mask(n2, S2)[:, None]
    v4 = valid[..., None]
    total = (n1 * n2).to(scores.dtype)
    lo = torch.where(valid, scores, math.inf).amin(dim=(1, 2))
    hi = torch.where(valid, scores, NEG_INF).amax(dim=(1, 2))
    anchors = torch.stack([lo, hi], dim=-1)[:, None, None, :]
    ls = torch.where(v4, -torch.abs(scores[..., None] - anchors) / tau,
                     NEG_INF)
    k = torch.minimum(torch.clamp(k, min=0.0), total)
    log_marg = torch.log(torch.clamp(torch.stack([total - k, k], -1),
                                     min=1e-20))[:, None, None, :]

    def rows(t):
        out = t - torch.nan_to_num(safe_logsumexp(t, v4, -1), neginf=0.0)
        return torch.where(v4, torch.nan_to_num(out, nan=NEG_INF), NEG_INF)

    def cols(t):
        out = (t - torch.nan_to_num(safe_logsumexp(t, v4, (1, 2)),
                                    neginf=0.0) + log_marg)
        return torch.where(v4, torch.nan_to_num(out, nan=NEG_INF), NEG_INF)

    steps = [rows, cols]
    for i in range(iters):
        ls = steps[i % 2](ls)
    for i in range(extra):
        over = (torch.where(v4, ls, NEG_INF) > 0).flatten(1).any(dim=1)
        ls = torch.where(over[:, None, None, None],
                         steps[(iters + i) % 2](ls), ls)
    out = torch.where(k[:, None, None] > 0, torch.exp(ls[..., 1]), 0.0)
    return torch.where(valid, out, 0.0)


def greedy(rank, k, n1, n2):
    """Greedy one-to-one selection: round(k) times (half to even) the
    largest entry whose row and column are both unused; ties to the lowest
    row-major index."""
    B, S1, S2 = rank.shape
    valid = lengths_mask(n1, S1)[:, :, None] & lengths_mask(n2, S2)[:, None]
    cur = torch.where(valid, rank, NEG_INF).clone()
    kr = torch.round(k)
    out = torch.zeros_like(rank)
    ar = torch.arange(B, device=rank.device)
    for i in range(min(S1, S2)):
        flat = cur.flatten(1)
        val, idx = flat.max(dim=1)
        take = (i < kr) & (val > NEG_INF)
        r, c = idx // S2, idx % S2
        out[ar[take], r[take], c[take]] = 1.0
        cur[ar[take], r[take], :] = NEG_INF
        cur[ar[take], :, c[take]] = NEG_INF
    return out


def instance_norm(x, mask, scale, bias, eps=1e-5):
    m = mask[..., None].to(x.dtype)
    cnt = torch.clamp(m.sum(dim=(1, 2), keepdim=True), min=1.0)
    mean = (x * m).sum(dim=1, keepdim=True) / cnt
    var = (torch.square(x - mean) * m).sum(dim=1, keepdim=True) / cnt
    return ((x - mean) / torch.sqrt(var + eps) * scale + bias) * m


def afau_block(p, rows, cols, cost, row_mask, col_mask, heads=16, dim=16):
    """One side of AFA-U's bipartite encoder: cross-attention whose scores
    mix q.k with the Sinkhorn cost through a per-head 2 -> 16 -> 1 MLP,
    Add & InstanceNorm, feed-forward, Add & InstanceNorm."""
    B, R, _ = rows.shape
    C = cols.shape[1]
    split = lambda t, n: t.reshape(B, n, heads, dim).transpose(1, 2)
    q = split(rows @ p["Wq.weight"].t(), R)
    k = split(cols @ p["Wk.weight"].t(), C)
    v = split(cols @ p["Wv.weight"].t(), C)
    dot = q @ k.transpose(-1, -2) / math.sqrt(dim)         # (B, h, R, C)
    mha = p.sub("mha")
    w1, b1 = mha["mix1_weight"], mha["mix1_bias"]           # (h, 2, M), (h, M)
    hidden = torch.relu(
        dot[..., None] * w1[None, :, None, None, 0, :]
        + cost[:, None, :, :, None] * w1[None, :, None, None, 1, :]
        + b1[None, :, None, None, :])
    mixed = (hidden @ mha["mix2_weight"][None, :, None])[..., 0] \
        + mha["mix2_bias"][None, :, None, :]
    cm = col_mask[:, None, None, :]
    att = torch.where(cm, torch.softmax(torch.where(cm, mixed, NEG_INF), -1),
                      0.0) @ v                              # (B, h, R, dim)
    att = att.transpose(1, 2).reshape(B, R, heads * dim)
    out1 = instance_norm(rows + lin(p.sub("combine"), att), row_mask,
                         p["norm1_scale"], p["norm1_bias"])
    ff = lin(p.sub("ff2"), torch.relu(lin(p.sub("ff1"), out1)))
    return instance_norm(out1 + ff, row_mask, p["norm2_scale"],
                         p["norm2_bias"])


def afau(p, cost, n1, n2, univ):
    """k / min(n1, n2) predicted from the Sinkhorn map: zero row embeddings,
    one-hot column embeddings of width `univ`, both encoder sides,
    max-pooled, two small heads averaged, sigmoid."""
    B, S1, S2 = cost.shape
    rmask, cmask = lengths_mask(n1, S1), lengths_mask(n2, S2)
    rows = cost.new_zeros((B, S1, univ))
    eye = cost.new_zeros((S2, univ))
    d = min(S2, univ)
    eye[:d, :d] = torch.eye(d, device=cost.device)
    cols = eye[None] * cmask[..., None]
    r_out = afau_block(p.sub("row_block"), rows, cols, cost, rmask, cmask)
    c_out = afau_block(p.sub("col_block"), cols, rows, cost.transpose(1, 2),
                       cmask, rmask)
    g_r = torch.where(rmask[..., None], r_out, NEG_INF).amax(dim=1)
    g_c = torch.where(cmask[..., None], c_out, NEG_INF).amax(dim=1)
    head = lambda a, g: lin(p.sub(f"final_{a}_fc2"),
                            torch.relu(lin(p.sub(f"final_{a}_fc1"), g)))
    return torch.sigmoid(0.5 * (head("row", g_r) + head("col", g_c))[..., 0])


def match_classifier(p, sim, n1, n2, channels, train):
    """Small CNN over the matched-score map: per level conv 3x3, ReLU,
    batch norm over the valid cells, zeroed outside them, 2x2 max pool;
    mean over the valid cells of the last level; one logit."""
    x = sim[:, None]

    def level_mask(h, w, shift):
        d = 2 ** shift
        vr = torch.ceil(n1.float() / d)[:, None, None]
        vc = torch.ceil(n2.float() / d)[:, None, None]
        r = torch.arange(h, device=x.device)[None, :, None]
        c = torch.arange(w, device=x.device)[None, None, :]
        return ((r < vr) & (c < vc)).float()[:, None]

    for i in range(len(channels)):
        x = torch.relu(F.conv2d(x, p[f"conv{i}.weight"], p[f"conv{i}.bias"],
                                padding=1))
        m = level_mask(x.shape[2], x.shape[3], i)
        x = batch_norm(p.sub(f"bn{i}"), x, train, mask=m) * m
        x = F.max_pool2d(x, 2, 2)
    m = level_mask(x.shape[2], x.shape[3], len(channels))
    pooled = (x * m).sum(dim=(2, 3)) / torch.clamp(m.sum(dim=(2, 3)), min=1)
    return lin(p.sub("fc"), pooled)[..., 0]


# -------------------------------------------------------------------- model
def forward(weights, cfg, batch, train=False, bn_main=None, bn_cls=None,
            given_k=None, given_perm=None):
    """The matcher on `batch` (dict: images (B, 2, H, W, 3) float32, points
    (B, 2, N, 2), n_nodes (B, 2), src / dst (B, 2, E), n_edges (B, 2),
    gt_perm (B, N, N), label (B,), gt_k (B,)). `train`: the soft top-k
    targets gt_k and the batch norms take batch statistics (each of the
    two groups can be set apart by `bn_main` / `bn_cls`). Returns the
    model's outputs and loss terms.

    To judge a program's discrete outputs on the reference's own maps,
    `given_k` (B,) replaces the predicted k fraction after AFA-U (the
    returned `k_prob` stays the reference's) and `given_perm` (B, N, N)
    the greedy picks."""
    ngm, bb = cfg["ngm"], cfg["backbone"]
    bn_main = train if bn_main is None else bn_main
    bn_cls = train if bn_cls is None else bn_cls
    P = Params(weights)
    imgs = batch["images"]
    B, _, H, W, _ = imgs.shape
    N = batch["points"].shape[2]
    E = batch["src"].shape[2]
    rescale = cfg["data"]["rescale"]
    n_nodes, n_edges = batch["n_nodes"], batch["n_edges"]
    nmask = lengths_mask(n_nodes.reshape(-1), N)            # (2B, N)
    emask = lengths_mask(n_edges.reshape(-1), E)
    pts = batch["points"].reshape(B * 2, N, 2)
    src = batch["src"].reshape(B * 2, E)
    dst = batch["dst"].reshape(B * 2, E)

    # NCHW in memory: the CPU build of torch corrupts its heap in the
    # backward of a 1x1 stride-2 convolution over a channels-last input at
    # narrow widths
    x = imgs.reshape(B * 2, H, W, 3).permute(0, 3, 1, 2).contiguous()
    net = resnet18 if bb["kind"] == "resnet18" else vgg16
    node_maps, edge_map, glob = net(P.sub("backbone"), cfg, x, bn_main)
    unit = lambda t: t / torch.clamp(torch.linalg.vector_norm(
        t, dim=1, keepdim=True), min=1e-12)
    feats = [align(unit(m), pts, rescale) for m in node_maps]
    feats.append(align(unit(edge_map), pts, rescale))
    h = torch.cat(feats, dim=-1) * nmask[..., None]

    # spline message passing, then the 0.1 residual
    pseudo = torch.clamp(0.5 * (torch.gather(
        pts, 1, src.long()[..., None].expand(-1, -1, 2)) - torch.gather(
        pts, 1, dst.long()[..., None].expand(-1, -1, 2))) / max(rescale)
        + 0.5, 0.0, 1.0)
    sp = P.sub("spline")
    y = h
    for i in range(ngm["spline_layers"]):
        y = spline_layer(y, src, dst, pseudo, emask, nmask,
                         sp[f"conv{i}_weight"], sp[f"conv{i}_root"],
                         sp[f"conv{i}_bias"], 5)
        if i < ngm["spline_layers"] - 1:
            y = torch.relu(y)
    h = (h + 0.1 * y) * nmask[..., None]
    take = lambda idx: torch.gather(h, 1, idx.long()[..., None].expand(
        -1, -1, h.shape[-1]))
    ef = (take(src) - take(dst)) * emask[..., None]

    g = glob.reshape(B, 2, -1)
    gw = l2_normalize(torch.cat([g[:, 0], g[:, 1]], dim=-1))
    h = h.reshape(B, 2, N, -1)
    ef = ef.reshape(B, 2, E, -1)
    nm = nmask.reshape(B, 2, N)
    em = emask.reshape(B, 2, E)
    n1, n2 = n_nodes[:, 0], n_nodes[:, 1]
    vmask = (nm[:, 0, :, None] & nm[:, 1, None, :]).float()
    Kp = affinity(P.sub("vertex_aff"), h[:, 0], h[:, 1], gw, vmask)
    Ke = 0.5 * affinity(P.sub("edge_aff"), ef[:, 0], ef[:, 1], gw,
                        (em[:, 0, :, None] & em[:, 1, None, :]).float())

    # association GNN: mean aggregation over K^T, embedded Sinkhorn channel
    bs, bd = batch["src"], batch["dst"]
    S1, D1 = one_hot(bs[:, 0], N, em[:, 0]), one_hot(bd[:, 0], N, em[:, 0])
    S2, D2 = one_hot(bs[:, 1], N, em[:, 1]), one_hot(bd[:, 1], N, em[:, 1])
    # entries per row of K^T, counted as the program's degree (graph sides
    # by their source endpoints; the graphs are symmetric) plus the diagonal
    deg = torch.clamp(S1.sum(1)[:, :, None] * S2.sum(1)[:, None, :] + vmask,
                      min=1.0)[..., None]
    emb = Kp[..., None]
    for i in range(ngm["gnn_layers"]):
        q = P.sub(f"gnn_{i}")
        agg = assoc_transpose_product(emb, Kp, Ke, S1, D1, S2, D2) / deg
        x1 = lin(q.sub("lin_l"), agg) + lin(q.sub("lin_r"), emb)
        x1 = x1 + torch.relu(lin(q.sub("self1"),
                                 torch.relu(lin(q.sub("self0"), emb))))
        sk = sinkhorn(lin(q.sub("classifier"), x1)[..., 0], n1, n2,
                      ngm["sk_tau"], ngm["sk_layer_iter"])
        emb = torch.cat([x1, sk[..., None]], dim=-1) * vmask[..., None]

    s = lin(P.sub("classifier"), emb)[..., 0]
    ss = sinkhorn(s, n1, n2, ngm["sk_tau"], ngm["sk_iter"])
    min_pts = torch.minimum(n1, n2).float()
    sup_ks = batch["gt_k"] / torch.clamp(min_pts, min=1.0)
    ks = afau(P.sub("afau"), ss.detach(), n1, n2, cfg["shapes"]["univ_size"])
    k_used = ks if given_k is None else given_k
    target = batch["gt_k"] if train else k_used * min_pts
    ds = soft_topk(ss, target, n1, n2, ngm["sk_tau"], ngm["sk_iter"],
                   ngm["topk_extra_iter"])
    perm = (greedy(ds.detach(), k_used.detach() * min_pts, n1, n2)
            if given_perm is None else given_perm.to(ds.dtype))
    logits = classify(weights, cfg, s, perm, n1, n2, bn_cls)
    label = batch["label"]
    cls_loss = torch.mean(torch.clamp(logits, min=0) - logits * label
                          + torch.log1p(torch.exp(-torch.abs(logits))))
    ks_loss = torch.mean((ks - sup_ks) ** 2) * ngm["k_factor"]
    return {"ds_mat": ds, "perm_mat": perm, "k_prob": ks,
            "cls_prob": torch.sigmoid(logits), "raw_scores": s,
            "sinkhorn": ss, "cls_loss": cls_loss, "ks_loss": ks_loss}


def classify(weights, cfg, s, perm, n1, n2, train=False):
    """The match classifier's logits on the matched scores s * perm."""
    return match_classifier(Params(weights).sub("match_cls"), s * perm, n1,
                            n2, cfg["ngm"]["match_cls_channels"], train)


def permutation_loss(ds, gt, n1, n2):
    """Binary cross-entropy of the soft map against the ground truth over
    the valid cells, over the sum of the source counts."""
    S1, S2 = ds.shape[1:]
    valid = lengths_mask(n1, S1)[:, :, None] & lengths_mask(n2, S2)[:, None]
    p = torch.clamp(ds, 1e-7, 1.0 - 1e-7)
    ce = -(gt * torch.log(p) + (1.0 - gt) * torch.log1p(-p))
    return torch.where(valid, ce, 0.0).sum() / torch.clamp(
        n1.sum().float(), min=1.0)
