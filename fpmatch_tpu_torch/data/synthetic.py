"""Synthetic pair generation (host-side, numpy): random keypoint clouds,
jittered genuine views with identity ground truth, impostor views with
independent clouds and zero permutation; with `cfg.ngm.hyperedge` each
view's Delaunay triangles (the first `t_max`) too.

The random-number calls are made in the same order as the JAX package's
`data/synthetic.py`, so the same seed gives the same batch in both packages.
"""
from __future__ import annotations

import numpy as np

from ..core.build_graphs import build_edges, delaunay_triangles
from ..core.config import Config


def synthetic_pair_batch(cfg: Config, batch_size: int, *, genuine_ratio=1.0,
                         n_range=(40, 60), image_hw=(240, 320),
                         seed: int = 0):
    """Build a host-side PairBatch of numpy arrays (`.to(device)` makes the
    tensors)."""
    from ..models.ngm import PairBatch

    rng = np.random.default_rng(seed)
    N = cfg.shapes.n_max
    E = cfg.shapes.e_max
    H, W = image_hw
    B = batch_size

    images = rng.normal(size=(B, 2, H, W, 3)).astype(np.float32)
    points = np.zeros((B, 2, N, 2), np.float32)
    src = np.zeros((B, 2, E), np.int32)
    dst = np.zeros((B, 2, E), np.int32)
    n_nodes = np.zeros((B, 2), np.int32)
    n_edges = np.zeros((B, 2), np.int32)
    gt_perm = np.zeros((B, N, N), np.float32)
    label = np.zeros((B,), np.float32)
    hyper = cfg.ngm.hyperedge
    if hyper:
        T = cfg.shapes.t_max
        tri = np.zeros((B, 2, T, 3), np.int32)
        n_tris = np.zeros((B, 2), np.int32)

    for b in range(B):
        genuine = rng.uniform() < genuine_ratio
        label[b] = float(genuine)
        n = int(rng.integers(*n_range))
        base = rng.uniform([8, 8], [W - 8, H - 8], size=(n, 2)).astype(np.float32)
        for v in range(2):
            if genuine or v == 0:
                P = base + rng.normal(0, 1.5, base.shape).astype(np.float32)
            else:
                m = int(rng.integers(*n_range))
                P = rng.uniform([8, 8], [W - 8, H - 8],
                                size=(m, 2)).astype(np.float32)
            P = np.clip(P, 0, [W - 1, H - 1])
            _, s, d = build_edges(P, stg=cfg.data.src_graph_construct)
            nv = len(P)
            points[b, v, :nv] = P
            src[b, v, :len(s)] = s
            dst[b, v, :len(d)] = d
            n_nodes[b, v] = nv
            n_edges[b, v] = len(s)
            if hyper:
                tv = delaunay_triangles(P)[:T]
                tri[b, v, :len(tv)] = tv
                n_tris[b, v] = len(tv)
        if genuine:
            gt_perm[b, :n, :n] = np.eye(n)

    batch = PairBatch(images, points, n_nodes, src, dst, n_edges, gt_perm,
                      label, gt_perm.sum((1, 2)).astype(np.float32))
    if hyper:
        batch = batch._replace(tri=tri, n_tris=n_tris)
    return batch
