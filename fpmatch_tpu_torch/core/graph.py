"""Fixed-shape padded graphs as NamedTuples of tensors (the JAX package's
`core/graph.py`; the reference's ragged tensors + dense incidence matrices,
utils/build_graphs.py:12-74).

The incidence factorization A = G H^T is implicit: directed edge e runs
src[e] -> dst[e], i.e. G[i, e] = 1 iff src[e] == i and H[j, e] = 1 iff
dst[e] == j. Every array is padded: `n_nodes` / `n_edges` / `n_tri` give the
valid counts, padded edge and triangle slots point at node 0 and are masked.
Built on the host (`make_graph`, numpy in, CPU tensors out); `.to(device)`
moves a graph or a pair.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Graph(NamedTuple):
    """One keypoint graph, padded to (n_max, e_max, t_max)."""

    points: torch.Tensor     # (n_max, 2) float32 keypoint xy in pixels
    src: torch.Tensor        # (e_max,) int32 edge source node
    dst: torch.Tensor        # (e_max,) int32 edge destination node
    n_nodes: torch.Tensor    # () int32
    n_edges: torch.Tensor    # () int32
    tri: torch.Tensor        # (t_max, 3) int32 triangle corners
    n_tri: torch.Tensor      # () int32

    @property
    def n_max(self) -> int:
        return self.points.shape[0]

    @property
    def e_max(self) -> int:
        return self.src.shape[0]

    def _below(self, n: int, count) -> torch.Tensor:
        return torch.arange(n, device=self.points.device) < count

    def node_mask(self) -> torch.Tensor:
        return self._below(self.n_max, self.n_nodes)

    def edge_mask(self) -> torch.Tensor:
        return self._below(self.e_max, self.n_edges)

    def tri_mask(self) -> torch.Tensor:
        return self._below(self.tri.shape[0], self.n_tri)

    def to(self, device) -> "Graph":
        return Graph(*(t.to(device) for t in self))


class GraphPair(NamedTuple):
    """A matching problem: two graphs + supervision. `gt_perm` is the
    (n_max, n_max) 0/1 ground-truth assignment, `label` the genuine (1) /
    impostor (0) pair label, `gt_k` the sum of gt_perm; `images` (2, H, W, 3)
    normalized, channels-last, or None (QAP)."""

    g1: Graph
    g2: Graph
    images: Optional[torch.Tensor]
    gt_perm: torch.Tensor
    label: torch.Tensor
    gt_k: torch.Tensor

    def to(self, device) -> "GraphPair":
        move = lambda t: None if t is None else t.to(device)
        return GraphPair(self.g1.to(device), self.g2.to(device),
                         move(self.images), move(self.gt_perm),
                         move(self.label), move(self.gt_k))


def pad_points(points: np.ndarray, n_max: int) -> np.ndarray:
    """Zero-pad an (n, 2) point array to (n_max, 2) (extra points cut)."""
    out = np.zeros((n_max, 2), dtype=np.float32)
    n = min(len(points), n_max)
    if n:
        out[:n] = points[:n]
    return out


def make_graph(points: np.ndarray, src: np.ndarray, dst: np.ndarray,
               tri: np.ndarray, n_max: int, e_max: int, t_max: int) -> Graph:
    """A padded Graph from host arrays (CPU tensors). More nodes or edges
    than the bucket raise; triangles beyond t_max are cut."""
    n, e, t = int(len(points)), int(len(src)), int(len(tri))
    if n > n_max:
        raise ValueError(f"{n} nodes exceed bucket n_max={n_max}")
    if e > e_max:
        raise ValueError(f"{e} edges exceed bucket e_max={e_max}")
    t = min(t, t_max)
    src_p = np.zeros((e_max,), dtype=np.int32)
    dst_p = np.zeros((e_max,), dtype=np.int32)
    src_p[:e] = src
    dst_p[:e] = dst
    tri_p = np.zeros((t_max, 3), dtype=np.int32)
    if t:
        tri_p[:t] = tri[:t]
    count = lambda v: torch.tensor(v, dtype=torch.int32)
    return Graph(points=torch.from_numpy(pad_points(points, n_max)),
                 src=torch.from_numpy(src_p), dst=torch.from_numpy(dst_p),
                 n_nodes=count(n), n_edges=count(e),
                 tri=torch.from_numpy(tri_p), n_tri=count(t))
