"""Host-side keypoint-graph construction (numpy/scipy).

Same capability as the reference's utils/build_graphs.py:12-119 (Delaunay /
fully-connected / distance-thresholded adjacency, incidence factorization
A = G·Hᵀ), re-expressed as edge lists instead of dense incidence matrices.

Edge ordering matches the reference's row-major scan of the adjacency matrix
(build_graphs.py:63-72): edges are emitted in (i, j) lexicographic order with
A[i, j] == 1, so parity tests against the reference's G/H columns line up
index-for-index.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
from scipy.spatial import Delaunay
try:  # scipy >= 1.8
    from scipy.spatial import QhullError
except ImportError:  # pragma: no cover
    from scipy.spatial.qhull import QhullError


def delaunay_adjacency(P: np.ndarray) -> np.ndarray:
    """Delaunay triangulation adjacency; falls back to fully-connected on
    degenerate inputs (reference build_graphs.py:77-100)."""
    n = P.shape[0]
    if n < 3:
        return full_adjacency(n)
    try:
        d = Delaunay(P)
    except (QhullError, ValueError):
        return full_adjacency(n)
    A = np.zeros((n, n), dtype=np.float32)
    for simplex in d.simplices:
        for i, j in itertools.permutations(simplex, 2):
            A[i, j] = 1
    return A


def full_adjacency(n: int, P: np.ndarray = None, thre: float = None) -> np.ndarray:
    A = np.ones((n, n), dtype=np.float32) - np.eye(n, dtype=np.float32)
    if thre is not None and P is not None:
        d = np.linalg.norm(P[:, None, :] - P[None, :, :], axis=-1)
        A[d > thre] = 0
        np.fill_diagonal(A, 0)
    return A


def delaunay_triangles(P: np.ndarray) -> np.ndarray:
    """Triangle list for hyperedge attributes. Returns (t, 3) int array."""
    n = P.shape[0]
    if n < 3:
        return np.zeros((0, 3), dtype=np.int32)
    try:
        d = Delaunay(P)
    except (QhullError, ValueError):
        return np.zeros((0, 3), dtype=np.int32)
    return d.simplices.astype(np.int32)


def adjacency_to_edges(A: np.ndarray, sym: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Adjacency → (src, dst) edge lists in the reference's ordering:
    row-major scan; `sym=False` keeps only the upper triangle."""
    if not sym:
        A = np.triu(A)
    src, dst = np.nonzero(A)
    return src.astype(np.int32), dst.astype(np.int32)


def build_edges(P: np.ndarray, stg: str = "tri", sym: bool = True,
                thre: float = 0.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Point set → (A, src, dst). Strategies as in the reference: 'tri'
    (Delaunay), 'fc' (complete), 'near' (thresholded complete)."""
    n = P.shape[0]
    if stg == "tri":
        A = delaunay_adjacency(P)
    elif stg == "near":
        A = full_adjacency(n, P, thre=thre)
    elif stg == "fc":
        A = full_adjacency(n)
    else:
        raise ValueError(f"unknown graph construction strategy: {stg}")
    src, dst = adjacency_to_edges(A, sym=sym)
    return A, src, dst


def permute_edges(src: np.ndarray, dst: np.ndarray, perm: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Map graph-1 edges into graph-2 node ids through a partial permutation
    (G2 = P^T G1 when the target graph is built as 'same'). `perm` is
    (n1, n2) 0/1; rows with no match drop the edge. Returns the surviving
    mapped (src2, dst2)."""
    n1, n2 = perm.shape
    row_to_col = np.full((n1,), -1, dtype=np.int64)
    ri, ci = np.nonzero(perm)
    row_to_col[ri] = ci
    s2 = row_to_col[src]
    d2 = row_to_col[dst]
    keep = (s2 >= 0) & (d2 >= 0)
    return s2[keep].astype(np.int32), d2[keep].astype(np.int32)


def make_grids(start, stop, num) -> np.ndarray:
    """Regular grid point set (reference build_graphs.py:122-141): along
    each axis `num` cell centres between `start` and `stop`, all
    combinations, (prod(num), len(num)) float32."""
    axes = [np.linspace(b, e, n + 1)[1:] - (e - b) / (2 * n)
            for b, e, n in zip(start, stop, num)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=1).astype(np.float32)
