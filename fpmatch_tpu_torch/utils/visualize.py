"""Visualization (the JAX package's `utils/visualize.py`; reference
utils/visualize.py + utils/matching.py): de-normalized images, keypoint
overlays, match lines between the views of a pair (`cv2`), similarity
heatmaps and graph drawings (matplotlib, `networkx` for the spring layout
where it is installed). Host numpy; each drawing library is imported inside
the function that needs it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

NORM_MEANS = np.array([0.485, 0.456, 0.406], np.float32)
NORM_STD = np.array([0.229, 0.224, 0.225], np.float32)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """(H, W, 3|1) normalized float or raw uint8 -> uint8 RGB (loaders ship
    raw uint8, possibly single-channel luma, and normalize on the device)."""
    if img.dtype != np.uint8:
        img = np.clip((img * NORM_STD + NORM_MEANS) * 255.0,
                      0, 255).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


def draw_keypoints(img: np.ndarray, points: np.ndarray, n: int,
                   color=(0, 255, 0)) -> np.ndarray:
    import cv2

    out = img.copy()
    for x, y in points[:n]:
        cv2.circle(out, (int(x), int(y)), 3, color, -1)
    return out


def visualize_match(images: np.ndarray, points: np.ndarray, ns: np.ndarray,
                    perm: np.ndarray, label: float, prob: float,
                    path: str, unknown_label: bool = False) -> None:
    """Side-by-side pair with match lines from the predicted permutation.

    :param images: (2, H, W, 3|1) batch images (normalized float or uint8)
    :param points: (2, N, 2); ns: (2,); perm: (N, N) hard assignment
    """
    import cv2

    img1 = draw_keypoints(denormalize_image(images[0]), points[0], int(ns[0]))
    img2 = draw_keypoints(denormalize_image(images[1]), points[1], int(ns[1]),
                          color=(255, 120, 0))
    canvas = np.concatenate([img1, img2], axis=1)
    off = img1.shape[1]
    rows, cols = np.nonzero(perm[:int(ns[0]), :int(ns[1])])
    for i, j in zip(rows, cols):
        p1 = points[0][i]
        p2 = points[1][j]
        cv2.line(canvas, (int(p1[0]), int(p1[1])),
                 (int(p2[0]) + off, int(p2[1])), (0, 200, 255), 1)
    tag = "score" if unknown_label else \
        ("genuine" if label > 0.5 else "imposter")
    cv2.putText(canvas, f"{tag}  p={prob:.3f}  matches={len(rows)}",
                (8, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    cv2.imwrite(path, cv2.cvtColor(canvas, cv2.COLOR_RGB2BGR))


def similarity_heatmap(sim: np.ndarray, n1: int, n2: int,
                       path: Optional[str] = None):
    """Matplotlib heatmap of the valid (n1, n2) block of a similarity
    matrix: written to `path` (returns None), else the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5))
    im = ax.imshow(sim[:n1, :n2], aspect="auto", cmap="viridis")
    fig.colorbar(im)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return None
    return fig


def draw_graph_structure(points: np.ndarray, src: np.ndarray,
                         dst: np.ndarray, n: int, n_edges: int,
                         path: Optional[str] = None, layout: str = "spatial",
                         node_color: str = "skyblue",
                         edge_color: str = "gray"):
    """A fingerprint graph's nodes and edges (the reference's
    visualize_pyg_data, utils/visualize.py:46-135). "spatial" puts the
    nodes at their pore coordinates; "spring" is networkx's
    spring_layout(seed=42) where networkx is installed, else spatial.

    :param points: (N, 2) padded keypoints; src, dst (E,) padded edges
    :param n, n_edges: the valid counts
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    pos = np.asarray(points[:n], np.float64)
    s = np.asarray(src[:n_edges])
    d = np.asarray(dst[:n_edges])
    if layout == "spring":
        try:
            import networkx as nx
        except ImportError:
            nx = None
        if nx is not None:
            G = nx.Graph()
            G.add_nodes_from(range(n))
            G.add_edges_from(zip(s.tolist(), d.tolist()))
            p = nx.spring_layout(G, seed=42)
            pos = np.asarray([p[i] for i in range(n)])

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.add_collection(LineCollection(np.stack([pos[s], pos[d]], axis=1),
                                     colors=edge_color, alpha=0.7,
                                     linewidths=0.8))
    ax.scatter(pos[:, 0], pos[:, 1], s=50, c=node_color, alpha=0.7,
               zorder=2)
    ax.set_title("Graph Visualization")
    ax.set_aspect("equal")
    ax.invert_yaxis()                  # image coordinates
    ax.axis("off")
    if path:
        fig.savefig(path, bbox_inches="tight", pad_inches=0, dpi=120)
        plt.close(fig)
        return None
    return fig


def draw_graph_batch(points: np.ndarray, src: np.ndarray, dst: np.ndarray,
                     ns: np.ndarray, n_edges: np.ndarray, prefix: str,
                     layout: str = "spatial"):
    """One PNG per graph of a padded batch, `{prefix}_{i}.png` (the
    reference's visualize_pyg_batch); returns the paths."""
    paths = []
    for i in range(len(ns)):
        p = f"{prefix}_{i}.png"
        draw_graph_structure(points[i], src[i], dst[i], int(ns[i]),
                             int(n_edges[i]), path=p, layout=layout)
        paths.append(p)
    return paths
