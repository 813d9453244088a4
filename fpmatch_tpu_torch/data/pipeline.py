"""Pair samples + collation into fixed-shape PairBatch arrays (the part of
the JAX package's `data/pipeline.py` that single-pair serving needs: the
dataset / loader classes belong to evaluation and training and are not
ported yet).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import Config


def _load_image(path: str) -> np.ndarray:
    """Read an image file as (H, W, 3) uint8 RGB."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _annos_of(entry_kpts) -> List[List]:
    return [[k["labels"], k["x"], k["y"]] for k in entry_kpts]


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 luma, with OpenCV's 8-bit
    fixed-point RGB2GRAY arithmetic (15-bit coefficients of 0.299 / 0.587 /
    0.114, round to nearest), so collation needs no cv2."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(np.uint8)


@dataclass
class PairSample:
    """One matching problem in host (numpy, ragged) form."""

    images: Tuple[np.ndarray, np.ndarray]      # (H, W, 3) uint8 RGB x2
    points: Tuple[np.ndarray, np.ndarray]      # (n_i, 2) float32
    edges: Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]
    perm: np.ndarray                           # (n1, n2)
    label: float
    cls: Tuple[str, str]
    tris: Optional[Tuple[np.ndarray, np.ndarray]] = None


def collate(samples: Sequence[PairSample], cfg: Config):
    """Pad + stack host samples into a PairBatch of numpy arrays. Images
    stay raw uint8 and unnormalized (the model normalizes on the device);
    with `cfg.data.image_channels == 1` only the luma is shipped."""
    from ..models.ngm import PairBatch

    if cfg.ngm.hyperedge:
        raise NotImplementedError(
            "hyperedge batches are not ported to fpmatch_tpu_torch yet "
            "(ROADMAP.md, Queue A: hyperedge/VGG/GCN/QAP extras)")
    B = len(samples)
    N, E = cfg.shapes.n_max, cfg.shapes.e_max
    H, W = cfg.data.rescale[1], cfg.data.rescale[0]
    C = cfg.data.image_channels

    images = np.zeros((B, 2, H, W, C), np.uint8)
    points = np.zeros((B, 2, N, 2), np.float32)
    src = np.zeros((B, 2, E), np.int32)
    dst = np.zeros((B, 2, E), np.int32)
    n_nodes = np.zeros((B, 2), np.int32)
    n_edges = np.zeros((B, 2), np.int32)
    gt_perm = np.zeros((B, N, N), np.float32)
    label = np.zeros((B,), np.float32)

    for b, s in enumerate(samples):
        for v in range(2):
            img = s.images[v]
            if C == 1 and img.ndim == 3 and img.shape[2] == 3:
                img = rgb_to_gray(img)
            if img.ndim == 2:
                img = img[..., None]
            images[b, v, :img.shape[0], :img.shape[1]] = img[:H, :W]
            P = s.points[v][:N]
            points[b, v, :len(P)] = P
            n_nodes[b, v] = len(P)
            sv, dv = s.edges[v]
            src[b, v, :len(sv)] = sv
            dst[b, v, :len(dv)] = dv
            n_edges[b, v] = len(sv)
        p = s.perm[:N, :N]
        gt_perm[b, :p.shape[0], :p.shape[1]] = p
        label[b] = s.label

    return PairBatch(images, points, n_nodes, src, dst, n_edges, gt_perm,
                     label, gt_perm.sum((1, 2)).astype(np.float32))
