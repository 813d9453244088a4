"""The one generator of the benchmark's traffic: batches of synthetic
fingerprint pairs, read from a traffic file's parameters.

`synthetic_pair_batch` is a frozen copy of the program's synthetic-pair
generator (`fpmatch_tpu_torch/data/synthetic.py`, itself drawing its random
numbers in the order of the JAX package's): random keypoint clouds,
jittered genuine views with identity ground truth, impostor views with
independent clouds and a zero permutation, Delaunay edges in both
directions. It returns a dict of numpy arrays with the fields of the
program's `PairBatch`. With `host_images=False` the image noise is not
drawn on the host (the graphs then come from the generator's stream
without the image draw first); `device_images` draws it on the card
instead, which is how a run makes its batches.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

try:  # scipy >= 1.8
    from scipy.spatial import QhullError
except ImportError:  # pragma: no cover
    from scipy.spatial.qhull import QhullError

FIELDS = ("images", "points", "n_nodes", "src", "dst", "n_edges", "gt_perm",
          "label", "gt_k")


def delaunay_edges(P: np.ndarray):
    """Directed Delaunay edges of the point set P (n, 2), both directions,
    in row-major order of the adjacency matrix; the complete graph where
    the triangulation is degenerate (fewer than 3 points, collinear)."""
    n = P.shape[0]
    A = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    if n >= 3:
        try:
            simp = Delaunay(P).simplices
            A = np.zeros((n, n), np.float32)
            for i in range(3):
                for j in range(3):
                    if i != j:
                        A[simp[:, i], simp[:, j]] = 1
        except (QhullError, ValueError):
            pass
    src, dst = np.nonzero(A)
    return src.astype(np.int32), dst.astype(np.int32)


def synthetic_pair_batch(batch_size: int, n_max: int, e_max: int, *,
                         genuine_ratio=1.0, n_range=(40, 60),
                         image_hw=(240, 320), jitter=1.5, seed: int = 0,
                         host_images: bool = True) -> dict:
    """One batch of padded pairs as numpy arrays (see the module
    docstring); `jitter` is the genuine views' keypoint noise in pixels."""
    rng = np.random.default_rng(seed)
    N, E, H, W, B = n_max, e_max, image_hw[0], image_hw[1], batch_size

    images = (rng.normal(size=(B, 2, H, W, 3)).astype(np.float32)
              if host_images else None)
    points = np.zeros((B, 2, N, 2), np.float32)
    src = np.zeros((B, 2, E), np.int32)
    dst = np.zeros((B, 2, E), np.int32)
    n_nodes = np.zeros((B, 2), np.int32)
    n_edges = np.zeros((B, 2), np.int32)
    gt_perm = np.zeros((B, N, N), np.float32)
    label = np.zeros((B,), np.float32)

    for b in range(B):
        genuine = rng.uniform() < genuine_ratio
        label[b] = float(genuine)
        n = int(rng.integers(*n_range))
        base = rng.uniform([8, 8], [W - 8, H - 8], size=(n, 2)).astype(
            np.float32)
        for v in range(2):
            if genuine or v == 0:
                P = base + rng.normal(0, jitter, base.shape).astype(
                    np.float32)
            else:
                m = int(rng.integers(*n_range))
                P = rng.uniform([8, 8], [W - 8, H - 8],
                                size=(m, 2)).astype(np.float32)
            P = np.clip(P, 0, [W - 1, H - 1])
            s, d = delaunay_edges(P)
            if len(s) > E:
                raise ValueError(f"{len(s)} edges exceed e_max {E}")
            nv = len(P)
            points[b, v, :nv] = P
            src[b, v, :len(s)] = s
            dst[b, v, :len(d)] = d
            n_nodes[b, v] = nv
            n_edges[b, v] = len(s)
        if genuine:
            gt_perm[b, :n, :n] = np.eye(n)

    return dict(images=images, points=points, n_nodes=n_nodes, src=src,
                dst=dst, n_edges=n_edges, gt_perm=gt_perm, label=label,
                gt_k=gt_perm.sum((1, 2)).astype(np.float32))


def device_images(batch_size: int, image_hw, seed: int, device):
    """Standard-normal image noise (B, 2, H, W, 3) float32 drawn on the
    card from `seed` in one call."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    H, W = image_hw
    return torch.randn((batch_size, 2, H, W, 3), generator=gen,
                       device=device, dtype=torch.float32)


def make_pool(traffic: dict, batch_size: int, seed: int, device):
    """The run's pool of `traffic["pool"]` distinct batches as dicts of
    tensors on `device`: graphs drawn on the host, images on the device,
    each batch from its own seed derived from the run's."""
    import torch

    seeds = np.random.SeedSequence(seed).generate_state(traffic["pool"] * 2)
    pool = []
    for i in range(traffic["pool"]):
        host = synthetic_pair_batch(
            batch_size, traffic["n_max"], traffic["e_max"],
            genuine_ratio=traffic["genuine_ratio"],
            n_range=tuple(traffic["n_range"]),
            image_hw=tuple(traffic["image_hw"]), jitter=traffic["jitter"],
            seed=int(seeds[2 * i]), host_images=False)
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()
                 if v is not None}
        batch["images"] = device_images(batch_size, traffic["image_hw"],
                                        int(seeds[2 * i + 1]), device)
        pool.append(batch)
    return pool
