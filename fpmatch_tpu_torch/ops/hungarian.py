"""Hungarian (maximum-score) assignment, solved on the host.

The reference keeps the LAP solve on the CPU (utils/hungarian.py:8-65, scipy
with a multiprocessing pool); here the host solve is the port's native
OpenMP-batched LAPJV solver (`native.lap_maximize_batch`). `hungarian` is the
counterpart of the JAX package's `pure_callback` version: one copy of the
scores to the host, the host solve, the mask back on the scores' device.
Non-differentiable by construction, as the reference's is.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def hungarian_host(scores, n1, n2) -> np.ndarray:
    """Batched maximum-score assignment on the valid (n1, n2) blocks.

    :param scores: (B, S1, S2) or (S1, S2) numpy array or tensor
    :param n1, n2: (B,) valid sizes (scalars for a 2-D `scores`)
    :return: (B, S1, S2) float32 0/1 numpy mask ((1, S1, S2) for 2-D input)
    """
    scores = _host(scores).astype(np.float32, copy=False)
    n1, n2 = _host(n1), _host(n2)
    if scores.ndim == 2:
        scores, n1, n2 = scores[None], np.atleast_1d(n1), np.atleast_1d(n2)
    return native.lap_maximize_batch(scores, n1, n2)


@torch.no_grad()
def hungarian(scores: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor
              ) -> torch.Tensor:
    """`hungarian_host` on tensors: the 0/1 mask, float32, on the scores'
    device, of the scores' shape ((B, S1, S2) or (S1, S2))."""
    mask = torch.from_numpy(hungarian_host(scores, n1, n2))
    mask = mask.to(scores.device)
    return mask[0] if scores.ndim == 2 else mask
