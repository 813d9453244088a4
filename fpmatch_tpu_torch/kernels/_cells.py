"""The channel split of the cell kernels, K2 (`assoc_bucket`) and K4
(`assoc_univ`), where lanes own output cells and hold their channels in
registers."""
from __future__ import annotations

from typing import Tuple

import torch


def channel_tiling(X: torch.Tensor) -> Tuple[int, bool]:
    """How the cell kernels split the channels of X (last axis) among the
    lanes that own a cell: (channels per lane, whether they are read as one
    16-byte vector). 16 bytes per lane (4 f32 / 8 bf16 channels) where C is a
    multiple of that and X is 16-byte aligned; otherwise one lane holds all
    of the cell's channels with scalar loads (32 registers, of which
    min(C, 32) are live; 1 at C = 1), which was faster at C = 17 than a lane
    per channel. The kernels cut larger C into chunks of 32."""
    C = X.shape[-1]
    vec = 16 // X.element_size()
    if C % vec == 0 and X.data_ptr() % 16 == 0:
        return vec, True
    return (1 if C == 1 else 32), False


def bucket_tiling(X: torch.Tensor) -> Tuple[int, bool]:
    """K2's split: 16-byte vectors where `channel_tiling` takes them;
    otherwise two lanes share a cell, each holding half of min(C, 32)
    channels rounded up to even (10 at C = 17; 1 at C = 1), so a lane
    carries at most a dead channel or two, and bf16 X is read and
    multiplied two channels at a time (the splits it was chosen against
    are in PERF.md)."""
    nc, vec = channel_tiling(X)
    C = X.shape[-1]
    if vec or C == 1:
        return nc, vec
    return 2 * -(-min(C, 32) // 4), False
