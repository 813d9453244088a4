"""Masking helpers shared by the fixed-shape ops (batch-native)."""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def length_mask(length, size: int, device=None) -> torch.Tensor:
    """(..., size) boolean mask: index < length. `length` is an int or an
    integer tensor of any shape (a trailing axis is added)."""
    if not torch.is_tensor(length):
        length = torch.as_tensor(length, device=device)
    ar = torch.arange(size, device=length.device)
    return ar < length.unsqueeze(-1)


def rect_mask(n1, n2, s1: int, s2: int) -> torch.Tensor:
    """(..., s1, s2) boolean mask of the valid top-left rectangle."""
    return (length_mask(n1, s1).unsqueeze(-1)
            & length_mask(n2, s2).unsqueeze(-2))


def masked_logsumexp(x: torch.Tensor, mask: torch.Tensor, dim,
                     keepdim: bool = False) -> torch.Tensor:
    """logsumexp over `dim` (an int or a tuple) counting only `mask`;
    -inf where the mask is empty along the reduced axes (no NaNs)."""
    neg = torch.where(mask, x, NEG_INF)
    m = torch.amax(neg, dim=dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.sum(torch.where(mask, torch.exp(neg - m_safe), 0.0), dim=dim,
                  keepdim=True)
    out = torch.where(s > 0, torch.log(torch.clamp(s, min=1e-38)) + m_safe,
                      NEG_INF)
    if not keepdim:
        dims = (dim,) if isinstance(dim, int) else tuple(dim)
        for d in sorted((d % x.dim() for d in dims), reverse=True):
            out = out.squeeze(d)
    return out


def masked_max(x, mask, init=NEG_INF, dim=None):
    v = torch.where(mask, x, init)
    return v.amax() if dim is None else v.amax(dim=dim)


def masked_min(x, mask, init=float("inf"), dim=None):
    v = torch.where(mask, x, init)
    return v.amin() if dim is None else v.amin(dim=dim)
