"""Masked log-space Sinkhorn normalization on fixed shapes, batch-native.

Contract (same as the JAX package's `ops/sinkhorn.py`): divide by tau, pad
the short side with dummy log-value -100 so the problem is square over
m = max(n1, n2), alternate row (even step) / column (odd step) logsumexp
normalization for `max_iter` steps, exponentiate, zero the dummy region.
A sample with n1 > n2 is the transposed problem: which axis the even step
normalizes, and where the dummy band lives, flip PER SAMPLE.

`sinkhorn_batch` runs a CUDA float32 square bucket of S <= 128 on the
hand-written kernels (`kernels.sinkhorn`, one launch a call and one a
backward: `kernels.sinkhorn.takes_kernel` is the rule) and every other call
on the plain ops of `sinkhorn_batch_plain`, counted in PLAIN_CALLS.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels import sinkhorn as sk_kernel
from ..utils.profiling import span
from .masking import NEG_INF, masked_logsumexp

DUMMY_LOG = -100.0

# calls of `sinkhorn_batch` that ran the plain ops (beside the kernels'
# kernels.sinkhorn.LAUNCHES: the kernels' share of the calls)
PLAIN_CALLS: Dict[str, int] = {"sinkhorn_plain": 0}


def _normalize(log_s, region, dim):
    """One masked normalization sweep along `dim` (dim=-1 normalizes rows)."""
    log_sum = masked_logsumexp(log_s, region, dim=dim, keepdim=True)
    out = log_s - torch.where(torch.isfinite(log_sum), log_sum, 0.0)
    return torch.where(region, out, NEG_INF)


def sinkhorn_batch(s: torch.Tensor, n1, n2, *, tau: float = 1.0,
                   max_iter: int = 10, dummy_row: bool = True
                   ) -> torch.Tensor:
    """Doubly-stochastic normalization of each sample's valid (n1, n2) block.

    :param s: (B, S1, S2) scores, garbage outside the valid blocks
    :param n1, n2: (B,) integer valid counts
    :return: (B, S1, S2) DS matrices, zero outside the valid blocks
    """
    with span("op.sinkhorn"):
        if sk_kernel.takes_kernel(s, max_iter):
            return sk_kernel.sinkhorn_kernel(s, n1, n2, tau=tau,
                                             max_iter=max_iter,
                                             dummy_row=dummy_row)
        PLAIN_CALLS["sinkhorn_plain"] += 1
        return sinkhorn_batch_plain(s, n1, n2, tau=tau, max_iter=max_iter,
                                    dummy_row=dummy_row)


def sinkhorn_batch_plain(s: torch.Tensor, n1, n2, *, tau: float = 1.0,
                         max_iter: int = 10, dummy_row: bool = True
                         ) -> torch.Tensor:
    """`sinkhorn_batch` on plain PyTorch ops, on any device and shape."""
    B, s1, s2 = s.shape
    dev = s.device
    n1 = torch.as_tensor(n1, device=dev).reshape(B, 1, 1)
    n2 = torch.as_tensor(n2, device=dev).reshape(B, 1, 1)
    rows = torch.arange(s1, device=dev).reshape(1, s1, 1)
    cols = torch.arange(s2, device=dev).reshape(1, 1, s2)
    valid = (rows < n1) & (cols < n2)

    log_s = torch.where(valid, s / tau, NEG_INF)

    orient_rows = n1 <= n2                     # (B, 1, 1)
    if dummy_row:
        # dummy band: extra rows n1..n2 (orient_rows) or extra cols n2..n1
        dummy_r = (rows >= n1) & (rows < n2) & (cols < n2)
        dummy_c = (cols >= n2) & (cols < n1) & (rows < n1)
        dummy = torch.where(orient_rows, dummy_r, dummy_c)
        log_s = torch.where(dummy, DUMMY_LOG, log_s)
        region = valid | dummy
    else:
        region = valid

    if s1 == s2:
        # square bucket: transpose the flipped samples up front, run the
        # row-first loop for everybody, transpose back
        flip = ~orient_rows
        ls = torch.where(flip, log_s.transpose(1, 2), log_s)
        reg = torch.where(flip, region.transpose(1, 2), region)
        for _ in range(max_iter // 2):
            ls = _normalize(_normalize(ls, reg, -1), reg, -2)
        if max_iter % 2:
            ls = _normalize(ls, reg, -1)
        log_s = torch.where(flip, ls.transpose(1, 2), ls)
    else:
        # rectangular pad: both axis normalizations + a per-sample select
        def half(ls, even: bool):
            axis1 = _normalize(ls, region, -1)
            axis0 = _normalize(ls, region, -2)
            return torch.where(orient_rows == even, axis1, axis0)

        for _ in range(max_iter // 2):
            log_s = half(half(log_s, True), False)
        if max_iter % 2:
            log_s = half(log_s, True)
    return torch.where(valid, torch.exp(log_s), 0.0)


def sinkhorn(s: torch.Tensor, n1, n2, *, tau: float = 1.0, max_iter: int = 10,
             dummy_row: bool = True) -> torch.Tensor:
    """Single-pair form: s (S1, S2), scalar counts."""
    n1 = torch.as_tensor(n1, device=s.device).reshape(1)
    n2 = torch.as_tensor(n2, device=s.device).reshape(1)
    return sinkhorn_batch(s[None], n1, n2, tau=tau, max_iter=max_iter,
                          dummy_row=dummy_row)[0]


def gumbel_sinkhorn(s: torch.Tensor, n1, n2, *, tau: float = 1.0,
                    max_iter: int = 10, sample_num: int = 5,
                    dummy_row: bool = True, u: torch.Tensor = None,
                    generator: torch.Generator = None) -> torch.Tensor:
    """Gumbel-Sinkhorn sampling (reference src/model/sinkhorn.py:172-235,
    Mena et al. ICLR'18): i.i.d. Gumbel noise -log(-log(u)) added to the
    scores, then the masked Sinkhorn per sample.

    :param s: (S1, S2) scores of one pair; n1, n2 its valid counts
    :param u: (sample_num, S1, S2) uniforms in [1e-20, 1); drawn from
        `generator` (on s's device; None: torch's default) when not given
        (the JAX package draws them from its PRNG key, which torch cannot
        reproduce, so a caller that needs its samples passes its draws)
    :return: (sample_num, S1, S2)
    """
    if u is None:
        u = torch.rand((sample_num,) + tuple(s.shape), generator=generator,
                       device=s.device, dtype=s.dtype)
        u = 1e-20 + u * (1.0 - 1e-20)
    g = -torch.log(-torch.log(u))
    k = u.shape[0]
    ones = torch.ones(k, dtype=torch.long, device=s.device)
    return sinkhorn_batch(s[None] + g, ones * int(n1), ones * int(n2),
                          tau=tau, max_iter=max_iter, dummy_row=dummy_row)
