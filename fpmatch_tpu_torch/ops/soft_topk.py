"""Soft top-k via Sinkhorn with 2-column marginals + greedy discretization,
batch-native (counterpart of the JAX package's `ops/soft_topk.py`).

  * every valid score is embedded as a 2-vector of negated distances to the
    {min, max} anchors of its pair's score matrix;
  * a marginal-constrained Sinkhorn pushes row mass 1 per score and column
    mass [n1*n2 - k, k] over the two anchor channels;
  * the "match" channel, back in (n1, n2) shape, is the soft top-k map.

After the fixed iterations run `extra_iter` more steps, each gated per sample
by "any valid entry > 0" through a tensor select: there is no host
synchronisation anywhere in this module, the loops have fixed trip counts.
"""
from __future__ import annotations

import torch

from ..utils.profiling import span
from .masking import NEG_INF, masked_max, masked_min, rect_mask


def _logsumexp2(log_s):
    """logsumexp over the last axis, -inf where every entry is -inf, with a
    finite gradient there (torch.logsumexp's backward gives 0 * nan at an
    all -inf row); the same arithmetic as torch.logsumexp elsewhere."""
    m = torch.amax(log_s, dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.sum(torch.exp(log_s - m_safe), dim=-1, keepdim=True)
    return torch.where(s > 0, torch.log(torch.clamp(s, min=1e-38)) + m_safe,
                       NEG_INF)


def _row_norm(log_s, valid):
    """Normalize over the 2 anchor channels of each valid score."""
    log_sum = _logsumexp2(log_s)
    out = log_s - torch.where(torch.isfinite(log_sum), log_sum, 0.0)
    out = torch.where(torch.isnan(out), NEG_INF, out)
    return torch.where(valid[..., None], out, NEG_INF)


def _col_norm(log_s, valid, log_col_prob):
    """Normalize each anchor channel over all valid scores of its sample,
    then scale to the channel marginal [n1*n2 - k, k]."""
    v = valid[..., None]
    masked = torch.where(v, log_s, NEG_INF)
    m = torch.amax(masked, dim=(1, 2), keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.sum(torch.where(v, torch.exp(masked - m_safe), 0.0),
                  dim=(1, 2), keepdim=True)
    log_sum = torch.where(s > 0, torch.log(torch.clamp(s, min=1e-38)) + m_safe,
                          NEG_INF)
    out = log_s - torch.where(torch.isfinite(log_sum), log_sum, 0.0)
    out = out + log_col_prob[:, None, None, :]
    out = torch.where(torch.isnan(out), NEG_INF, out)
    return torch.where(v, out, NEG_INF)


def soft_topk_batch(scores: torch.Tensor, ks, n1, n2, *, tau: float = 1.0,
                    max_iter: int = 10, extra_iter: int = 6) -> torch.Tensor:
    """Soft top-k maps of a batch.

    :param scores: (B, S1, S2) similarity scores (e.g. Sinkhorn output)
    :param ks: (B,) float expected number of matches
    :param n1, n2: (B,) valid counts
    :return: (B, S1, S2) soft selection probabilities, zero outside the valid
             blocks
    """
    with span("op.soft_topk"):
        B, s1, s2 = scores.shape
        dev = scores.device
        n1 = torch.as_tensor(n1, device=dev).reshape(B)
        n2 = torch.as_tensor(n2, device=dev).reshape(B)
        valid = rect_mask(n1, n2, s1, s2)                     # (B, S1, S2)
        total = (n1 * n2).to(scores.dtype)                    # (B,)

        lo = masked_min(scores, valid, dim=(1, 2))
        hi = masked_max(scores, valid, dim=(1, 2))
        anchors = torch.stack([lo, hi], dim=-1)               # (B, 2)
        dist = -torch.abs(scores[..., None] - anchors[:, None, None, :])

        log_s = torch.where(valid[..., None], dist / tau, NEG_INF)
        k = torch.minimum(torch.clamp(torch.as_tensor(
            ks, device=dev, dtype=scores.dtype).reshape(B), min=0.0), total)
        # marginals clamped away from 0 (log(0) = -inf); exp(log(1e-20))
        # underflows in the forward, and the exact zero map for k == 0 is
        # restored below
        log_col_prob = torch.log(torch.clamp(
            torch.stack([total - k, k], dim=-1), min=1e-20))  # (B, 2)

        for _ in range(max_iter // 2):
            log_s = _col_norm(_row_norm(log_s, valid), valid, log_col_prob)
        if max_iter % 2:
            log_s = _row_norm(log_s, valid)
        odd_start = bool(max_iter % 2)

        def gate(ls, upd):
            over = (torch.where(valid[..., None], ls, NEG_INF) > 0
                    ).flatten(1).any(dim=1)
            return torch.where(over[:, None, None, None], upd, ls)

        def step(ls, col: bool):
            return (_col_norm(ls, valid, log_col_prob) if col
                    else _row_norm(ls, valid))

        for _ in range(extra_iter // 2):
            log_s = gate(log_s, step(log_s, odd_start))
            log_s = gate(log_s, step(log_s, not odd_start))
        if extra_iter % 2:
            log_s = gate(log_s, step(log_s, odd_start))

        out = torch.exp(log_s[..., 1])
        # exact zero at k == 0
        out = torch.where(k[:, None, None] > 0, out, 0.0)
        return torch.where(valid, out, 0.0)


def soft_topk(scores, k, n1, n2, **kw):
    """Single-pair form: scores (S1, S2), scalar k / n1 / n2."""
    dev = scores.device
    one = lambda v, **a: torch.as_tensor(v, device=dev, **a).reshape(1)
    return soft_topk_batch(scores[None], one(k, dtype=scores.dtype), one(n1),
                           one(n2), **kw)[0]


def greedy_perm_batch(score_rank: torch.Tensor, ks, n1, n2) -> torch.Tensor:
    """Greedy one-to-one match selection: repeatedly take the global argmax
    over cells whose row and column are still free, until round(k) matches
    are kept. A fixed min(S1, S2)-trip loop of masked argmaxes over the whole
    batch; ties resolve to the lowest flat index; nothing is read back to the
    host inside the loop.

    :param score_rank: (B, S1, S2) ranking scores
    :param ks: (B,) float match counts (rounded half-to-even)
    :return: (B, S1, S2) 0/1 matrices
    """
    with span("op.greedy"):
        B, s1, s2 = score_rank.shape
        dev = score_rank.device
        n1 = torch.as_tensor(n1, device=dev).reshape(B)
        n2 = torch.as_tensor(n2, device=dev).reshape(B)
        valid = rect_mask(n1, n2, s1, s2)
        flat = torch.where(valid, score_rank, NEG_INF).reshape(B, -1).clone()
        k_round = torch.round(torch.as_tensor(ks, device=dev).reshape(B)
                              ).to(torch.int32)
        x = torch.zeros((B, s1 * s2), dtype=score_rank.dtype, device=dev)
        rows_of = torch.arange(s1 * s2, device=dev) // s2     # (S1*S2,)
        cols_of = torch.arange(s1 * s2, device=dev) % s2
        one = torch.ones((B, 1), dtype=score_rank.dtype, device=dev)

        for i in range(min(s1, s2)):
            val, idx = flat.max(dim=1, keepdim=True)          # (B, 1)
            ok = (i < k_round)[:, None] & (val > NEG_INF)     # (B, 1)
            x.scatter_(1, idx, torch.where(ok, one, x.gather(1, idx)))
            dead = (rows_of[None, :] == idx // s2) \
                | (cols_of[None, :] == idx % s2)
            flat = torch.where(ok & dead, NEG_INF, flat)
        return x.reshape(B, s1, s2)


def greedy_perm(score_rank, k, n1, n2):
    """Single-pair form."""
    dev = score_rank.device
    one = lambda v: torch.as_tensor(v, device=dev).reshape(1)
    return greedy_perm_batch(score_rank[None], one(k), one(n1), one(n2))[0]
