"""Classical QAP solving on the factorized association affinity (the JAX
package's `ops/qap.py`; reference QAPDataset pathway, gmdataset.py:530-560):
given the affinity factors, max vec(X)^T K vec(X) over (partial)
permutations X.

A fixed-trip power iteration (spectral matching, Leordeanu-Hebert) through
the factorized matvec, then a sharpened Sinkhorn projection: K is never
materialized. Each matvec is `ops.assoc.assoc_matvec_auto` on a batch of
one, so on a CUDA tensor every iteration launches the hand-written
association kernel, K2 (`assoc_bucket`) at bucket scale and K3
(`assoc_large`) from `CHUNKED_NNZ_THRESHOLD` association edges up. Padded
edge slots carry Ke == 0 (or are marked off by `e1_mask` / `e2_mask`).
"""
from __future__ import annotations

import torch

from .assoc import assoc_matvec_auto
from .sinkhorn import sinkhorn


def _matvec(x, Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask):
    """K vec(x) for one (S1, S2) matrix x: the dispatch on a batch of one."""
    one = lambda t: None if t is None else t[None]
    return assoc_matvec_auto(x[None, ..., None], Kp[None], Ke[None],
                             src1[None], dst1[None], src2[None], dst2[None],
                             e1_mask=one(e1_mask),
                             e2_mask=one(e2_mask))[0, ..., 0]


def qap_power_sinkhorn(Kp: torch.Tensor, Ke: torch.Tensor, src1, dst1, src2,
                       dst2, n1, n2, *, iters: int = 20, sk_iter: int = 10,
                       tau: float = 0.05, e1_mask=None, e2_mask=None
                       ) -> torch.Tensor:
    """Soft QAP solution of one pair: `iters` power-iteration steps on the
    association affinity from the uniform start over the valid (n1, n2)
    block (each renormalized to unit Frobenius norm), the eigenvector
    contrast-normalized by its largest valid entry, then
    `sinkhorn(tau, sk_iter, dummy_row=True)`. Discretize the (S1, S2)
    result with `ops.soft_topk.greedy_perm` or `ops.hungarian`.

    :param Kp: (S1, S2) node affinities; Ke (E1, E2) edge affinities
    :param src1, dst1: (E1,) graph-1 edges; src2, dst2 (E2,)
    :param n1, n2: valid counts
    :param e1_mask, e2_mask: (E1,), (E2,) True on real edge slots (optional)
    """
    s1, s2 = Kp.shape
    dev = Kp.device
    valid = ((torch.arange(s1, device=dev)[:, None] < n1)
             & (torch.arange(s2, device=dev)[None, :] < n2))
    unit = lambda y: y / torch.clamp(torch.linalg.norm(y), min=1e-12)
    x = unit(torch.where(valid, 1.0, 0.0))
    for _ in range(iters):
        y = _matvec(x, Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask)
        x = unit(torch.where(valid, y, 0.0))
    # contrast-normalize the eigenvector before the bistochastic projection
    x = x / torch.clamp(torch.amax(torch.where(valid, x, 0.0)), min=1e-12)
    return sinkhorn(x, n1, n2, tau=tau, max_iter=sk_iter, dummy_row=True)


def qap_objective(x: torch.Tensor, Kp, Ke, src1, dst1, src2, dst2,
                  e1_mask=None, e2_mask=None) -> torch.Tensor:
    """vec(X)^T K vec(X) (reference evaluation_metric.py:255-280
    objective_score) of one (S1, S2) assignment."""
    y = _matvec(x.float(), Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask)
    return torch.sum(x * y)
