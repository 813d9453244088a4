"""The comparison that decides `correct`: the numbers taken from the
program's outputs against the plain reference's, each held to its limit
from the cell's file (`workloads/<cell>.json`, key `limits`).

Evaluation cells (every pair the window scored; the sampled batches' maps):
  * `k_gap`: the widest |k_prob - reference| over the window's pairs;
  * `cls_gap`: the widest |cls_prob - reference| over the window's pairs,
    the reference's classifier run on the program's greedy picks (a pick is
    a discrete output, judged by `pick_gap_p99`; the classifier by its
    probability on those picks);
  * `ds_gap`: over the sampled batches' pairs, the widest
    ||ds_mat - reference||_F / max(||reference||_F, 1), the reference's soft
    top-k taken at the program's k (k is judged by `k_gap`);
  * `pick_gap_p99`: over the sampled batches' pairs, the 99th percentile
    of a pair's pick gap: the widest amount by which one of the program's
    greedy picks lies below the best entry still free when it is taken, on
    the reference's map at the program's k, picks taken in the reference's
    order; a pick count other than round(k min(n1, n2)), a pick outside the
    valid block or two picks in one row or column read as 1 (every batch's
    pick counts, rows and columns are also checked pair by pair). The
    widest pair, `pick_gap`, is printed and not compared: one near-tie
    among some 50,000 picks, which the configuration's TF32 convolutions
    order the other way, sets it (`PERF.md` §6).

Training cells: two stretches of the program's steps, each followed by the
reference from the same state on the same batches. The set-up's first three
steps from the seed's weights:
  * `loss_gap`: the widest |total loss - reference| / |reference| of the
    steps;
  * `ds_gap_median`: per step, the median over the pairs the reference
    matches of the per-pair ||ds_mat - reference||_F / max(||reference||_F,
    1) of the forward's matching maps; the widest over the steps;
  * `grad_gap_median`: the first step's gradient as the optimizer got it
    (its first moment after one step over 1 - beta1), leaf by leaf
    | ||g|| - ||g_ref|| | / max(||g_ref||, the median leaf's ||g_ref||),
    the median over the leaves;
  * `change_gap_median`: the parameters' change over the three steps, leaf
    by leaf measured alike, the median over the leaves.
The window's first two steps, from a copy of the state the window starts
from (`window_` before the name): `window_loss_gap` and
`window_ds_gap_median` over both steps; `window_change_gap_median` and
`window_change_gap`, the median and the worst leaf of the change after the
first step. A change leaves out the leaves whose float64 reference gradient
is nought to rounding (under 1e-6 of the median leaf's): under Adam they
move by round-off alone. Printed and not compared: the worst leaf of the
first gradient and of the set-up's change, and the widest per-pair map
gap; these swing from seed to seed on sound runs, as a near-tie under
Sinkhorn or a leaf's later-step gradient does (`PERF.md` §6).
"""
from __future__ import annotations

import math

import torch


def pick_gaps(picks, ref_map, k, n1, n2):
    """Per pair, the widest gap of the program's picks on `ref_map` (see
    the module docstring). picks, ref_map (B, S, S); k (B,) the program's
    k in pairs of nodes; n1, n2 (B,)."""
    B, S1, S2 = ref_map.shape
    rows = torch.arange(S1, device=ref_map.device)
    cols = torch.arange(S2, device=ref_map.device)
    valid = (rows[None, :, None] < n1[:, None, None]) \
        & (cols[None, None, :] < n2[:, None, None])
    bad = ((picks != 0) & ~valid).flatten(1).any(1) \
        | (picks.sum(2) > 1).any(1) | (picks.sum(1) > 1).any(1) \
        | (picks.sum((1, 2)) != torch.round(k))
    # the picks of each pair in the reference's order, all pairs at once
    vals, idx = torch.where(picks != 0, ref_map, -math.inf).flatten(1).sort(
        dim=1, descending=True, stable=True)
    count = (picks != 0).sum((1, 2))
    free = valid.clone()
    widest = torch.zeros(B, device=ref_map.device)
    for t in range(min(S1, S2)):
        active = t < count
        best = torch.where(free, ref_map, -math.inf).flatten(1).amax(1)
        widest = torch.maximum(widest, torch.where(
            active, best - vals[:, t], 0.0))
        r, c = idx[:, t] // S2, idx[:, t] % S2
        used_r = (rows[None] == r[:, None]) & active[:, None]
        used_c = (cols[None] == c[:, None]) & active[:, None]
        free &= ~used_r[:, :, None] & ~used_c[:, None, :]
    return torch.where(bad, 1.0, widest)


def rel_frobenius(a, b):
    """Per pair ||a - b||_F / max(||b||_F, 1)."""
    num = torch.linalg.vector_norm((a - b).flatten(1), dim=1)
    return num / torch.clamp(torch.linalg.vector_norm(b.flatten(1), dim=1),
                             min=1.0)


def map_gaps(prog, ref):
    """Per pair `rel_frobenius` of two batches of maps; None where the
    shapes differ (pairs left out)."""
    if prog.shape != ref.shape:
        return None
    return rel_frobenius(prog.float(), ref.float())


def matched_median(gaps, ref) -> float:
    """The median of per-pair `gaps` over the pairs whose reference map is
    not all zero (a pair the reference matches nothing in reads 0 on both
    sides); 0 where there is none."""
    live = ref.flatten(1).abs().sum(1) > 0
    return float(gaps[live].median()) if bool(live.any()) else 0.0


def leaf_gaps(prog: dict, ref: dict, keep=None):
    """{leaf: | ||prog|| - ||ref|| | / max(||ref||, median leaf ||ref||)}
    over the leaves in `keep` (default: all)."""
    names = [n for n in ref if keep is None or n in keep]
    norms = {n: float(torch.linalg.vector_norm(ref[n].float())) for n in names}
    med = sorted(norms.values())[len(norms) // 2] if norms else 0.0
    # a leaf the program has no value for (no optimizer state: a step that
    # did nothing) reads as zero
    return {n: abs((float(torch.linalg.vector_norm(prog[n].float()))
                    if n in prog else 0.0) - norms[n]) / max(norms[n], med,
                                                             1e-30)
            for n in names}


def judge(numbers: dict, limits: dict):
    """[(name, value, limit, ok)] for every number that has a limit."""
    rows = []
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        rows.append((name, value, limit, ok))
    return rows
