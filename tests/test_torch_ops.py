"""fpmatch_tpu_torch.ops vs fpmatch_tpu.ops on the CPU: the same numpy inputs
through the JAX function (single pair, looped over the batch) and its
batch-native PyTorch counterpart. float32 ops agree to 1e-5 unless a test
states otherwise."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.ops import assoc as j_assoc
from fpmatch_tpu.ops import feature_align as j_fa
from fpmatch_tpu.ops import masking as j_mask
from fpmatch_tpu.ops import sinkhorn as j_sk
from fpmatch_tpu.ops import soft_topk as j_topk
from fpmatch_tpu.ops import spline as j_spline
from fpmatch_tpu_torch.ops import assoc as t_assoc
from fpmatch_tpu_torch.ops import feature_align as t_fa
from fpmatch_tpu_torch.ops import masking as t_mask
from fpmatch_tpu_torch.ops import sinkhorn as t_sk
from fpmatch_tpu_torch.ops import soft_topk as t_topk
from fpmatch_tpu_torch.ops import spline as t_spline
from test_torch_utils import t2n

TOL = dict(rtol=1e-5, atol=1e-5)
# mixed orientations in one batch: n1 < n2, n1 > n2, n1 == n2, a full
# bucket, and a 1-row problem
COUNTS = [(5, 9), (9, 5), (7, 7), (10, 10), (1, 6)]


def tt(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- masking

def test_masks_match(rng):
    n1 = np.array([3, 0, 8], np.int32)
    n2 = np.array([5, 4, 8], np.int32)
    got = t2n(t_mask.rect_mask(tt(n1), tt(n2), 8, 9))
    want = np.stack([np.asarray(j_mask.rect_mask(a, b, 8, 9))
                     for a, b in zip(n1, n2)])
    assert np.array_equal(got, want)
    assert np.array_equal(t2n(t_mask.length_mask(tt(n1), 8)),
                          np.arange(8)[None] < n1[:, None])


@pytest.mark.parametrize("axis", [0, 1])
def test_masked_logsumexp_matches(rng, axis):
    x = rng.normal(size=(6, 7)).astype(np.float32) * 5
    mask = rng.uniform(size=(6, 7)) < 0.6
    mask[2] = False            # an empty row -> -inf, no NaN
    mask[:, 3] = False
    want = np.asarray(j_mask.masked_logsumexp(jnp.asarray(x),
                                              jnp.asarray(mask), axis))
    got = t2n(t_mask.masked_logsumexp(tt(x), tt(mask), axis))
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------- sinkhorn

@pytest.mark.parametrize("max_iter", [5, 10])
@pytest.mark.parametrize("dummy_row", [True, False])
@pytest.mark.parametrize("shape", [(10, 10), (10, 12)])
def test_sinkhorn_batch_mixed_orientations(rng, shape, dummy_row, max_iter):
    """Per-sample transpose: one batch mixes n1 < n2, n1 > n2 and n1 == n2,
    on the square bucket (transpose form) and a rectangular pad (dual form).
    """
    s1, s2 = shape
    s = rng.normal(size=(len(COUNTS), s1, s2)).astype(np.float32)
    n1 = np.array([c[0] for c in COUNTS], np.int32)
    n2 = np.array([c[1] for c in COUNTS], np.int32)
    want = np.stack([np.asarray(j_sk.sinkhorn(
        jnp.asarray(s[b]), int(n1[b]), int(n2[b]), tau=0.1,
        max_iter=max_iter, dummy_row=dummy_row)) for b in range(len(COUNTS))])
    got = t2n(t_sk.sinkhorn_batch(tt(s), tt(n1), tt(n2), tau=0.1,
                                  max_iter=max_iter, dummy_row=dummy_row))
    np.testing.assert_allclose(got, want, **TOL)
    # zero outside the valid block
    for b, (a, c) in enumerate(COUNTS):
        assert got[b, a:].sum() == 0 and got[b, :, c:].sum() == 0


def test_sinkhorn_single_pair_and_model_temperature(rng):
    """tau = 0.01 (the model's) divides scores by 0.01 before 20 sweeps;
    float32 rounding of the inputs is amplified 100x, hence 1e-4."""
    s = rng.uniform(size=(12, 12)).astype(np.float32)
    want = np.asarray(j_sk.sinkhorn(jnp.asarray(s), 9, 11, tau=0.01,
                                    max_iter=20))
    got = t2n(t_sk.sinkhorn(tt(s), 9, 11, tau=0.01, max_iter=20))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- soft top-k

@pytest.mark.parametrize("max_iter,extra_iter", [(10, 6), (5, 3), (4, 0)])
def test_soft_topk_batch_matches(rng, max_iter, extra_iter):
    """k = 0 (impostor: exact zero map), fractional k, k = total, in one
    batch with mixed orientations."""
    B = len(COUNTS)
    scores = rng.uniform(size=(B, 10, 10)).astype(np.float32)
    n1 = np.array([c[0] for c in COUNTS], np.int32)
    n2 = np.array([c[1] for c in COUNTS], np.int32)
    ks = np.array([0.0, 3.4, 49.0, 2.0, 0.5], np.float32)
    want = np.stack([np.asarray(j_topk.soft_topk(
        jnp.asarray(scores[b]), jnp.float32(ks[b]), jnp.int32(n1[b]),
        jnp.int32(n2[b]), tau=0.05, max_iter=max_iter,
        extra_iter=extra_iter)) for b in range(B)])
    got = t2n(t_topk.soft_topk_batch(tt(scores), tt(ks), tt(n1), tt(n2),
                                     tau=0.05, max_iter=max_iter,
                                     extra_iter=extra_iter))
    assert np.isfinite(got).all()
    assert (got[0] == 0).all()                 # k == 0 -> exact zeros
    np.testing.assert_allclose(got, want, **TOL)


def test_soft_topk_single_pair_form(rng):
    scores = rng.uniform(size=(8, 9)).astype(np.float32)
    want = np.asarray(j_topk.soft_topk(jnp.asarray(scores), jnp.float32(3.0),
                                       jnp.int32(6), jnp.int32(9), tau=0.05))
    got = t2n(t_topk.soft_topk(tt(scores), 3.0, 6, 9, tau=0.05))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(10, 10), (8, 11)])
def test_greedy_perm_batch_exact(rng, shape):
    """0/1 output must be identical, ties (duplicated scores) included;
    k rounds half to even; k beyond min(n1, n2) saturates."""
    s1, s2 = shape
    B = len(COUNTS)
    rank = rng.uniform(size=(B, s1, s2)).astype(np.float32)
    rank[2] = np.round(rank[2] * 4) / 4        # many exact ties
    n1 = np.minimum(np.array([c[0] for c in COUNTS], np.int32), s1)
    n2 = np.minimum(np.array([c[1] for c in COUNTS], np.int32), s2)
    ks = np.array([2.5, 3.5, 4.2, 50.0, 0.0], np.float32)
    want = np.stack([np.asarray(j_topk.greedy_perm(
        jnp.asarray(rank[b]), jnp.float32(ks[b]), jnp.int32(n1[b]),
        jnp.int32(n2[b]))) for b in range(B)])
    got = t2n(t_topk.greedy_perm_batch(tt(rank), tt(ks), tt(n1), tt(n2)))
    assert np.array_equal(got, want)
    assert (got.sum(1) <= 1).all() and (got.sum(2) <= 1).all()
    assert got[0].sum() == 2 and got[1].sum() == 4 and got[4].sum() == 0
    one = t2n(t_topk.greedy_perm(tt(rank[1]), 3.5, int(n1[1]), int(n2[1])))
    assert np.array_equal(one, want[1])


# ------------------------------------------------------------ feature align

def test_feature_align_rectangular(rng):
    """x scales with W_f / W and y with H_f / H (a rectangular map tells the
    two apart); points on and beyond the border clamp."""
    B, hf, wf, C, N = 3, 7, 10, 6, 9
    feat = rng.normal(size=(B, hf, wf, C)).astype(np.float32)
    pts = rng.uniform([0, 0], [320, 240], size=(B, N, 2)).astype(np.float32)
    pts[0, 0] = [0, 0]
    pts[0, 1] = [319.9, 239.9]
    pts[0, 2] = [400, -5]
    want = np.stack([np.asarray(j_fa.feature_align(
        jnp.asarray(feat[b]), jnp.asarray(pts[b]), (320, 240)))
        for b in range(B)])
    got = t2n(t_fa.feature_align(tt(feat), tt(pts), (320, 240)))
    np.testing.assert_allclose(got, want, **TOL)


def test_normalize_over_channels(rng):
    x = rng.normal(size=(4, 5, 8)).astype(np.float32)
    x[0, 0] = 0
    want = np.asarray(j_fa.normalize_over_channels(jnp.asarray(x)))
    np.testing.assert_allclose(t2n(t_fa.normalize_over_channels(tt(x))),
                               want, **TOL)


# ------------------------------------------------------------------ spline

def _graphs(rng, G, n_max, e_max, n_lo):
    pts = np.zeros((G, n_max, 2), np.float32)
    src = np.zeros((G, e_max), np.int32)
    dst = np.zeros((G, e_max), np.int32)
    nn = np.zeros(G, np.int32)
    ne = np.zeros(G, np.int32)
    for g in range(G):
        n = int(rng.integers(n_lo, n_max + 1))
        P = rng.uniform([8, 8], [312, 232], size=(n, 2)).astype(np.float32)
        _, s, d = build_edges(P)
        s, d = s[:e_max], d[:e_max]
        pts[g, :n], nn[g], ne[g] = P, n, len(s)
        src[g, :len(s)], dst[g, :len(d)] = s, d
    return pts, src, dst, nn, ne


def test_spline_basis_matches(rng):
    u = rng.uniform(-0.1, 1.1, size=(20, 2)).astype(np.float32)
    u[0] = [1.0, 0.0]
    want = np.asarray(j_spline.spline_basis(jnp.asarray(u), 5))
    got = t2n(t_spline.spline_basis(tt(u), 5))
    np.testing.assert_allclose(got, want, **TOL)
    assert ((got != 0).sum(1) <= 4).all()


@pytest.mark.parametrize("aggr", ["max", "add", "mean"])
def test_spline_conv_matches(rng, aggr):
    """Padded edges alias node 0 and are masked; graph 0 has an isolated
    node (no incoming edge -> 0 under max) and nodes whose only incoming
    edges are masked."""
    G, n_max, e_max, cin, cout = 3, 10, 40, 6, 5
    pts, src, dst, nn, ne = _graphs(rng, G, n_max, e_max, 6)
    ne[0] = min(ne[0], 12)                     # mask most of graph 0's edges
    x = rng.normal(size=(G, n_max, cin)).astype(np.float32)
    w = rng.normal(size=(25, cin, cout)).astype(np.float32) * 0.3
    wr = rng.normal(size=(cin, cout)).astype(np.float32) * 0.3
    b = rng.normal(size=(cout,)).astype(np.float32)
    nmask = np.arange(n_max)[None] < nn[:, None]
    emask = np.arange(e_max)[None] < ne[:, None]
    x = x * nmask[..., None]
    pseudo_t = t_spline.edge_pseudo_coords(tt(pts), tt(src), tt(dst), 320.0)
    got = t2n(t_spline.spline_conv(tt(x), tt(src), tt(dst), pseudo_t, tt(w),
                                   tt(wr), tt(b), tt(emask), tt(nmask),
                                   kernel_size=5, aggr=aggr))
    for g in range(G):
        pseudo = j_spline.edge_pseudo_coords(jnp.asarray(pts[g]), src[g],
                                             dst[g], 320.0)
        np.testing.assert_allclose(t2n(pseudo_t[g]), np.asarray(pseudo),
                                   **TOL)
        want = np.asarray(j_spline.spline_conv(
            jnp.asarray(x[g]), src[g], dst[g], pseudo, jnp.asarray(w),
            jnp.asarray(wr), jnp.asarray(b), jnp.asarray(emask[g]),
            jnp.asarray(nmask[g]), kernel_size=5, aggr=aggr))
        np.testing.assert_allclose(got[g], want, rtol=1e-5, atol=2e-5)


def test_spline_conv_kernel_cell_order(rng):
    """The tap form must index the kernel bank with dim 0 slowest, like the
    dense basis: compare against an explicit basis contraction."""
    n, e, cin, cout = 6, 14, 4, 3
    x = rng.normal(size=(1, n, cin)).astype(np.float32)
    src = rng.integers(0, n, size=(1, e)).astype(np.int32)
    dst = rng.integers(0, n, size=(1, e)).astype(np.int32)
    u = rng.uniform(size=(1, e, 2)).astype(np.float32)
    w = rng.normal(size=(25, cin, cout)).astype(np.float32)
    zeros = np.zeros((cin, cout), np.float32)
    got = t2n(t_spline.spline_conv(
        tt(x), tt(src), tt(dst), tt(u), tt(w), tt(zeros),
        tt(np.zeros(cout, np.float32)), torch.ones(1, e, dtype=torch.bool),
        torch.ones(1, n, dtype=torch.bool), aggr="add"))[0]
    basis = t2n(t_spline.spline_basis(tt(u[0]), 5))
    msg = np.einsum("es,ei,sio->eo", basis, x[0][src[0]], w)
    want = np.zeros((n, cout), np.float32)
    np.add.at(want, dst[0], msg)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------- assoc

def _assoc_inputs(rng, B, n_max, e_max, C):
    pts1, s1, d1, nn1, ne1 = _graphs(rng, B, n_max, e_max, 5)
    pts2, s2, d2, nn2, ne2 = _graphs(rng, B, n_max, e_max, 5)
    X = rng.normal(size=(B, n_max, n_max, C)).astype(np.float32)
    Kp = rng.normal(size=(B, n_max, n_max)).astype(np.float32)
    Ke = rng.normal(size=(B, e_max, e_max)).astype(np.float32)
    e1m = np.arange(e_max)[None] < ne1[:, None]
    e2m = np.arange(e_max)[None] < ne2[:, None]
    Ke = Ke * (e1m[:, :, None] & e2m[:, None, :])   # padded slots carry 0
    return X, Kp, Ke, s1, d1, s2, d2, e1m, e2m, nn1, nn2


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("C", [1, 5])
def test_assoc_matvec_matches(rng, transpose, C):
    B, n_max, e_max = 3, 9, 44
    X, Kp, Ke, s1, d1, s2, d2, *_ = _assoc_inputs(rng, B, n_max, e_max, C)
    got = t2n(t_assoc.assoc_matvec(tt(X), tt(Kp), tt(Ke), tt(s1), tt(d1),
                                   tt(s2), tt(d2), transpose=transpose))
    for b in range(B):
        want = np.asarray(j_assoc.assoc_matvec(
            jnp.asarray(X[b]), jnp.asarray(Kp[b]), jnp.asarray(Ke[b]),
            s1[b], d1[b], s2[b], d2[b], transpose=transpose))
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("chunk", [16, 20, 64])
def test_assoc_matvec_chunked_matches_one_shot(rng, chunk):
    B, n_max, e_max, C = 2, 9, 44, 3
    X, Kp, Ke, s1, d1, s2, d2, *_ = _assoc_inputs(rng, B, n_max, e_max, C)
    args = (tt(X), tt(Kp), tt(Ke), tt(s1), tt(d1), tt(s2), tt(d2))
    want = t2n(t_assoc.assoc_matvec(*args, transpose=True))
    got = t2n(t_assoc.assoc_matvec_chunked(*args, transpose=True,
                                           chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    want_j = np.asarray(j_assoc.assoc_matvec_chunked(
        jnp.asarray(X[0]), jnp.asarray(Kp[0]), jnp.asarray(Ke[0]), s1[0],
        d1[0], s2[0], d2[0], transpose=True, chunk=chunk))
    np.testing.assert_allclose(got[0], want_j, rtol=1e-5, atol=2e-5)


def test_assoc_matvec_auto_dispatch(rng, monkeypatch):
    B, n_max, e_max, C = 1, 8, 40, 2
    X, Kp, Ke, s1, d1, s2, d2, *_ = _assoc_inputs(rng, B, n_max, e_max, C)
    args = (tt(X), tt(Kp), tt(Ke), tt(s1), tt(d1), tt(s2), tt(d2))
    calls = []
    real = t_assoc.assoc_matvec_chunked
    monkeypatch.setattr(t_assoc, "assoc_matvec_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    small = t2n(t_assoc.assoc_matvec_auto(*args, transpose=True))
    assert not calls
    monkeypatch.setattr(t_assoc, "CHUNKED_NNZ_THRESHOLD", 100)
    big = t2n(t_assoc.assoc_matvec_auto(*args, transpose=True))
    assert calls
    np.testing.assert_allclose(big, small, rtol=1e-5, atol=2e-5)


def test_assoc_matvec_bf16_gather_f32_accumulate(rng):
    """bf16 X: gathers and the Ke multiply in bf16, both segment sums in
    f32, f32 result — as the JAX op. Products are rounded to bf16 on both
    sides but summed in another order, hence 2e-2 of the value range."""
    B, n_max, e_max, C = 1, 8, 40, 3
    X, Kp, Ke, s1, d1, s2, d2, *_ = _assoc_inputs(rng, B, n_max, e_max, C)
    Xb = tt(X).bfloat16()
    got = t_assoc.assoc_matvec(Xb, tt(Kp), tt(Ke), tt(s1), tt(d1), tt(s2),
                               tt(d2), transpose=True)
    assert got.dtype == torch.float32
    want = np.asarray(j_assoc.assoc_matvec(
        jnp.asarray(X[0]).astype(jnp.bfloat16), jnp.asarray(Kp[0]),
        jnp.asarray(Ke[0]), s1[0], d1[0], s2[0], d2[0], transpose=True))
    assert want.dtype == np.float32
    np.testing.assert_allclose(t2n(got)[0], want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("transpose", [False, True])
def test_assoc_degree_and_aggregate_mean_match(rng, transpose):
    B, n_max, e_max, C = 3, 9, 44, 4
    X, Kp, Ke, s1, d1, s2, d2, e1m, e2m, nn1, nn2 = _assoc_inputs(
        rng, B, n_max, e_max, C)
    present = ((np.arange(n_max)[None, :, None] < nn1[:, None, None])
               & (np.arange(n_max)[None, None, :] < nn2[:, None, None])
               ).astype(np.float32)
    deg = t2n(t_assoc.assoc_degree(tt(present), tt(e1m), tt(e2m), tt(s1),
                                   tt(d1), tt(s2), tt(d2), n_max, n_max,
                                   transpose=transpose))
    got = t2n(t_assoc.assoc_aggregate_mean(
        tt(X), tt(Kp), tt(Ke), tt(s1), tt(d1), tt(s2), tt(d2), tt(present),
        tt(e1m), tt(e2m), transpose=transpose))
    for b in range(B):
        jargs = (s1[b], d1[b], s2[b], d2[b])
        want_deg = np.asarray(j_assoc.assoc_degree(
            jnp.asarray(present[b]), jnp.asarray(e1m[b]),
            jnp.asarray(e2m[b]), *jargs, n_max, n_max, transpose=transpose))
        assert np.array_equal(deg[b], want_deg)
        want = np.asarray(j_assoc.assoc_aggregate_mean(
            jnp.asarray(X[b]), jnp.asarray(Kp[b]), jnp.asarray(Ke[b]), *jargs,
            jnp.asarray(present[b]), jnp.asarray(e1m[b]),
            jnp.asarray(e2m[b]), transpose=transpose))
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-5)
