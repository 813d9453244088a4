"""fpmatch_tpu_torch.models vs fpmatch_tpu.models, module by module, on the
CPU: Flax initialises the weights, `test_torch_utils` carries them across
with the converter's rules, the same numpy inputs go through both. float32
modules agree to 1e-4 (stated per test where tighter)."""
import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.models import afau as j_afau
from fpmatch_tpu.models import backbone as j_bb
from fpmatch_tpu.models import layers as j_layers
from fpmatch_tpu.ops.spline import edge_pseudo_coords as j_pseudo
from fpmatch_tpu_torch.models import afau as t_afau
from fpmatch_tpu_torch.models import backbone as t_bb
from fpmatch_tpu_torch.models import layers as t_layers
from fpmatch_tpu_torch.ops.spline import edge_pseudo_coords as t_pseudo
from test_torch_utils import (load_into, np_tree, randomize_batch_stats,
                              t2n)

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)


def tt(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("taps", [("layer3",), ("layer2", "layer3")])
def test_backbone_matches(rng, taps):
    """Channels-last in, channels-last out, random BatchNorm statistics (so a
    swapped mean / var would show)."""
    kw = dict(stem_channels=8, stage_channels=(8, 12, 16, 24),
              blocks_per_stage=2)
    x = rng.normal(size=(3, 48, 64, 3)).astype(np.float32)
    jm = j_bb.ResNet18Backbone(node_taps=taps, **kw)
    # jitted: one compile each instead of every convolution dispatched and
    # compiled on its own
    v = randomize_batch_stats(jax.jit(jm.init, static_argnums=2)(
        KEY, jnp.asarray(x), False))
    jn, je, jg = jax.jit(jm.apply, static_argnums=2)(v, jnp.asarray(x),
                                                      False)
    tm = load_into(t_bb.ResNet18Backbone(node_taps=taps, **kw), v["params"],
                   v["batch_stats"])
    with torch.no_grad():
        tn, te, tg = tm(tt(x))
    assert len(tn) == len(taps)
    for a, b in zip(tn, jn):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(t2n(a), np.asarray(b), **TOL)
    assert tuple(te.shape) == (3, 2, 2, 24)
    np.testing.assert_allclose(t2n(te), np.asarray(je), **TOL)
    np.testing.assert_allclose(t2n(tg), np.asarray(jg), **TOL)


def _graph_batch(rng, G, n_max, e_max):
    pts = np.zeros((G, n_max, 2), np.float32)
    src = np.zeros((G, e_max), np.int32)
    dst = np.zeros((G, e_max), np.int32)
    nn = np.zeros(G, np.int32)
    ne = np.zeros(G, np.int32)
    for g in range(G):
        n = int(rng.integers(n_max - 4, n_max + 1))
        P = rng.uniform([8, 8], [312, 232], size=(n, 2)).astype(np.float32)
        _, s, d = build_edges(P)
        s, d = s[:e_max], d[:e_max]
        pts[g, :n], nn[g], ne[g] = P, n, len(s)
        src[g, :len(s)], dst[g, :len(d)] = s, d
    return pts, src, dst, nn, ne


@pytest.mark.parametrize("num_layers", [1, 2])
def test_spline_net_matches(rng, num_layers):
    G, n_max, e_max, F = 3, 10, 48, 12
    pts, src, dst, nn, ne = _graph_batch(rng, G, n_max, e_max)
    nmask = np.arange(n_max)[None] < nn[:, None]
    emask = np.arange(e_max)[None] < ne[:, None]
    x = rng.normal(size=(G, n_max, F)).astype(np.float32) * nmask[..., None]
    jm = j_layers.SplineNet(features=F, num_layers=num_layers)
    pseudo0 = j_pseudo(jnp.asarray(pts[0]), src[0], dst[0], 320.0)
    v = jm.init(KEY, jnp.asarray(x[0]), src[0], dst[0], pseudo0,
                jnp.asarray(emask[0]), jnp.asarray(nmask[0]))
    # Flax zero-initialises the spline biases; give them values
    p = np_tree(v["params"])
    for i in range(num_layers):
        p[f"conv{i}_bias"] = rng.normal(size=(F,)).astype(np.float32)
    tm = load_into(t_layers.SplineNet(F, num_layers=num_layers), p)
    with torch.no_grad():
        got = t2n(tm(tt(x), tt(src), tt(dst),
                     t_pseudo(tt(pts), tt(src), tt(dst), 320.0), tt(emask),
                     tt(nmask)))
    for g in range(G):
        pseudo = j_pseudo(jnp.asarray(pts[g]), src[g], dst[g], 320.0)
        want = jm.apply({"params": p}, jnp.asarray(x[g]), src[g], dst[g],
                        pseudo, jnp.asarray(emask[g]), jnp.asarray(nmask[g]))
        np.testing.assert_allclose(got[g], np.asarray(want), **TOL)


def test_inner_product_affinity_matches(rng):
    B, n1, n2, d, gdim = 3, 7, 9, 12, 10
    X = rng.normal(size=(B, n1, d)).astype(np.float32)
    Y = rng.normal(size=(B, n2, d)).astype(np.float32)
    w = rng.normal(size=(B, gdim)).astype(np.float32)
    mask = rng.uniform(size=(B, n1, n2)) < 0.7
    jm = j_layers.InnerProductAffinity(d)
    v = jm.init(KEY, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w))
    want = jm.apply(v, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w),
                    mask=jnp.asarray(mask))
    tm = load_into(t_layers.InnerProductAffinity(d, gdim), v["params"])
    with torch.no_grad():
        got = tm(tt(X), tt(Y), tt(w), mask=tt(mask))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _assoc_layer_inputs(rng, B, N, E, C):
    pts1, s1, d1, nn1, ne1 = _graph_batch(rng, B, N, E)
    pts2, s2, d2, nn2, ne2 = _graph_batch(rng, B, N, E)
    nn1[0], nn2[0] = N - 4, N              # n1 < n2
    nn1[1], nn2[1] = N, N - 4              # n1 > n2
    e1m = np.arange(E)[None] < ne1[:, None]
    e2m = np.arange(E)[None] < ne2[:, None]
    # drop edges that touch nodes cut off above
    e1m &= (s1 < nn1[:, None]) & (d1 < nn1[:, None])
    e2m &= (s2 < nn2[:, None]) & (d2 < nn2[:, None])
    present = ((np.arange(N)[None, :, None] < nn1[:, None, None])
               & (np.arange(N)[None, None, :] < nn2[:, None, None]))
    X = rng.normal(size=(B, N, N, C)).astype(np.float32) * present[..., None]
    Kp = rng.uniform(size=(B, N, N)).astype(np.float32) * present
    Ke = rng.uniform(size=(B, E, E)).astype(np.float32) \
        * (e1m[:, :, None] & e2m[:, None, :])
    return (X, Kp, Ke, s1, d1, s2, d2, present.astype(np.float32), e1m, e2m,
            nn1, nn2)


@pytest.mark.parametrize("C,sk_channel", [(1, 1), (9, 1), (9, 0)])
def test_assoc_gnn_layer_matches(rng, C, sk_channel):
    """The bucket-scale layer (aggregation inside), batch mixing n1 < n2 and
    n1 > n2. The embedded Sinkhorn at tau = 0.05 amplifies float32 rounding
    of its input 20x: 1e-4."""
    B, N, E = 3, 10, 48
    (X, Kp, Ke, s1, d1, s2, d2, present, e1m, e2m, nn1, nn2) = \
        _assoc_layer_inputs(rng, B, N, E, C)
    jm = j_layers.AssocGNNLayer(out_features=8, sk_channel=sk_channel,
                                sk_iter=6, sk_tau=0.05)
    jargs = lambda b: (jnp.asarray(X[b]), jnp.asarray(Kp[b]),
                       jnp.asarray(Ke[b]), s1[b], d1[b], s2[b], d2[b],
                       jnp.asarray(present[b]), jnp.asarray(e1m[b]),
                       jnp.asarray(e2m[b]), int(nn1[b]), int(nn2[b]))
    v = jm.init(KEY, *jargs(0))
    tm = load_into(t_layers.AssocGNNLayer(C, 8, sk_channel=sk_channel,
                                          sk_iter=6, sk_tau=0.05),
                   v["params"])
    with torch.no_grad():
        got = t2n(tm(tt(X), tt(Kp), tt(Ke), tt(s1), tt(d1), tt(s2), tt(d2),
                     tt(present), tt(e1m), tt(e2m), tt(nn1), tt(nn2)))
    assert got.shape == (B, N, N, 8 + sk_channel)
    for b in range(B):
        want = jm.apply(v, *jargs(b))
        np.testing.assert_allclose(got[b], np.asarray(want), **TOL)


def test_assoc_gnn_layer_batched_matches(rng):
    """The caller-aggregated layer of the UNIV route; same parameter tree as
    AssocGNNLayer (one state_dict serves both)."""
    B, N, C = 2, 9, 5
    X = rng.normal(size=(B, N, N, C)).astype(np.float32)
    agg = rng.normal(size=(B, N, N, C)).astype(np.float32)
    n1 = np.array([9, 6], np.int32)
    n2 = np.array([7, 9], np.int32)
    present = ((np.arange(N)[None, :, None] < n1[:, None, None])
               & (np.arange(N)[None, None, :] < n2[:, None, None])
               ).astype(np.float32)
    jm = j_layers.AssocGNNLayerBatched(out_features=8, sk_channel=1,
                                       sk_iter=5, sk_tau=0.05)
    jargs = (jnp.asarray(X), jnp.asarray(agg), jnp.asarray(present),
             jnp.asarray(n1), jnp.asarray(n2))
    v = jm.init(KEY, *jargs)
    want = jm.apply(v, *jargs)
    tm = load_into(t_layers.AssocGNNLayerBatched(C, 8, sk_iter=5,
                                                 sk_tau=0.05), v["params"])
    with torch.no_grad():
        got = tm(tt(X), tt(agg), tt(present), tt(n1), tt(n2))
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)
    assert set(tm.state_dict()) == set(
        t_layers.AssocGNNLayer(C, 8).state_dict())


@pytest.mark.parametrize("S", [12, 13])
def test_match_classifier_matches(rng, S):
    """Masked pooling levels use ceil(n / 2**shift) per sample; an odd bucket
    exercises the floor of the 2x2 max-pool. Random BatchNorm statistics."""
    B = 4
    m = rng.normal(size=(B, S, S)).astype(np.float32)
    n1 = np.array([S, 5, 9, 1], np.int32)
    n2 = np.array([S, 11, 3, 7], np.int32)
    jm = j_layers.MatchClassifier(channels=(6, 10))
    v = randomize_batch_stats(jm.init(KEY, jnp.asarray(m), jnp.asarray(n1),
                                      jnp.asarray(n2)))
    want = jm.apply(v, jnp.asarray(m), jnp.asarray(n1), jnp.asarray(n2))
    tm = load_into(t_layers.MatchClassifier(channels=(6, 10)), v["params"],
                   v["batch_stats"])
    with torch.no_grad():
        got = tm(tt(m), tt(n1), tt(n2))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_masked_instance_norm_matches(rng):
    x = rng.normal(size=(3, 8, 6)).astype(np.float32)
    mask = np.arange(8)[None] < np.array([8, 3, 0])[:, None]
    scale = rng.normal(size=(6,)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    got = t2n(t_afau.masked_instance_norm(tt(x), tt(mask), tt(scale),
                                          tt(bias)))
    for b in range(3):
        want = j_afau.masked_instance_norm(
            jnp.asarray(x[b]), jnp.asarray(mask[b]), jnp.asarray(scale),
            jnp.asarray(bias))
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S,univ", [(12, 16), (12, 8)])
def test_afau_encoder_matches(rng, S, univ):
    """Full AFA-U head with its untouched U(-10, 10) score-mixing init, on a
    generic cost matrix; univ < S exercises position rows beyond the one-hot
    width. Batch mixes n1 < n2, n1 > n2, full bucket."""
    B = 3
    cost = rng.uniform(size=(B, S, S)).astype(np.float32)
    n1 = np.array([9, 12, 12], np.int32)
    n2 = np.array([11, 7, 12], np.int32)
    jm = j_afau.AFAUEncoder(univ_size=univ, reg_hidden=4)
    v = jm.init(KEY, jnp.asarray(cost[0]), 9, 11)
    tm = load_into(t_afau.AFAUEncoder(univ, 4), v["params"])
    with torch.no_grad():
        got = t2n(tm(tt(cost), tt(n1), tt(n2)))
    assert got.shape == (B,)
    for b in range(B):
        want = jm.apply(v, jnp.asarray(cost[b]), int(n1[b]), int(n2[b]))
        np.testing.assert_allclose(got[b], float(want), **TOL)


@pytest.mark.parametrize("plateau", [0.0, 0.5])
def test_backbone_max_pools_route_ties_as_flax(rng, plateau):
    """The backbone's two max-pools — the stem's 3x3 / stride 2 / pad 1
    window and the global max over layer4 — route the gradient of a tied
    maximum as Flax's `max_pool` (XLA's select_and_scatter: the first
    maximum in the window) and `jnp.max` (split evenly among the ties) do,
    on a post-ReLU input where most windows tie: at 0, or at a plateau."""
    x = np.maximum(rng.normal(size=(2, 9, 11, 3)), 0).astype(np.float32)
    x[x > 0.8] = plateau if plateau else x[x > 0.8]
    x[:, 2:5, 3:7] = plateau                       # a whole tied block
    g_pool = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    g_max = rng.normal(size=(2, 3)).astype(np.float32)

    def jax_loss(v):
        p = flax_nn.max_pool(v, (3, 3), strides=(2, 2),
                             padding=((1, 1), (1, 1)))
        return jnp.sum(p * g_pool) + jnp.sum(jnp.max(v, axis=(1, 2)) * g_max)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    pool = t_bb.ResNet18Backbone(stem_channels=8,
                                 stage_channels=(8, 8, 8, 8)).pool
    xt = tt(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    p = pool(xt).permute(0, 2, 3, 1)
    loss = (p * tt(g_pool)).sum() + (xt.amax(dim=(2, 3)) * tt(g_max)).sum()
    loss.backward()
    got = t2n(xt.grad.permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
