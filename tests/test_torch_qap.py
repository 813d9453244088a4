"""The port's QAP solver and library layers against the JAX package's on
the CPU, on the same numpy inputs (within 1e-5 unless a test says so):

  * `ops.qap`: a planted QAP (tests/test_ops.py's, on Delaunay graphs with
    padded edge slots) at n = 8 / 12 / 32: the soft assignment, the same
    greedy result, the objective;
  * `ops.assoc.assoc_matvec_fused`, `assoc_dense`, `edge_incidence_gather`;
  * `core.graph`: `make_graph`, `pad_points`, the masks, the bucket errors;
  * `models.gcn` (`Gconv`, `ChannelIndependentConv`, `SiameseGconv`) and
    `models.layers.BilinearAffinity` / `DenseAssocGNNLayer` from converted
    Flax weights;
  * `ops.spline.spline_conv` on 1-D and 3-D pseudo-coordinates.

The JAX functions are single-pair and run per sample; the port's are
batch-native.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.core import graph as j_graph
from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.models import gcn as j_gcn
from fpmatch_tpu.models import layers as j_layers
from fpmatch_tpu.ops import assoc as j_assoc
from fpmatch_tpu.ops import qap as j_qap
from fpmatch_tpu.ops import spline as j_spline
from fpmatch_tpu.ops.soft_topk import greedy_perm as j_greedy
from fpmatch_tpu_torch.core import graph as t_graph
from fpmatch_tpu_torch.models import gcn as t_gcn
from fpmatch_tpu_torch.models import layers as t_layers
from fpmatch_tpu_torch.ops import assoc as t_assoc
from fpmatch_tpu_torch.ops import qap as t_qap
from fpmatch_tpu_torch.ops import spline as t_spline
from fpmatch_tpu_torch.ops.soft_topk import greedy_perm as t_greedy
from test_torch_utils import flax_init, load_into, t2n

TOL = dict(rtol=1e-5, atol=1e-5)


def tt(a):
    return torch.from_numpy(np.asarray(a))


def delaunay(rng, n, e_max):
    """n uniform points in 320 x 240 and their Delaunay edges (both
    directions), padded to e_max slots with node 0."""
    P = rng.uniform([0, 0], [320, 240], size=(n, 2)).astype(np.float32)
    _, s, d = build_edges(P)
    s, d = s[:e_max], d[:e_max]
    pad = lambda a: np.concatenate(
        [a, np.zeros(e_max - len(a), np.int64)]).astype(np.int32)
    return P, pad(s), pad(d), len(s)


def planted_qap(rng, n, e_max):
    """tests/test_ops.py's planted QAP: graph 2 is graph 1 under a random
    permutation, Kp high on the planted matches, Ke 1 on the real edge
    pairs (0 on padded slots)."""
    _, s1, d1, E = delaunay(rng, n, e_max)
    perm = rng.permutation(n).astype(np.int32)
    s2, d2 = perm[s1], perm[d1]
    s2[E:], d2[E:] = 0, 0
    Kp = (np.eye(n)[perm] + 0.05 * rng.uniform(size=(n, n))).astype(
        np.float32)
    Ke = np.zeros((e_max, e_max), np.float32)
    Ke[:E, :E] = 1.0
    mask = np.arange(e_max) < E
    return perm, Kp, Ke, s1, d1, s2, d2, mask


@pytest.mark.parametrize("n,e_max,iters", [(8, 48, 30), (32, 192, 20)])
def test_qap_power_sinkhorn_matches_and_recovers(n, e_max, iters):
    rng = np.random.default_rng(n)
    perm, Kp, Ke, s1, d1, s2, d2, mask = planted_qap(rng, n, e_max)
    want = np.asarray(j_qap.qap_power_sinkhorn(
        jnp.asarray(Kp), jnp.asarray(Ke), jnp.asarray(s1), jnp.asarray(d1),
        jnp.asarray(s2), jnp.asarray(d2), n, n, iters=iters, tau=0.05))
    args = [tt(a) for a in (Kp, Ke, s1, d1, s2, d2)]
    got = t_qap.qap_power_sinkhorn(*args, n, n, iters=iters, tau=0.05)
    np.testing.assert_allclose(t2n(got), want, **TOL)
    masked = t_qap.qap_power_sinkhorn(*args, n, n, iters=iters, tau=0.05,
                                      e1_mask=tt(mask), e2_mask=tt(mask))
    np.testing.assert_allclose(t2n(masked), want, **TOL)
    hard_w = np.asarray(j_greedy(jnp.asarray(want), float(n), n, n))
    hard = t2n(t_greedy(got, float(n), n, n))
    assert np.array_equal(hard, hard_w)
    assert hard[np.arange(n), perm].mean() >= 0.9
    obj_w = float(j_qap.qap_objective(jnp.asarray(hard), *[
        jnp.asarray(a) for a in (Kp, Ke, s1, d1, s2, d2)]))
    obj = float(t_qap.qap_objective(tt(hard), *args))
    np.testing.assert_allclose(obj, obj_w, rtol=1e-6)
    assert obj > 0


def test_qap_on_a_partial_block():
    """Valid counts below the bucket: zero outside the (n1, n2) block."""
    rng = np.random.default_rng(4)
    perm, Kp, Ke, s1, d1, s2, d2, _ = planted_qap(rng, 12, 64)
    args = (Kp, Ke, s1, d1, s2, d2)
    want = np.asarray(j_qap.qap_power_sinkhorn(
        *[jnp.asarray(a) for a in args], 10, 12, iters=10, sk_iter=7))
    got = t2n(t_qap.qap_power_sinkhorn(*[tt(a) for a in args], 10, 12,
                                       iters=10, sk_iter=7))
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[10:] == 0).all()


def _assoc_inputs(rng, B, n, e_max, C):
    X = rng.normal(size=(B, n, n, C)).astype(np.float32)
    Kp = rng.normal(size=(B, n, n)).astype(np.float32)
    Ke = rng.normal(size=(B, e_max, e_max)).astype(np.float32)
    edges = []
    for _ in range(2):
        g = [delaunay(rng, n, e_max) for _ in range(B)]
        edges += [np.stack([x[1] for x in g]), np.stack([x[2] for x in g])]
        counts = np.array([x[3] for x in g])
        m = np.arange(e_max)[None] < counts[:, None]
        Ke = Ke * (m[:, :, None] if len(edges) == 2 else m[:, None, :])
    return X, Kp, Ke, edges


def test_assoc_matvec_fused_matches():
    """Both orientations, against JAX's and against the gather form."""
    rng = np.random.default_rng(5)
    X, Kp, Ke, (s1, d1, s2, d2) = _assoc_inputs(rng, 2, 12, 40, 3)
    args = (X, Kp, Ke, s1, d1, s2, d2)
    for transpose in (False, True):
        got = t2n(t_assoc.assoc_matvec_fused(*[tt(a) for a in args],
                                             transpose=transpose))
        plain = t2n(t_assoc.assoc_matvec(*[tt(a) for a in args],
                                         transpose=transpose))
        for b in range(2):
            want = np.asarray(j_assoc.assoc_matvec_fused(
                *[jnp.asarray(a[b]) for a in args], transpose=transpose))
            np.testing.assert_allclose(got[b], want, **TOL)
        np.testing.assert_allclose(got, plain, **TOL)


def test_assoc_dense_and_incidence_gather():
    """Column-major vec indexing, e1-outer / e2-inner flattening, duplicate
    entries added; K vec(X) through the dense K equals the factorized
    product."""
    rng = np.random.default_rng(6)
    n = 7
    X, Kp, Ke, (s1, d1, s2, d2) = _assoc_inputs(rng, 2, n, 24, 1)
    s1[:, 1] = s1[:, 0]
    d1[:, 1] = d1[:, 0]                    # a duplicate edge
    got = t2n(t_assoc.assoc_dense(*[tt(a) for a in (Kp, Ke, s1, d1, s2,
                                                    d2)], n, n))
    assert got.shape == (2, n * n, n * n)
    for b in range(2):
        want = np.asarray(j_assoc.assoc_dense(
            *[jnp.asarray(a[b]) for a in (Kp, Ke, s1, d1, s2, d2)], n, n))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-6)
        vx = X[b, :, :, 0].T.reshape(-1)   # vec(X), column-major
        y = t2n(t_assoc.assoc_matvec(*[tt(a[b:b + 1]) for a in (
            X, Kp, Ke, s1, d1, s2, d2)]))[0, :, :, 0]
        np.testing.assert_allclose((got[b] @ vx).reshape(n, n).T, y,
                                   rtol=1e-4, atol=1e-4)
    F = rng.normal(size=(2, n, 5)).astype(np.float32)
    got = t2n(t_assoc.edge_incidence_gather(tt(F), tt(s1), tt(d1)))
    for b in range(2):
        want = np.asarray(j_assoc.edge_incidence_gather(
            jnp.asarray(F[b]), s1[b], d1[b]))
        assert np.array_equal(got[b], want)


def test_make_graph_and_masks():
    rng = np.random.default_rng(7)
    P, s, d, E = delaunay(rng, 9, 64)
    tri = rng.integers(0, 9, size=(20, 3)).astype(np.int32)
    want = j_graph.make_graph(P, s[:E], d[:E], tri, 12, 48, 16)
    got = t_graph.make_graph(P, s[:E], d[:E], tri, 12, 48, 16)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, name
        assert np.array_equal(t2n(a), np.asarray(b)), name
    for m in ("node_mask", "edge_mask", "tri_mask"):
        assert np.array_equal(t2n(getattr(got, m)()),
                              np.asarray(getattr(want, m)())), m
    assert (got.n_max, got.e_max) == (want.n_max, want.e_max) == (12, 48)
    assert np.array_equal(t_graph.pad_points(P, 5), j_graph.pad_points(P, 5))
    pair = t_graph.GraphPair(got, got, None, torch.eye(12), torch.tensor(1.),
                             torch.tensor(9.)).to("cpu")
    assert pair.images is None and pair.g1.src.dtype == torch.int32
    for bad in ((8, 48), (12, E - 1)):
        with pytest.raises(ValueError, match="exceed bucket"):
            t_graph.make_graph(P, s[:E], d[:E], tri, *bad, 16)


def _graph_batch(rng, B, n, e_max, F):
    g = [delaunay(rng, int(rng.integers(n - 3, n + 1)), e_max)
         for _ in range(B)]
    src = np.stack([x[1] for x in g])
    dst = np.stack([x[2] for x in g])
    emask = np.arange(e_max)[None] < np.array([x[3] for x in g])[:, None]
    nmask = np.arange(n)[None] < np.array([len(x[0]) for x in g])[:, None]
    x = rng.normal(size=(B, n, F)).astype(np.float32)
    return x, src, dst, emask, nmask


def test_gconv_and_siamese_gconv():
    rng = np.random.default_rng(8)
    x, src, dst, em, nm = _graph_batch(rng, 2, 14, 64, 6)
    jm = j_gcn.Gconv(5)
    v = flax_init(jm, x[0], src[0], dst[0], em[0], nm[0])
    tm = load_into(t_gcn.Gconv(6, 5), v["params"])
    got = t2n(tm(*[tt(a) for a in (x, src, dst, em, nm)]))
    for b in range(2):
        want = np.asarray(jm.apply(v, x[b], src[b], dst[b], em[b], nm[b]))
        np.testing.assert_allclose(got[b], want, **TOL)
    js = j_gcn.SiameseGconv(5)
    pair = tuple((x[b], src[b], dst[b], em[b], nm[b]) for b in range(2))
    vs = flax_init(js, pair)
    ts = load_into(t_gcn.SiameseGconv(6, 5), vs["params"])
    want = js.apply(vs, pair)
    got = ts(tuple(tuple(tt(a)[None] for a in p) for p in pair))
    for g, w in zip(got, want):
        np.testing.assert_allclose(t2n(g)[0], np.asarray(w), **TOL)


def test_channel_independent_conv():
    rng = np.random.default_rng(9)
    x, src, dst, em, nm = _graph_batch(rng, 2, 14, 64, 6)
    ef = rng.normal(size=(2, 64, 4)).astype(np.float32)
    jm = j_gcn.ChannelIndependentConv(5)
    v = flax_init(jm, x[0], ef[0], src[0], dst[0], em[0], nm[0])
    tm = load_into(t_gcn.ChannelIndependentConv(6, 4, 5), v["params"])
    node, edge = tm(*[tt(a) for a in (x, ef, src, dst, em, nm)])
    for b in range(2):
        wn, we = jm.apply(v, x[b], ef[b], src[b], dst[b], em[b], nm[b])
        np.testing.assert_allclose(t2n(node)[b], np.asarray(wn), **TOL)
        np.testing.assert_allclose(t2n(edge)[b], np.asarray(we), **TOL)


def test_bilinear_affinity_and_dense_assoc_gnn_layer():
    rng = np.random.default_rng(10)
    X = rng.normal(size=(2, 6, 8)).astype(np.float32)
    Y = rng.normal(size=(2, 7, 8)).astype(np.float32)
    mask = (rng.uniform(size=(2, 6, 7)) < 0.8).astype(np.float32)
    jb = j_layers.BilinearAffinity(8)
    v = flax_init(jb, X, Y)
    assert np.array_equal(np.asarray(v["params"]["A"]), np.eye(8))
    assert torch.equal(t_layers.BilinearAffinity(8).A, torch.eye(8))
    # an asymmetric A: (A + A^T) / 2 taken at use
    v = {"params": {"A": rng.normal(size=(8, 8)).astype(np.float32)}}
    tb = load_into(t_layers.BilinearAffinity(8), v["params"])
    for m in (None, mask):
        want = np.asarray(jb.apply(v, X, Y, m))
        got = t2n(tb(tt(X), tt(Y), None if m is None else tt(m)))
        np.testing.assert_allclose(got, want, **TOL)

    n = 5
    _, Kp, Ke, (s1, d1, s2, d2) = _assoc_inputs(rng, 1, n, 20, 1)
    K = t2n(t_assoc.assoc_dense(*[tt(a) for a in (Kp, Ke, s1, d1, s2, d2)],
                                n, n))[0]
    Xa = rng.normal(size=(n * n, 6)).astype(np.float32)
    am = np.arange(n * n) < 22
    jd = j_layers.DenseAssocGNNLayer(7)
    v = flax_init(jd, K, Xa, am)
    td = load_into(t_layers.DenseAssocGNNLayer(6, 7), v["params"])
    want = np.asarray(jd.apply(v, K, Xa, am))
    got = t2n(td(tt(K)[None], tt(Xa)[None], tt(am)[None]))[0]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dim,aggr", [(1, "max"), (3, "mean")])
def test_spline_conv_other_dimensions(dim, aggr):
    """The dense-basis branch: K = 5**dim kernel matrices."""
    rng = np.random.default_rng(11)
    x, src, dst, em, nm = _graph_batch(rng, 2, 12, 48, 4)
    u = rng.uniform(-0.1, 1.1, size=(2, 48, dim)).astype(np.float32)
    w = (0.3 * rng.normal(size=(5 ** dim, 4, 3))).astype(np.float32)
    wr = (0.3 * rng.normal(size=(4, 3))).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    got = t2n(t_spline.spline_conv(*[tt(a) for a in (
        x, src, dst, u, w, wr, bias, em, nm)], kernel_size=5, aggr=aggr))
    for b in range(2):
        want = np.asarray(j_spline.spline_conv(
            jnp.asarray(x[b]), src[b], dst[b], jnp.asarray(u[b]),
            jnp.asarray(w), jnp.asarray(wr), jnp.asarray(bias),
            jnp.asarray(em[b]), jnp.asarray(nm[b]), kernel_size=5,
            aggr=aggr))
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=2e-5)
