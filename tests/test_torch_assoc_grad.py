"""Gradients of the port's ops on the CPU against `jax.grad` of the JAX
package's: the association matvec as one `torch.autograd.Function`
(`ops.assoc.assoc_matvec_auto`, whose backward is the forward dispatch with
the roles swapped for dX and `kernels.assoc_grad` for dKe / dKp), and the
masked Sinkhorn, soft top-k, spline convolution and feature alignment on
padded inputs, rectangular both ways.

Tolerances: float32 on both sides, only the order of sums differs, so
gradients agree to 1e-5 of each tensor's largest value (2e-5 where a
gradient passes two segment sums of up to ~40 terms). dKe is compared on the
real (e1, e2) slots only: on padded slots JAX AD gives the value of an edge
(0, 0), the port 0, and the model's `* emask` on Ke stops either. Every
gradient must be finite.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.ops import assoc as j_assoc
from fpmatch_tpu.ops import feature_align as j_fa
from fpmatch_tpu.ops import sinkhorn as j_sk
from fpmatch_tpu.ops import soft_topk as j_topk
from fpmatch_tpu.ops import spline as j_spline
from fpmatch_tpu_torch.kernels import assoc_grad as k6
from fpmatch_tpu_torch.ops import assoc as t_assoc
from fpmatch_tpu_torch.ops import feature_align as t_fa
from fpmatch_tpu_torch.ops import sinkhorn as t_sk
from fpmatch_tpu_torch.ops import soft_topk as t_topk
from fpmatch_tpu_torch.ops import spline as t_spline
from test_torch_utils import t2n

# mixed orientations: n1 < n2, n1 > n2, n1 == n2, a full bucket
COUNTS = [(5, 9), (9, 5), (7, 7), (10, 10)]


def tt(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    lim = rel * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= lim, (
        float(np.abs(got - want).max()), lim)


def _graphs(rng, B, n_max, e_max, n_lo):
    src = np.zeros((B, e_max), np.int32)
    dst = np.zeros((B, e_max), np.int32)
    ne = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(n_lo, n_max + 1))
        P = rng.uniform([8, 8], [312, 232], size=(n, 2)).astype(np.float32)
        _, s, d = build_edges(P)
        s, d = s[:e_max], d[:e_max]
        ne[b] = len(s)
        src[b, :len(s)], dst[b, :len(d)] = s, d
    return src, dst, np.arange(e_max)[None] < ne[:, None]


def _assoc_case(rng, B=3, n_max=10, e_max=40, C=3):
    s1, d1, m1 = _graphs(rng, B, n_max, e_max, 5)
    s2, d2, m2 = _graphs(rng, B, n_max, e_max, 5)
    X = rng.normal(size=(B, n_max, n_max, C)).astype(np.float32)
    Kp = rng.normal(size=(B, n_max, n_max)).astype(np.float32)
    em = m1[:, :, None] & m2[:, None, :]
    Ke = rng.normal(size=(B, e_max, e_max)).astype(np.float32) * em
    G = rng.normal(size=(B, n_max, n_max, C)).astype(np.float32)
    return X, Kp, Ke, (s1, d1, s2, d2), m1, m2, em, G


def _jax_grads(X, Kp, Ke, edges, G, transpose):
    def loss(x, kp, ke, s1, d1, s2, d2, g):
        return jnp.sum(j_assoc.assoc_matvec(x, kp, ke, s1, d1, s2, d2,
                                            transpose=transpose) * g)

    grad = jax.jit(jax.vmap(jax.grad(loss, argnums=(0, 1, 2))))
    return [np.asarray(a) for a in grad(X, Kp, Ke, *edges, G)]


def _torch_grads(fn, X, Kp, Ke, edges, G, **kw):
    x, kp, ke = tt(X, True), tt(Kp, True), tt(Ke, True)
    y = fn(x, kp, ke, *(tt(e) for e in edges), **kw)
    torch.sum(y * tt(G)).backward()
    return t2n(y), [t2n(t.grad) for t in (x, kp, ke)]


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("transpose", [True, False])
def test_assoc_function_grads_match_jax(rng, transpose, C):
    """dX, dKp in full and dKe on the real slots against jax.grad of
    fpmatch_tpu/ops/assoc.py:46 (ragged masks; the port's dKe is 0 on the
    padded ones)."""
    X, Kp, Ke, edges, m1, m2, em, G = _assoc_case(rng, C=C)
    want = _jax_grads(X, Kp, Ke, edges, G, transpose)
    _, got = _torch_grads(t_assoc.assoc_matvec_auto, X, Kp, Ke, edges, G,
                          transpose=transpose, e1_mask=tt(m1),
                          e2_mask=tt(m2))
    close(got[0], want[0], 2e-5)
    close(got[1], want[1])
    close(got[2][em], want[2][em])
    assert (got[2][~em] == 0).all()


@pytest.mark.parametrize("large", [False, True])
def test_assoc_function_matches_autograd_of_the_plain_forward(rng,
                                                              monkeypatch,
                                                              large):
    """The Function against torch.autograd through the plain ops of
    ops.assoc, on the one-shot form and (threshold lowered) the chunked
    one; without masks the padded slots' dKe agrees too."""
    if large:
        monkeypatch.setattr(t_assoc, "CHUNKED_NNZ_THRESHOLD", 100)
        monkeypatch.setattr(t_assoc, "CHUNK_E1", 16)
    X, Kp, Ke, edges, _, _, _, G = _assoc_case(rng, B=2, C=2)
    for transpose in (True, False):
        y, got = _torch_grads(t_assoc.assoc_matvec_auto, X, Kp, Ke, edges, G,
                              transpose=transpose)
        y0, want = _torch_grads(t_assoc.assoc_matvec, X, Kp, Ke, edges, G,
                                transpose=transpose)
        close(y, y0)
        for g, w in zip(got, want):
            close(g, w, 2e-5)


def test_edge_grad_plain_against_jax_without_masks(rng):
    """kernels.assoc_grad on its own, no masks: every slot (padded ones
    alias node 0) agrees with jax.grad's dKe and dKp."""
    X, Kp, Ke, edges, _, _, _, G = _assoc_case(rng, B=2, C=3)
    for transpose in (True, False):
        want = _jax_grads(X, Kp, Ke, edges, G, transpose)
        dKe, dKp = k6.assoc_edge_grad(tt(G), tt(X), *(tt(e) for e in edges),
                                      transpose=transpose)
        close(t2n(dKe), want[2])
        close(t2n(dKp), want[1])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("transpose", [True, False])
def test_edge_grad_plain_on_the_forward_plan_against_jax_vjp(rng, transpose,
                                                             masked):
    """The plain K6 reads graph 1 through the forward's grouping
    (`plan_bucket`, the kernel's own input): dKe and dKp against jax.vjp of
    fpmatch_tpu/ops/assoc.py:46 at n = 16-40, E = 120, both orientations,
    with masks (masked slots: dKe 0; the plan keeps them out of every run)
    and without (padded slots alias node 0 and get an edge (0, 0)'s
    value, as JAX AD gives it)."""
    X, Kp, Ke, edges, m1, m2, em, G = _assoc_case(rng, B=2, n_max=40,
                                                  e_max=120, C=3)

    def f(x, kp, ke):
        return jax.vmap(lambda *a: j_assoc.assoc_matvec(
            *a, transpose=transpose))(x, kp, ke, *edges)
    _, vjp = jax.vjp(f, jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke))
    _, dKp_j, dKe_j = (np.asarray(a) for a in vjp(jnp.asarray(G)))
    kw = dict(e1_mask=tt(m1), e2_mask=tt(m2)) if masked else {}
    dKe, dKp = k6.assoc_edge_grad_plain(tt(G), tt(X),
                                        *(tt(e) for e in edges),
                                        transpose=transpose, **kw)
    close(t2n(dKp), dKp_j)
    if masked:
        close(t2n(dKe)[em], dKe_j[em])
        assert (t2n(dKe)[~em] == 0).all()
    else:
        close(t2n(dKe), dKe_j)


_GEOMETRY = [
    # (B, N1, N2, C, E1, E2, itemsize), path, threads, tiles, passes
    ((8, 64, 64, 17, 384, 384, 4), "staged", 128, 3, 1),
    ((8, 64, 64, 17, 384, 384, 2), "staged", 128, 3, 1),
    ((8, 64, 64, 1, 384, 384, 4), "staged", 128, 3, 1),
    ((8, 64, 64, 33, 384, 384, 4), "staged", 128, 3, 2),
    ((2, 256, 256, 17, 1536, 1536, 4), "staged", 512, 3, 1),
    ((2, 256, 256, 64, 1536, 1536, 4), "global", 512, 3, 2),
    ((2, 256, 256, 100, 1536, 1536, 2), "global", 512, 3, 4),
    ((1, 600, 600, 17, 3840, 3840, 4), "staged", 512, 8, 1),
    ((1, 8, 8, 3, 5, 0, 4), "staged", 32, 1, 1),
]


@pytest.mark.parametrize("shape,path,threads,tiles,passes", _GEOMETRY)
def test_grad_geometry_picks_the_path(shape, path, threads, tiles, passes):
    """K6's shape rule (`grad_geometry`) at the shapes the card runs: two X
    rows within STAGE_BYTES stream through shared memory, wider rows are
    read from global memory; a block holds 2 N2 graph-2 slots (128 to 512,
    no more than E2) and a thread at most 32 channels a pass."""
    g = k6.grad_geometry(*shape)
    assert (g.path, g.threads, g.tiles, g.passes) == (path, threads, tiles,
                                                      passes)
    B, N1, N2, C, E1, E2, itemsize = shape
    assert g.threads % 32 == 0 and 32 <= g.threads <= k6.GRAD_TILE
    assert g.tiles * g.threads >= E2 and (g.tiles - 1) * g.threads < max(
        E2, 1)
    assert g.cb <= min(C, k6.GRAD_SLICE) and g.cb * g.passes >= C
    assert g.nc >= g.cb and (g.nc == 1 or g.nc % 4 == 0) and g.nc <= 32
    if g.staged:
        assert 2 * g.x_bytes == g.smem <= k6.STAGE_BYTES
        assert g.x_bytes % 16 == 0 and g.x_bytes >= N2 * g.xs * itemsize
        assert g.xs >= C and (g.nw == 0 or g.xs * itemsize == 4 * g.nw + 4)
    else:
        assert g.smem == 0 and 2 * N2 * C * itemsize > k6.STAGE_BYTES
    # nodes of an even number of words are padded by one word
    assert k6.grad_geometry(8, 64, 64, 16, 384, 384, 4)[12:14] == (17, 16)
    assert k6.grad_geometry(8, 64, 64, 16, 384, 384, 2)[12:14] == (18, 8)
    assert k6.grad_geometry(8, 64, 64, 16, 384, 384, 4,
                            x_aligned=False)[12:14] == (16, 0)


def test_edge_grad_checks_its_inputs(rng):
    X, Kp, Ke, edges, m1, m2, _, G = _assoc_case(rng, B=2, C=2)
    e = [tt(a) for a in edges]
    with pytest.raises(TypeError, match="float32"):
        k6.assoc_edge_grad(tt(G).double(), tt(X).double(), *e)
    with pytest.raises(ValueError):
        k6.assoc_edge_grad(tt(G)[:, :-1], tt(X), *e)
    with pytest.raises(TypeError, match="integer"):
        k6.assoc_edge_grad(tt(G), tt(X), e[0].float(), *e[1:])


@pytest.mark.gpu
def test_assoc_grad_kernel_and_backward_on_the_card(rng):
    """Needs a GPU and nvcc (run there with `pytest -m gpu`): K6 against its
    plain version (bit-identical over two launches) and the Function's
    gradients on CUDA tensors against the port's CPU run; chip_smoke.py makes
    the same comparisons at the training shapes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no interpret mode")
    X, Kp, Ke, edges, m1, m2, em, G = _assoc_case(rng, B=3, n_max=64,
                                                  e_max=384, C=17)
    cu = lambda a: tt(a).cuda()
    args = (cu(G), cu(X), *(cu(e) for e in edges))
    kw = dict(transpose=True, e1_mask=cu(m1), e2_mask=cu(m2))
    before = k6.LAUNCHES["assoc_grad"]
    got = k6.assoc_edge_grad(*args, **kw)
    again = k6.assoc_edge_grad(*args, **kw)
    torch.cuda.synchronize()
    assert k6.LAUNCHES["assoc_grad"] == before + 2
    want = k6.assoc_edge_grad_plain(*args, **kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        close(t2n(g), t2n(w))
    x, kp, ke = (cu(a).requires_grad_() for a in (X, Kp, Ke))
    y = t_assoc.assoc_matvec_auto(x, kp, ke, *(cu(e) for e in edges), **kw)
    torch.sum(y * cu(G)).backward()
    _, want = _torch_grads(t_assoc.assoc_matvec_auto, X, Kp, Ke, edges, G,
                           transpose=True, e1_mask=tt(m1), e2_mask=tt(m2))
    for t, w in zip((x, kp, ke), want):
        close(t2n(t.grad), w, 2e-5)


@pytest.mark.gpu
def test_assoc_grad_kernel_paths_on_the_card(rng):
    """Needs a GPU and nvcc: K6 on each path of its launcher — staged in
    one pass (C = 17), staged in two (C = 33), from global memory (C = 64
    at N = 256) — f32 and bf16 X, against its plain version (bf16: within a
    bf16 ulp of each dKe), bit-identical over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no interpret mode")
    for n_max, e_max, C in ((64, 384, 17), (64, 384, 33), (256, 1536, 64)):
        X, _, _, edges, m1, m2, _, G = _assoc_case(rng, B=2, n_max=n_max,
                                                   e_max=e_max, C=C)
        cu = lambda a: tt(a).cuda()
        for x in (cu(X), cu(X).bfloat16()):
            args = (cu(G), x, *(cu(e) for e in edges))
            kw = dict(transpose=True, e1_mask=cu(m1), e2_mask=cu(m2))
            got = k6.assoc_edge_grad(*args, **kw)
            assert all(torch.equal(a, b) for a, b in
                       zip(got, k6.assoc_edge_grad(*args, **kw)))
            want = k6.assoc_edge_grad_plain(*args, **kw)
            close(t2n(got[1]), t2n(want[1]))
            rel = 2.0 ** -7 if x.dtype == torch.bfloat16 else 1e-5
            w = t2n(want[0])
            assert np.all(np.abs(t2n(got[0]) - w)
                          <= rel * np.abs(w) + 1e-5 * np.abs(w).max())


# ------------------------------------------------------ ops used in training

def _counts():
    return (np.array([c[0] for c in COUNTS], np.int32),
            np.array([c[1] for c in COUNTS], np.int32))


@pytest.mark.parametrize("shape", [(10, 10), (10, 12), (12, 10)])
def test_sinkhorn_gradient_matches_jax(rng, shape):
    """Padded, both orientations in one batch, square and rectangular
    buckets both ways, with the dummy band (where() selects away -inf and
    log(0) branches: no NaN may leak into the gradient)."""
    s1, s2 = shape
    n1, n2 = _counts()
    n1, n2 = np.minimum(n1, s1), np.minimum(n2, s2)
    s = rng.normal(size=(len(n1), s1, s2)).astype(np.float32)
    G = rng.normal(size=s.shape).astype(np.float32)
    x = tt(s, True)
    (t_sk.sinkhorn_batch(x, tt(n1), tt(n2), tau=0.1, max_iter=6)
     * tt(G)).sum().backward()
    for b in range(len(n1)):
        want = jax.grad(lambda v: jnp.sum(j_sk.sinkhorn(
            v, int(n1[b]), int(n2[b]), tau=0.1, max_iter=6) * G[b]))(
            jnp.asarray(s[b]))
        close(t2n(x.grad[b]), np.asarray(want), 2e-5)


def test_soft_topk_gradient_matches_jax(rng):
    """k = 0 (exact zero map), fractional k and k = total, padded and
    rectangular both ways, at the layers' tau."""
    n1, n2 = _counts()
    ks = np.array([0.0, 3.4, 49.0, 2.0], np.float32)
    scores = rng.uniform(size=(len(n1), 10, 10)).astype(np.float32)
    G = rng.normal(size=scores.shape).astype(np.float32)
    x = tt(scores, True)
    (t_topk.soft_topk_batch(x, tt(ks), tt(n1), tt(n2), tau=0.05,
                            max_iter=4, extra_iter=2) * tt(G)).sum().backward()
    for b in range(len(n1)):
        want = jax.grad(lambda v: jnp.sum(j_topk.soft_topk(
            v, jnp.float32(ks[b]), jnp.int32(n1[b]), jnp.int32(n2[b]),
            tau=0.05, max_iter=4, extra_iter=2) * G[b]))(
            jnp.asarray(scores[b]))
        close(t2n(x.grad[b]), np.asarray(want), 2e-5)


def test_spline_conv_gradient_matches_jax(rng):
    """Max aggregation over a padded batch (masked edges, an isolated
    node): gradients for the features, the kernel bank, the root weight and
    the bias."""
    G_, n_max, e_max, cin, cout = 2, 10, 40, 4, 3
    src, dst, emask = _graphs(rng, G_, n_max, e_max, 6)
    nn_ = np.array([n_max, 8], np.int32)
    nmask = np.arange(n_max)[None] < nn_[:, None]
    emask[1, 10:] = False
    u = rng.uniform(size=(G_, e_max, 2)).astype(np.float32)
    x = rng.normal(size=(G_, n_max, cin)).astype(np.float32) * \
        nmask[..., None]
    w = rng.normal(size=(25, cin, cout)).astype(np.float32) * 0.3
    wr = rng.normal(size=(cin, cout)).astype(np.float32) * 0.3
    bias = rng.normal(size=(cout,)).astype(np.float32)
    Gout = rng.normal(size=(G_, n_max, cout)).astype(np.float32)
    params = [tt(a, True) for a in (x, w, wr, bias)]
    out = t_spline.spline_conv(params[0], tt(src), tt(dst), tt(u),
                               *params[1:], tt(emask), tt(nmask))
    (out * tt(Gout)).sum().backward()

    def loss(xv, wv, wrv, bv):
        tot = 0.0
        for g in range(G_):
            tot = tot + jnp.sum(j_spline.spline_conv(
                xv[g], src[g], dst[g], jnp.asarray(u[g]), wv, wrv, bv,
                jnp.asarray(emask[g]), jnp.asarray(nmask[g])) * Gout[g])
        return tot

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(x, w, wr, bias)
    for p, w_ in zip(params, want):
        close(t2n(p.grad), np.asarray(w_), 2e-5)


def test_feature_align_and_normalize_gradients_match_jax(rng):
    """Bilinear sampling (points on and past the border) after channel
    normalization: the gradient w.r.t. the feature map."""
    B, hf, wf, C, N = 2, 7, 10, 5, 9
    feat = rng.normal(size=(B, hf, wf, C)).astype(np.float32)
    pts = rng.uniform([0, 0], [320, 240], size=(B, N, 2)).astype(np.float32)
    pts[0, 0], pts[0, 1], pts[0, 2] = [0, 0], [319.9, 239.9], [400, -5]
    G = rng.normal(size=(B, N, C)).astype(np.float32)
    f = tt(feat, True)
    (t_fa.feature_align(t_fa.normalize_over_channels(f), tt(pts), (320, 240))
     * tt(G)).sum().backward()
    want = jax.grad(lambda v: sum(jnp.sum(j_fa.feature_align(
        j_fa.normalize_over_channels(v[b]), jnp.asarray(pts[b]), (320, 240))
        * G[b]) for b in range(B)))(jnp.asarray(feat))
    close(t2n(f.grad), np.asarray(want))
