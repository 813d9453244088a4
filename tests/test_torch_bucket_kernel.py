"""The port's batched association matvec kernels (kernels/assoc_bucket) on
the CPU: their plain PyTorch versions — the functions the CUDA kernels are
held against on the card — versus the JAX package's Pallas kernels in
interpret mode (`assoc_matvec_pallas`, `assoc_matvec_pallas_large`, small
blocks as tests/test_pallas.py runs them) and versus the gather/segment-sum
op. Inputs come from a numpy seed and go to both sides; f32, sums taken in
another order: rtol = atol = 1e-4, the limits of tests/test_pallas.py."""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.kernels.assoc_pallas import (assoc_matvec_pallas,
                                              assoc_matvec_pallas_large)
from fpmatch_tpu.ops.assoc import assoc_matvec as j_assoc_matvec
from fpmatch_tpu_torch.kernels import assoc_bucket as kb
from fpmatch_tpu_torch.kernels._cells import bucket_tiling, channel_tiling
from fpmatch_tpu_torch.ops import assoc as t_assoc
from test_torch_utils import t2n

TOL = dict(rtol=1e-4, atol=1e-4)


def tt(a):
    return torch.from_numpy(np.asarray(a))


def _rand_case(rng, B, n1, n2, e1, e2, c, valid1=None, valid2=None):
    """Random edge lists as tests/test_pallas.py draws them (`integers`:
    duplicate edges and self-loops are legal input). With valid1 / valid2
    (per-sample counts) the slots past the count are padding: they alias node
    0 and carry Ke == 0."""
    idx = [rng.integers(0, n, size=(B, e)).astype(np.int32)
           for n, e in ((n1, e1), (n1, e1), (n2, e2), (n2, e2))]
    X = rng.normal(size=(B, n1, n2, c)).astype(np.float32)
    Kp = rng.normal(size=(B, n1, n2)).astype(np.float32)
    Ke = rng.normal(size=(B, e1, e2)).astype(np.float32)
    m1 = np.ones((B, e1), bool)
    m2 = np.ones((B, e2), bool)
    if valid1 is not None:
        m1 = np.arange(e1)[None] < np.asarray(valid1)[:, None]
        m2 = np.arange(e2)[None] < np.asarray(valid2)[:, None]
        for a in idx[:2]:
            a[~m1] = 0
        for a in idx[2:]:
            a[~m2] = 0
        Ke = Ke * m1[:, :, None] * m2[:, None, :]
    return X, Kp, Ke.astype(np.float32), idx, m1, m2


def _jax_per_sample(fn, X, Kp, Ke, idx, **kw):
    return np.stack([np.asarray(fn(
        jnp.asarray(X[b]), jnp.asarray(Kp[b]), jnp.asarray(Ke[b]),
        *(jnp.asarray(a[b]) for a in idx), **kw)) for b in range(len(X))])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_bucket_plain_matches_pallas_interpret_and_xla(rng, transpose, B):
    X, Kp, Ke, idx, _, _ = _rand_case(rng, B, 16, 16, 64, 64, 8)
    got = t2n(kb.assoc_matvec_bucket(tt(X), tt(Kp), tt(Ke),
                                     *(tt(a) for a in idx),
                                     transpose=transpose))
    assert got.dtype == np.float32 and got.shape == X.shape
    want = _jax_per_sample(j_assoc_matvec, X, Kp, Ke, idx,
                           transpose=transpose)
    np.testing.assert_allclose(got, want, **TOL)
    pallas = _jax_per_sample(assoc_matvec_pallas, X, Kp, Ke, idx,
                             transpose=transpose, block_e1=32,
                             interpret=True)
    np.testing.assert_allclose(got, pallas, **TOL)
    own = t2n(t_assoc.assoc_matvec(tt(X), tt(Kp), tt(Ke),
                                   *(tt(a) for a in idx),
                                   transpose=transpose))
    np.testing.assert_allclose(got, own, **TOL)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_large_plain_matches_pallas_large_interpret_and_xla(rng, transpose,
                                                            B):
    """C = 5 with block_c = 2: an odd channel count, the last chunk short;
    n1 != n2 and E1 != E2."""
    X, Kp, Ke, idx, _, _ = _rand_case(rng, B, 16, 12, 64, 48, 5)
    got = t2n(kb.assoc_matvec_large(tt(X), tt(Kp), tt(Ke),
                                    *(tt(a) for a in idx),
                                    transpose=transpose, block_c=2))
    want = _jax_per_sample(j_assoc_matvec, X, Kp, Ke, idx,
                           transpose=transpose)
    np.testing.assert_allclose(got, want, **TOL)
    pallas = _jax_per_sample(
        assoc_matvec_pallas_large, X, Kp, Ke, idx, transpose=transpose,
        block_e1=32, block_e2=16, block_c=2, precision="highest",
        interpret=True)
    np.testing.assert_allclose(got, pallas, **TOL)
    for block_c in (1, 5, 8):
        other = t2n(kb.assoc_matvec_large(
            tt(X), tt(Kp), tt(Ke), *(tt(a) for a in idx),
            transpose=transpose, block_c=block_c))
        np.testing.assert_allclose(other, got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_c", [1, 8, 32, 33])
def test_large_plain_channel_slices_match_pallas_large(rng, block_c):
    """C = 33, wider than the 32 channels a thread of the CUDA kernel holds:
    the plain any-size version gives the JAX kernel's result whatever the
    channel slice (one channel, the old default 8, the new default 32 —
    slices of 32 and 1 — and all 33 in one JAX block)."""
    X, Kp, Ke, idx, _, _ = _rand_case(rng, 2, 16, 12, 64, 48, 33)
    got = t2n(kb.assoc_matvec_large(tt(X), tt(Kp), tt(Ke),
                                    *(tt(a) for a in idx), transpose=True,
                                    block_c=block_c))
    pallas = _jax_per_sample(
        assoc_matvec_pallas_large, X, Kp, Ke, idx, transpose=True,
        block_e1=32, block_e2=16, block_c=block_c, precision="highest",
        interpret=True)
    np.testing.assert_allclose(got, pallas, **TOL)


# (B, N, E, C, itemsize) of every K3 case chip_smoke.py runs -> the path
# and channel slices the launcher takes
_PHASE3 = [
    ((8, 64, 64, 1, 384, 384, 4), "staged", 1, 1),
    ((8, 64, 64, 17, 384, 384, 4), "staged", 17, 1),
    ((8, 64, 64, 17, 384, 384, 2), "staged", 17, 1),
    ((2, 256, 256, 1, 1536, 1536, 4), "staged", 1, 1),
    ((2, 256, 256, 17, 1536, 1536, 4), "staged", 17, 1),
    ((2, 256, 256, 17, 1536, 1536, 2), "staged", 17, 1),
    ((1, 600, 600, 17, 3840, 3840, 4), "staged", 17, 1),
    ((1, 600, 600, 17, 3840, 3840, 2), "staged", 17, 1),
    ((2, 256, 256, 33, 1536, 1536, 4), "staged", 32, 2),
    ((2, 256, 256, 16, 1536, 1536, 4), "staged", 16, 1),
    ((3, 64, 64, 5, 384, 384, 4), "staged", 5, 1),
    ((1, 4, 4096, 17, 1, 24530, 4), "global", 17, 1),
    ((1, 4, 4096, 17, 1, 24530, 2), "global", 17, 1),
]


@pytest.mark.parametrize("shape,path,cb,chunks", _PHASE3)
def test_large_geometry_picks_the_path(shape, path, cb, chunks):
    """The any-size kernel's shape rule (`large_geometry`) at the shapes the
    card runs: rows that fit one block and two (Ke row, X row) buffers in
    112 KB stream through shared memory — B=1 / N=600 / E=3840 at C=17 f32
    just fits — and the 4096-column row reads from global memory over
    column tiles."""
    g = kb.large_geometry(*shape)
    assert (g.path, g.cb, g.chunks) == (path, cb, chunks)
    B, N1, N2, C, E1, E2, itemsize = shape
    assert g.nc >= g.cb and (g.nc == 1 or g.nc % 4 == 0) and g.nc <= 32
    assert g.threads % 32 == 0 and 32 <= g.threads <= kb.LARGE_TILE
    assert g.cb * g.chunks >= C > g.cb * (g.chunks - 1)
    if g.staged:
        assert N2 <= g.threads
        assert g.ke_bytes % 16 == 0 and g.ke_bytes >= 4 * E2
        assert g.x_bytes % 16 == 0 and g.x_bytes >= N2 * g.xs * itemsize
        assert 2 * (g.ke_bytes + g.x_bytes) <= g.smem <= kb.LARGE_STAGE_BYTES
        assert 4 * N2 * g.ts <= g.smem and g.ts % 2 == 1 and g.ts >= g.cb
    else:
        assert N2 > kb.LARGE_TILE or g.smem == 0
        assert -(-N2 // g.threads) > 1


def test_large_geometry_pads_even_nodes_and_slices_channels():
    """Staged nodes of an even number of 32-bit words get one word of
    padding (not when X is only 2-byte aligned); block_c slices the channels
    up to 32, the registers of a thread, and must be >= 1; a row that does
    not fit two buffers in the budget reads from global memory."""
    g = kb.large_geometry(2, 256, 256, 16, 1536, 1536, 4)
    assert (g.nw, g.xs) == (16, 17)
    g = kb.large_geometry(2, 256, 256, 4, 1536, 1536, 2)
    assert (g.nw, g.xs) == (2, 6)
    g = kb.large_geometry(2, 256, 256, 4, 1536, 1536, 2, x_aligned=False)
    assert (g.nw, g.xs) == (0, 4)
    for C, itemsize in ((17, 4), (1, 4), (17, 2), (33, 4), (5, 2)):
        g = kb.large_geometry(2, 256, 256, C, 1536, 1536, itemsize)
        assert (g.nw, g.xs) == (0, C)
    assert [kb.large_geometry(1, 8, 8, 33, 8, 8, 4, bc)[6:8]
            for bc in (1, 8, 32, 33, 64)] == [(1, 33), (8, 5), (32, 2),
                                               (32, 2), (32, 2)]
    with pytest.raises(ValueError):
        kb.large_geometry(1, 8, 8, 3, 8, 8, 4, 0)
    # E2 = 30000: one Ke row is 120 KB
    assert kb.large_geometry(1, 64, 64, 1, 8, 30000, 4).path == "global"
    # C = 32 at N = 600: 2 x (15 KB + 79 KB) is over the budget
    assert kb.large_geometry(1, 600, 600, 32, 3840, 3840, 4).path == "global"


@pytest.mark.parametrize("kernel", ["bucket", "large"])
@pytest.mark.parametrize("masked", [False, True])
def test_padded_slots_are_inert(rng, kernel, masked):
    """Ragged batch: 40 / 25 / 0 real edges in 64 slots. Padded slots alias
    node 0 with Ke == 0; with masks they are skipped, without they multiply
    by zero. Either way the result is that of the real edges alone (the JAX
    op on the unpadded lists)."""
    v1, v2 = [40, 25, 0], [33, 64, 10]
    X, Kp, Ke, idx, m1, m2 = _rand_case(rng, 3, 12, 12, 64, 64, 4, v1, v2)
    fn = kb.assoc_matvec_bucket if kernel == "bucket" \
        else kb.assoc_matvec_large
    kw = dict(e1_mask=tt(m1), e2_mask=tt(m2)) if masked else {}
    got = t2n(fn(tt(X), tt(Kp), tt(Ke), *(tt(a) for a in idx),
                 transpose=True, **kw))
    for b in range(3):
        want = np.asarray(j_assoc_matvec(
            jnp.asarray(X[b]), jnp.asarray(Kp[b]),
            jnp.asarray(Ke[b, :v1[b], :v2[b]]),
            idx[0][b, :v1[b]], idx[1][b, :v1[b]],
            idx[2][b, :v2[b]], idx[3][b, :v2[b]], transpose=True))
        np.testing.assert_allclose(got[b], want, **TOL)
    # the pallas kernel on the padded lists agrees too
    pallas = _jax_per_sample(assoc_matvec_pallas, X, Kp, Ke, idx,
                             transpose=True, block_e1=32, interpret=True)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_non_finite_feature_at_the_aliased_node(rng):
    """X[b, 0, 0] = inf is the one place where skipping padded slots and
    multiplying them by zero differ: without masks 0 * inf = nan reaches
    Y[b, 0, 0] (as in the plain ops); with masks it does not. Y[b, 0, 0]
    is not finite either way, and every other cell that does not gather
    X[b, 0, 0] through a real edge is the same."""
    v = [30, 30]
    X, Kp, Ke, idx, m1, m2 = _rand_case(rng, 2, 10, 10, 48, 48, 3, v, v)
    for a in idx:                      # no real edge touches node 0
        a[:, :30] = np.maximum(a[:, :30], 1)
    X[:, 0, 0] = np.inf
    args = (tt(X), tt(Kp), tt(Ke), *(tt(a) for a in idx))
    plain_ops = t_assoc.assoc_matvec(*args, transpose=True)
    unmasked = kb.assoc_matvec_bucket(*args, transpose=True)
    masked = kb.assoc_matvec_bucket(*args, transpose=True, e1_mask=tt(m1),
                                    e2_mask=tt(m2))
    assert torch.isnan(plain_ops[:, 0, 0]).all()
    assert torch.isnan(unmasked[:, 0, 0]).all()
    assert torch.isinf(masked[:, 0, 0]).all()
    for y in (unmasked, masked, plain_ops):
        y[:, 0, 0] = 0
        assert torch.isfinite(y).all()
    np.testing.assert_allclose(t2n(unmasked), t2n(plain_ops), **TOL)
    np.testing.assert_allclose(t2n(masked), t2n(plain_ops), **TOL)


def test_delaunay_batch_at_model_channels(rng):
    """What the model gives the kernels: ragged Delaunay pairs in a padded
    bucket, C = 1 and 17, K^T orientation, masks from the edge counts."""
    B, N, E = 3, 24, 140
    for c in (1, 17):
        X = np.zeros((B, N, N, c), np.float32)
        Kp = np.zeros((B, N, N), np.float32)
        Ke = np.zeros((B, E, E), np.float32)
        idx = np.zeros((4, B, E), np.int32)
        ne = np.zeros((B, 2), np.int64)
        for b, (n1, n2) in enumerate(((24, 20), (15, 24), (18, 18))):
            for g, n in enumerate((n1, n2)):
                pts = rng.uniform(size=(n, 2)).astype(np.float32) * [320, 240]
                _, s, d = build_edges(pts, stg="tri")
                idx[2 * g, b, :len(s)] = s
                idx[2 * g + 1, b, :len(d)] = d
                ne[b, g] = len(s)
            X[b, :n1, :n2] = rng.normal(size=(n1, n2, c))
            Kp[b, :n1, :n2] = rng.normal(size=(n1, n2))
            Ke[b, :ne[b, 0], :ne[b, 1]] = rng.normal(size=tuple(ne[b]))
        m1 = tt(np.arange(E)[None] < ne[:, :1])
        m2 = tt(np.arange(E)[None] < ne[:, 1:])
        args = (tt(X), tt(Kp), tt(Ke), *(tt(a) for a in idx))
        want = _jax_per_sample(j_assoc_matvec, X, Kp, Ke, idx, transpose=True)
        for fn in (kb.assoc_matvec_bucket, kb.assoc_matvec_large):
            got = t2n(fn(*args, transpose=True, e1_mask=m1, e2_mask=m2))
            np.testing.assert_allclose(got, want, **TOL)
        # the dispatcher on CPU tensors takes the plain ops
        auto = t2n(t_assoc.assoc_matvec_auto(*args, transpose=True,
                                             e1_mask=m1, e2_mask=m2))
        np.testing.assert_allclose(auto, want, **TOL)


@pytest.mark.parametrize("both", [False, True])
def test_zero_edge_sides(rng, both):
    B, n, c = 2, 9, 3
    e2 = 0 if both else 20
    X, Kp, Ke, idx, _, _ = _rand_case(rng, B, n, n, 0, e2, c)
    for fn in (kb.assoc_matvec_bucket, kb.assoc_matvec_large):
        got = t2n(fn(tt(X), tt(Kp), tt(Ke), *(tt(a) for a in idx)))
        np.testing.assert_allclose(got, Kp[..., None] * X, rtol=1e-6,
                                   atol=1e-6)


def test_bf16_features_f32_accumulation(rng):
    """bf16 X: each term rounds as the JAX op's bf16 multiply (`W *
    Ke.astype(W.dtype)`), bf16(bf16(Ke) X), and is summed in f32; the result
    is f32. Both kernels' plain versions equal the JAX op on bf16 features
    up to the order of the f32 sums (1e-5 of the range), while f32 products
    of the same bf16 X do not; all stay within bf16 rounding of the f32
    result."""
    X, Kp, Ke, idx, _, _ = _rand_case(rng, 2, 14, 14, 60, 60, 5)
    args = (tt(Kp), tt(Ke), *(tt(a) for a in idx))
    Xb = tt(X).bfloat16()
    want = _jax_per_sample(
        lambda x, *a, **k: j_assoc_matvec(x.astype(jnp.bfloat16), *a, **k),
        X, Kp, Ke, idx, transpose=True)
    tol = 1e-5 * np.abs(want).max()
    for fn in (kb.assoc_matvec_bucket, kb.assoc_matvec_large):
        got = fn(Xb, *args, transpose=True)
        assert got.dtype == torch.float32
        assert np.abs(t2n(got) - want).max() <= tol
        unrounded = t2n(fn(Xb.float(), *args, transpose=True))
        assert np.abs(unrounded - want).max() > tol
        full = fn(tt(X), *args, transpose=True)
        scale = float(full.abs().max())
        assert float((got - full).abs().max()) <= 2 ** -6 * scale


def test_plan_is_shared_between_calls_on_the_same_edge_lists(rng):
    """`plan_bucket` keeps the last plan: the three GNN layers of a forward
    pass the same index tensors (views of one batch) and share one grouping;
    other tensors, another orientation or an in-place write make a new one.
    """
    _, _, _, idx, m1, m2 = _rand_case(rng, 2, 10, 10, 30, 30, 1, [20, 30],
                                      [30, 11])
    both = torch.stack([tt(idx[0]), tt(idx[2])], dim=1)        # (B, 2, E)
    s1, s2 = both[:, 0], both[:, 1]
    d1, d2 = tt(idx[1]), tt(idx[3])
    p = kb.plan_bucket(s1, d1, s2, d2, 10, 10, True, tt(m1), tt(m2))
    assert p.offs1.dtype == torch.int32 and p.offs1.shape == (2, 11)
    # runs hold exactly the unmasked slots, stably sorted by out endpoint
    for b, v in enumerate((20, 30)):
        assert int(p.offs1[b, -1]) == v
        order = t2n(p.order1[b, :v])
        assert sorted(order) == list(range(v))
        keys = idx[1][b][order]                  # transpose: out1 = dst1
        assert (np.diff(keys) >= 0).all()
        for k in np.unique(keys):
            assert (np.diff(order[keys == k]) > 0).all()
        assert np.array_equal(t2n(p.ins1[b, :v]), idx[0][b][order])
    m1t, m2t = tt(m1), tt(m2)
    p1 = kb.plan_bucket(s1, d1, s2, d2, 10, 10, True, m1t, m2t)
    assert kb.plan_bucket(both[:, 0], d1, both[:, 1], d2, 10, 10, True, m1t,
                          m2t) is p1                    # fresh views
    assert kb.plan_bucket(s1, d1, s2, d2, 10, 10, False, m1t, m2t) is not p1
    p2 = kb.plan_bucket(s1, d1, s2, d2, 10, 10, True, m1t, m2t)
    d1[0, 0] = (d1[0, 0] + 1) % 10                      # in-place write
    p3 = kb.plan_bucket(s1, d1, s2, d2, 10, 10, True, m1t, m2t)
    assert p3 is not p2 and not torch.equal(p3.order1, p2.order1) \
        or not torch.equal(p3.offs1, p2.offs1)
    assert kb.plan_bucket(s1, d1.clone(), s2, d2, 10, 10, True, m1t,
                          m2t) is not p3


def test_wrapper_checks_and_cpu_route(rng, monkeypatch):
    """On CPU tensors the wrappers take the plain versions and launch
    nothing; wrong shapes and types raise; the channel split of the cell
    kernels: 16-byte vectors where C allows, scalar channels otherwise, any
    width of X."""
    X, Kp, Ke, idx, _, _ = _rand_case(rng, 2, 8, 8, 20, 20, 2)
    args = [tt(X), tt(Kp), tt(Ke), *(tt(a) for a in idx)]
    before = dict(kb.LAUNCHES)
    for name in ("_launch_bucket", "_launch_large"):
        monkeypatch.setattr(kb, name, lambda *a: pytest.fail(
            "a CUDA kernel must not be launched for CPU tensors"))
    kb.assoc_matvec_bucket(*args)
    kb.assoc_matvec_large(*args)
    assert kb.LAUNCHES == before == {"assoc_bucket": 0, "assoc_large": 0}
    with pytest.raises(TypeError):
        kb.assoc_matvec_bucket(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        kb.assoc_matvec_bucket(*args[:3], args[3].float(), *args[4:])
    with pytest.raises(ValueError):
        kb.assoc_matvec_bucket(args[0][0], *args[1:])           # no batch
    with pytest.raises(ValueError):
        kb.assoc_matvec_large(*args[:3], args[3][:, :5], *args[4:])
    with pytest.raises(ValueError):
        kb.assoc_matvec_large(*args, block_c=0)
    z = lambda c, dt=torch.float32: torch.zeros(1, 2, 3, c, dtype=dt)
    assert channel_tiling(z(16)) == (4, True)
    assert channel_tiling(z(16, torch.bfloat16)) == (8, True)
    assert channel_tiling(z(64)) == (4, True)
    for dt in (torch.float32, torch.bfloat16):
        assert channel_tiling(z(1, dt)) == (1, False)
        for c in (3, 17):
            assert channel_tiling(z(c, dt)) == (32, False)
    assert channel_tiling(z(12, torch.bfloat16)) == (32, False)
    assert channel_tiling(z(17)[..., 1:]) == (32, False)     # unaligned
    wide = [torch.zeros(1, 4, 4096, 17), torch.zeros(1, 4, 4096),
            torch.zeros(1, 0, 0)] + [torch.zeros(1, 0, dtype=torch.int32)] * 4
    assert torch.equal(kb.assoc_matvec_bucket(*wide), wide[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,want", [(1, (1, False)), (2, (2, False)),
                                    (3, (2, False)), (5, (4, False)),
                                    (17, (10, False)), (31, (16, False)),
                                    (33, (16, False)), (64, (16, False))])
def test_bucket_tiling_splits_a_cell_over_two_lanes(dtype, C, want):
    """K2's channel split (`bucket_tiling`): 16-byte vectors where C and the
    alignment allow (K4's `channel_tiling` rule); otherwise two lanes share
    a cell's min(C, 32) channels, each an even count (bf16 X is read and
    multiplied in pairs): 10 at the model's C = 17, 1 at C = 1. The
    launcher takes every even count up to 32."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    X = torch.zeros(1, 2, 3, C, dtype=dtype)
    if C % vec == 0:
        assert bucket_tiling(X) == (vec, True) == channel_tiling(X)
    else:
        nc, v = bucket_tiling(X)
        assert (nc, v) == want
        assert nc == 1 or (nc % 2 == 0 and 2 <= nc <= 32)
        lanes = -(-min(C, 32) // nc)
        assert lanes <= 2 and nc * lanes >= min(C, 32)
    # unaligned X (a view one channel in): scalar channels, still two lanes
    off = torch.zeros(1, 2, 3, C + 1, dtype=dtype)[..., 1:]
    if C > 1 and C % vec == 0:
        assert bucket_tiling(off)[1] is False


def test_one_step_builds_each_orientation_plan_once(rng, monkeypatch):
    """A train step's association products on one set of edge lists: three
    GNN layers forward (K^T), then per layer backward the dX launch (K,
    the other orientation) and K6 (the forward's plan). `plan_bucket` keeps
    both orientations, so the grouping runs once for each: K6 adds no
    prologue of its own. Counted through the plain versions, which group
    as the kernels do."""
    from fpmatch_tpu_torch.kernels import assoc_grad as k6
    X, Kp, Ke, idx, m1, m2 = _rand_case(rng, 2, 10, 10, 30, 30, 3, [20, 30],
                                        [30, 11])
    args = [tt(X), tt(Kp), tt(Ke), *(tt(a) for a in idx)]
    masks = dict(e1_mask=tt(m1), e2_mask=tt(m2))
    made = []
    real = kb._csr
    monkeypatch.setattr(kb, "_csr", lambda *a: made.append(1) or real(*a))
    kb._memo.clear()
    for _ in range(3):                                   # forward, K^T
        kb.assoc_matvec_bucket_plain(*args, transpose=True, **masks)
    assert len(made) == 2                                # one plan, 2 graphs
    dY = tt(rng.normal(size=X.shape).astype(np.float32))
    for _ in range(3):                                   # backward
        kb.assoc_matvec_bucket_plain(dY, *args[1:], transpose=False,
                                     **masks)
        k6.assoc_edge_grad(dY, args[0], *args[3:], transpose=True, **masks)
    assert len(made) == 4                                # + the K plan only


def test_auto_dispatch_on_a_cuda_tensor(monkeypatch):
    """`ops.assoc.assoc_matvec_auto` on a CUDA tensor: the bucket kernel
    below CHUNKED_NNZ_THRESHOLD association edge slots per sample, the
    any-size kernel from there up, and never the plain ops."""
    calls = []
    monkeypatch.setattr(t_assoc, "assoc_matvec_bucket",
                        lambda *a, **k: calls.append(("bucket", k)))
    monkeypatch.setattr(t_assoc, "assoc_matvec_large",
                        lambda *a, **k: calls.append(("large", k)))
    for name in ("assoc_matvec", "assoc_matvec_chunked"):
        monkeypatch.setattr(t_assoc, name, lambda *a, **k: pytest.fail(
            "a CUDA tensor must not fall back to the plain ops"))
    X = types.SimpleNamespace(device=torch.device("cuda", 0))
    ke = lambda e1, e2: types.SimpleNamespace(shape=(8, e1, e2))
    t_assoc.assoc_matvec_auto(X, None, ke(384, 384), 1, 2, 3, 4,
                              transpose=True, e1_mask=5, e2_mask=6)
    t_assoc.assoc_matvec_auto(X, None, ke(1536, 1536), 1, 2, 3, 4)
    t_assoc.assoc_matvec_auto(X, None, ke(1000, 1000), 1, 2, 3, 4)
    t_assoc.assoc_matvec_auto(X, None, ke(999, 1000), 1, 2, 3, 4)
    assert [c[0] for c in calls] == ["bucket", "large", "large", "bucket"]
    assert calls[0][1] == dict(transpose=True, e1_mask=5, e2_mask=6)
    assert t_assoc.CHUNKED_NNZ_THRESHOLD == 1_000_000


def _card_case(rng, kernel, n1=64, n2=64, c=17, block_c=None):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no interpret mode")
    X, Kp, Ke, idx, m1, m2 = _rand_case(rng, 3, n1, n2, 384, 384, c,
                                        [300, 384, 0], [384, 200, 50])
    args = [tt(a).cuda() for a in (X, Kp, Ke, *idx)]
    kw = dict(transpose=True, e1_mask=tt(m1).cuda(), e2_mask=tt(m2).cuda())
    fn, plain = {
        "assoc_bucket": (kb.assoc_matvec_bucket,
                         kb.assoc_matvec_bucket_plain),
        "assoc_large": (kb.assoc_matvec_large, kb.assoc_matvec_large_plain),
    }[kernel]
    if block_c is not None:
        kw["block_c"] = block_c
    before = kb.LAUNCHES[kernel]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert kb.LAUNCHES[kernel] == before + 1
    want = plain(*args, **kw)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, fn(*args, **kw))            # no atomics


@pytest.mark.gpu
def test_bucket_cuda_kernel_matches_plain_on_the_card(rng):
    """Needs a GPU and nvcc (run there with `pytest -m gpu`); chip_smoke.py
    makes the same comparison at the evaluation shapes."""
    _card_case(rng, "assoc_bucket")


@pytest.mark.gpu
def test_large_cuda_kernel_matches_plain_on_the_card(rng):
    _card_case(rng, "assoc_large")


@pytest.mark.gpu
def test_large_cuda_kernel_channel_slices_on_the_card(rng):
    """C = 33: slices of 32 and 1 channels, and of 8 (five slices)."""
    for block_c in (32, 8):
        _card_case(rng, "assoc_large", c=33, block_c=block_c)


@pytest.mark.gpu
def test_large_cuda_kernel_wide_row_on_the_card(rng):
    """A row of 4096 columns: global memory over column tiles."""
    _card_case(rng, "assoc_large", n1=4, n2=4096, c=17)
