"""The port's blocked UNIV association matvec (kernels/assoc_univ, K4), its
first-launch warm-up (kernels/inoculate, K5) and the block-size sweep
(scripts/tune_univ) on the CPU, against the JAX package.

The plan must equal the JAX plan field for field (it fixes which edges
spill, and the sweep reports b1 / b2 / spill). The plain PyTorch version —
what the CUDA kernel is held against on the card — must agree with the
JAX Pallas kernel in interpret mode at the JAX test's own 1e-4
(tests/test_univ_kernel.py), for both values of the JAX-only `fused_ta`,
and with the gather / segment-sum op. Interpreted cases are kept to six."""
import json
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.kernels import assoc_univ as j_univ
from fpmatch_tpu.ops.assoc import assoc_matvec as j_assoc_matvec
from fpmatch_tpu_torch.kernels import _build
from fpmatch_tpu_torch.kernels import assoc_univ as t_univ
from fpmatch_tpu_torch.kernels import inoculate as t_inoc
from fpmatch_tpu_torch.scripts import tune_univ


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(rng, n1, n2, scale=(4.0, 1.0)):
    """tests/test_univ_kernel.py's pair: uniform points in a 4 x 1 box (or
    `scale`), Delaunay edges."""
    p1 = rng.uniform(size=(n1, 2)).astype(np.float32) * list(scale)
    p2 = rng.uniform(size=(n2, 2)).astype(np.float32) * list(scale)
    _, s1, d1 = build_edges(p1, stg="tri")
    _, s2, d2 = build_edges(p2, stg="tri")
    return p1, p2, s1, d1, s2, d2


def _random_graph(rng, n1, n2, m1, m2):
    """tests/test_univ_kernel.py's spill-only graph: random (non-local)
    edges with repeats and self-loops."""
    s1 = rng.integers(0, n1, m1).astype(np.int32)
    d1 = rng.integers(0, n1, m1).astype(np.int32)
    s2 = rng.integers(0, n2, m2).astype(np.int32)
    d2 = rng.integers(0, n2, m2).astype(np.int32)
    p1 = rng.uniform(size=(n1, 2)).astype(np.float32)
    p2 = rng.uniform(size=(n2, 2)).astype(np.float32)
    return p1, p2, s1, d1, s2, d2


def _data(rng, n1, n2, c, e1, e2):
    X = rng.normal(size=(n1, n2, c)).astype(np.float32)
    Kp = rng.normal(size=(n1, n2)).astype(np.float32)
    Ke = rng.normal(size=(e1, e2)).astype(np.float32)
    return X, Kp, Ke


def _assert_plans_equal(jp, tp):
    assert tp._fields == jp._fields
    for name in jp._fields:
        a, b = getattr(jp, name), getattr(tp, name)
        assert type(a) is type(b), name
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name


def _check_device_plan(tp, dp):
    """The kernel's per-block tables cover every kept slot exactly once, in
    non-decreasing local scatter order, each with its original gather
    node."""
    for e_idx, s_loc, gath, r, blk, offs in (
            (tp.e1_idx, tp.s1_loc, tp.dst1, tp.r1, dp.blk1, dp.offs1),
            (tp.e2_idx, tp.s2_loc, tp.dst2, tp.r2, dp.blk2, dp.offs2)):
        assert blk.dtype == offs.dtype == torch.int32
        blk, offs = blk.numpy(), offs.numpy()
        for b in range(e_idx.shape[0]):
            kept = np.nonzero(e_idx[b] < len(gath))[0]
            run = blk[b, :offs[b, r], 0]
            assert sorted(run) == list(kept)
            for a in range(r):
                slots = blk[b, offs[b, a]:offs[b, a + 1], 0]
                assert (s_loc[b, slots, 0] == a).all()
                assert (np.diff(slots) > 0).all()        # stable
            assert np.array_equal(blk[b, :offs[b, r], 1],
                                  gath[e_idx[b, run]])


def _inv(perm):
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def _cells(dp):
    """Every cell the kernel writes: (sorted row, sorted column, its kept
    runs (slots, gather nodes) of both sides, its spill runs: spilled e1 x
    all e2, kept e1 x spilled e2 as (edge ids, gather nodes))."""
    blk1, offs1, blk2, offs2 = (t.numpy() for t in (dp.blk1, dp.offs1,
                                                     dp.blk2, dp.offs2))
    lists = [(o.numpy(), e.numpy()) for o, e in (
        (dp.spill1_offs, dp.spill1), (dp.keep1_offs, dp.keep1),
        (dp.all2_offs, dp.all2), (dp.spill2_offs, dp.spill2))]
    run = lambda lst, n: lst[1][lst[0][n]:lst[0][n + 1]]
    for as_ in range(dp.n1):
        i, a = divmod(as_, dp.r1)
        k1 = blk1[i, offs1[i, a]:offs1[i, a + 1]]
        for bs in range(dp.n2):
            j, b = divmod(bs, dp.r2)
            k2 = blk2[j, offs2[j, b]:offs2[j, b + 1]]
            yield (as_, bs, i, j, k1, k2,
                   ((run(lists[0], as_), run(lists[2], bs)),
                    (run(lists[1], as_), run(lists[3], bs))))


def _coverage(tp, dp):
    """How often the kernel's walk meets each association edge (e1, e2),
    checking on the way that each term sits at the cell of its edges'
    scatter endpoints and gathers their gather endpoints."""
    row1, col2 = _inv(tp.perm1)[tp.src1], _inv(tp.perm2)[tp.src2]
    count = np.zeros((len(tp.src1), len(tp.src2)), np.int64)
    for as_, bs, i, j, k1, k2, spills in _cells(dp):
        e1 = tp.e1_idx[i, k1[:, 0]]
        e2 = tp.e2_idx[j, k2[:, 0]]
        terms = [(e1, k1[:, 1], e2, k2[:, 1])]
        terms += [(t1[:, 0], t1[:, 1], t2[:, 0], t2[:, 1])
                  for t1, t2 in spills]
        for e1, g1, e2, g2 in terms:
            assert (row1[e1] == as_).all() and (col2[e2] == bs).all()
            assert (tp.dst1[e1] == g1).all() and (tp.dst2[e2] == g2).all()
            count[np.ix_(e1, e2)] += 1
    return count


def _kernel_walk(X, Kp, Ke, KeR, dp, precision):
    """The CUDA kernel's own walk, cell by cell, in numpy: its tables, its
    order of terms (kept runs, spilled e1 x all e2, kept e1 x spilled e2,
    Kp X) and its rounding, f32 sums (not fused multiply-adds)."""
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)
                                    ).bfloat16().float().numpy()
    xb = X.dtype == torch.bfloat16
    Xf, Kef, KeRf, Kpf = (t.float().numpy() for t in (X, Ke, KeR, Kp))
    Xk = bf(Xf) if precision == "default" and not xb else Xf
    p1, p2 = dp.perm1.numpy(), dp.perm2.numpy()
    Y = np.full(Xf.shape, np.nan, np.float32)
    for as_, bs, i, j, k1, k2, spills in _cells(dp):
        acc = np.zeros(Xf.shape[2], np.float32)
        for p, g1 in k1:
            for q, g2 in k2:
                acc += KeRf[i * dp.b1 + p, j * dp.b2 + q] * Xk[g1, g2]
        if xb:
            acc = bf(acc)
        for t1, t2 in spills:
            for e1, g1 in t1:
                for e2, g2 in t2:
                    acc += (bf(Xf[g1, g2] * bf(Kef[e1, e2])) if xb
                            else Kef[e1, e2] * Xf[g1, g2])
        a, b = p1[as_], p2[bs]
        Y[a, b] = acc + Kpf[a, b] * Xf[a, b]
    return Y


# ----------------------------------------------------------------- the plan
@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("r1,r2", [(8, 128), (16, 128), (32, 256)])
def test_plan_equals_the_jax_plan_delaunay(rng, r1, r2, transpose):
    """tune_univ's geometry at a smaller n: every field equal, KeR equal."""
    n = 260
    p1, p2, s1, d1, s2, d2 = _pair(rng, n, n - 20, scale=(400, 300))
    jp = j_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=r1, r2=r2,
                          transpose=transpose)
    tp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=r1, r2=r2,
                          transpose=transpose)
    _assert_plans_equal(jp, tp)
    assert tp.b1 % 8 == 0 and tp.b2 % 128 == 0
    dp = tp.to("cpu")
    _check_device_plan(tp, dp)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)
    want = np.asarray(j_univ.gather_ke_blocks(jnp.asarray(Ke), jp))
    for plan in (tp, dp):                       # host or device plan
        np.testing.assert_array_equal(
            t_univ.gather_ke_blocks(tt(Ke), plan).numpy(), want)
    got_bf = t_univ.gather_ke_blocks(tt(Ke), dp, dtype=torch.bfloat16)
    assert got_bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got_bf.float().numpy(),
        np.asarray(j_univ.gather_ke_blocks(jnp.asarray(Ke), jp,
                                           dtype=jnp.bfloat16)
                   ).astype(np.float32))


def test_plan_equals_the_jax_plan_spill_heavy_and_zero_edge(rng):
    """A random graph (most edges spill, repeated edges, self-loops), then
    zero-edge sides (every slot a pad, b1 = 8)."""
    p1, p2, s1, d1, s2, d2 = _random_graph(rng, 40, 40, 120, 110)
    for transpose in (True, False):
        kw = dict(r1=8, r2=128, transpose=transpose)
        jp = j_univ.plan_univ(p1, p2, s1, d1, s2, d2, **kw)
        tp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, **kw)
        _assert_plans_equal(jp, tp)
        assert len(tp.spill1) > 60
        _check_device_plan(tp, tp.to("cpu"))
    empty = np.zeros(0, np.int32)
    _, p2, _, _, s2, d2 = _pair(rng, 30, 30)
    for edges in ((empty, empty, s2, d2), (empty, empty, empty, empty)):
        jp = j_univ.plan_univ(p2, p2, *edges, r1=8, r2=128, transpose=True)
        tp = t_univ.plan_univ(p2, p2, *edges, r1=8, r2=128, transpose=True)
        _assert_plans_equal(jp, tp)
        assert tp.b1 == 8 and (tp.e1_idx == 0).all()     # all pad (E1 = 0)
        dp = tp.to("cpu")
        assert int(dp.offs1[:, -1].sum()) == 0
        assert len(dp.spill1) == len(dp.keep1) == len(dp.spill2) == 0
        assert len(dp.all2) == len(edges[2])


def _table_cases(rng):
    """(name, plan args, X-side sizes): a Delaunay pair at r1 = 8 (spills in
    graph 1) in both orientations, the spill-heavy random graph, and a
    zero-edge side."""
    empty = np.zeros(0, np.int32)
    p1, p2, s1, d1, s2, d2 = _pair(rng, 40, 36)
    r1, r2, rs1, rd1, rs2, rd2 = _random_graph(rng, 30, 28, 70, 60)
    z1, z2, _, _, zs2, zd2 = _pair(rng, 20, 20)
    return {"delaunay-T": ((p1, p2, s1, d1, s2, d2), True),
            "delaunay": ((p1, p2, s1, d1, s2, d2), False),
            "spill-heavy": ((r1, r2, rs1, rd1, rs2, rd2), True),
            "zero-edge": ((z1, z2, empty, empty, zs2, zd2), True)}


@pytest.mark.parametrize("case", ["delaunay-T", "delaunay", "spill-heavy",
                                  "zero-edge"])
def test_device_tables_count_every_association_edge_once(rng, case):
    """The kernel's kept runs (per tile) and its two spill runs (spilled e1
    x all e2, kept e1 x spilled e2, by sorted scatter node) meet every
    association edge (e1, e2) exactly once, at the cell of its scatter
    endpoints, gathering at its gather endpoints — whichever table holds
    it."""
    args, transpose = _table_cases(rng)[case]
    tp = t_univ.plan_univ(*args, r1=8, r2=128, transpose=transpose)
    dp = tp.to("cpu")
    if case != "zero-edge":
        assert len(tp.spill1) > 0
    assert len(dp.spill1) == len(tp.spill1)
    assert len(dp.keep1) + len(dp.spill1) == len(tp.src1)
    assert len(dp.all2) == len(tp.src2) and len(dp.spill2) == len(tp.spill2)
    count = _coverage(tp, dp)
    assert count.shape == (len(tp.src1), len(tp.src2))
    assert (count == 1).all()


@pytest.mark.parametrize("case", ["delaunay-T", "delaunay", "spill-heavy",
                                  "zero-edge"])
def test_kernel_walk_matches_pallas_interpret(rng, case):
    """The CUDA kernel's walk of its tables (`_kernel_walk`, the order and
    rounding of the kernel, cell by cell in numpy) against the JAX wrapper
    with the Pallas kernel in interpret mode, at the JAX test's 1e-4, and
    against the port's plain version (another order of f32 sums: 1e-5 of
    the range), f32 X; every cell written."""
    args, transpose = _table_cases(rng)[case]
    n1, n2 = len(args[0]), len(args[1])
    X, Kp, Ke = _data(rng, n1, n2, 3, len(args[2]), len(args[4]))
    jp = j_univ.plan_univ(*args, r1=8, r2=128, transpose=transpose)
    dp = t_univ.plan_univ(*args, r1=8, r2=128, transpose=transpose).to("cpu")
    KeR = t_univ.gather_ke_blocks(tt(Ke), dp)
    got = _kernel_walk(tt(X), tt(Kp), tt(Ke), KeR, dp, "highest")
    assert np.isfinite(got).all()
    pallas = np.asarray(j_univ.assoc_matvec_univ(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jp,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    plain = t_univ.assoc_matvec_univ_plain(tt(X), tt(Kp), tt(Ke), dp).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5,
                               atol=1e-5 * np.abs(plain).max())


def test_plain_version_reads_none_of_the_kernel_tables(rng):
    """The plain version, the yardstick the kernel is held against on the
    card, takes its spill terms from the plan's own lists: with the kernel's
    spilled-e1 runs emptied it gives the same bits, while the kernel's walk
    of those tables misses the spilled terms."""
    args, transpose = _table_cases(rng)["delaunay-T"]
    dp = t_univ.plan_univ(*args, r1=8, r2=128, transpose=transpose).to("cpu")
    X, Kp, Ke = (tt(a) for a in _data(rng, len(args[0]), len(args[1]), 3,
                                      len(args[2]), len(args[4])))
    KeR = t_univ.gather_ke_blocks(Ke, dp)
    bad = dp._replace(spill1_offs=torch.zeros_like(dp.spill1_offs))
    want = t_univ.assoc_matvec_univ_plain(X, Kp, Ke, dp, KeR)
    assert torch.equal(t_univ.assoc_matvec_univ_plain(X, Kp, Ke, bad, KeR),
                       want)
    walk = _kernel_walk(X, Kp, Ke, KeR, bad, "highest")
    assert np.abs(walk - want.numpy()).max() > 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("transpose", [True, False])
def test_bf16_features_match_the_jax_wrapper(rng, transpose):
    """bf16 X, as the JAX wrapper computes it: the kept part rounded to bf16
    (JAX scatters it into `zeros_like(X)`), each spilled product bf16(X)
    bf16(Ke) rounded to bf16, sums f32. The port's plain version and the
    kernel's walk against the JAX wrapper (Pallas in interpret mode): the
    kept part is an f32 sum taken in another order before both round it, so
    a cell may differ by one bf16 ulp of its kept part (at most 2**-7 of
    it), plus 1e-5 of the range for the f32 sums after the rounding."""
    n1, n2, c = 44, 40, 3
    p1, p2, s1, d1, s2, d2 = _pair(rng, n1, n2)
    X, Kp, Ke = _data(rng, n1, n2, c, len(s1), len(s2))
    Xb = tt(X).bfloat16()
    kw = dict(r1=8, r2=128, transpose=transpose)
    jp = j_univ.plan_univ(p1, p2, s1, d1, s2, d2, **kw)
    dp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, **kw).to("cpu")
    assert len(jp.spill1) > 0
    want = np.asarray(j_univ.assoc_matvec_univ(
        jnp.asarray(Xb.float().numpy(), dtype=jnp.bfloat16),
        jnp.asarray(Kp), jnp.asarray(Ke), jp, interpret=True))
    assert want.dtype == np.float32
    KeR = t_univ.gather_ke_blocks(tt(Ke), dp, dtype=torch.bfloat16)
    kept = t_univ._unsort(t_univ.kept_terms_plain(
        t_univ.halo(Xb, dp, torch.bfloat16), KeR, dp), dp).numpy()
    scale = 1e-5 * np.abs(want).max()
    tol = 2 ** -7 * np.abs(kept) + scale
    got = t_univ.assoc_matvec_univ(Xb, tt(Kp), tt(Ke), dp).numpy()
    walk = _kernel_walk(Xb, tt(Kp), tt(Ke), KeR, dp, "highest")
    for y in (got, walk):
        err = np.abs(y - want)
        assert (err <= tol).all()
        assert (err > scale).mean() <= 0.01          # a flipped rounding
    # the port before this repair (kept part and spilled products in f32)
    # misses most cells by more than the f32 limit
    old = t_univ.assoc_matvec_univ(Xb.float(), tt(Kp), tt(Ke), dp,
                                   precision="default").numpy()
    assert (np.abs(old - want) > scale).mean() > 0.5


# ------------------------------------------------- the function vs the JAX one
@pytest.mark.parametrize("transpose", [False, True])
def test_plain_matches_pallas_interpret_both_fused_ta(rng, transpose):
    """tests/test_univ_kernel.py's case (n1=150, n2=140, C=3, r1=16,
    r2=128): one port result against the Pallas kernel in interpret mode
    with `fused_ta` False and True, at the JAX test's rtol / atol 1e-4, and
    against the gather / segment-sum op."""
    n1, n2, c = 150, 140, 3
    p1, p2, s1, d1, s2, d2 = _pair(rng, n1, n2)
    X, Kp, Ke = _data(rng, n1, n2, c, len(s1), len(s2))
    kw = dict(r1=16, r2=128, transpose=transpose)
    jp = j_univ.plan_univ(p1, p2, s1, d1, s2, d2, **kw)
    dp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, **kw).to("cpu")
    got = t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke), dp).numpy()
    assert got.dtype == np.float32 and got.shape == (n1, n2, c)
    for fused_ta in (False, True):
        pallas = np.asarray(j_univ.assoc_matvec_univ(
            jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jp,
            interpret=True, fused_ta=fused_ta))
        np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    want = np.asarray(j_assoc_matvec(jnp.asarray(X), jnp.asarray(Kp),
                                     jnp.asarray(Ke), s1, d1, s2, d2,
                                     transpose=transpose))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_precision_default_matches_pallas_interpret(rng):
    """precision "default": X and KeR rounded to bf16 in the kept-edge part,
    products and sums f32, the spilled part in f32 — so against the Pallas
    kernel (interpret mode, the same rounding) only the order of f32 sums
    differs: 1e-5 of the value range. Against the unrounded f32 result each
    term carries up to two bf16 roundings (2 * 2**-8 relative), and the sum
    of ~36 terms of either sign stays well inside 2**-5 of the range."""
    n1, n2, c = 150, 140, 3
    p1, p2, s1, d1, s2, d2 = _pair(rng, n1, n2)
    X, Kp, Ke = _data(rng, n1, n2, c, len(s1), len(s2))
    jp = j_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=16, r2=128,
                          transpose=True)
    dp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=16, r2=128,
                          transpose=True).to("cpu")
    got = t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke), dp,
                                   precision="default").numpy()
    pallas = np.asarray(j_univ.assoc_matvec_univ(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jp,
        interpret=True, precision="default"))
    scale = np.abs(pallas).max()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5 * scale)
    full = t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke), dp).numpy()
    assert 0 < np.abs(got - full).max() <= 2 ** -5 * scale
    # a KeR given in f32 is rounded the same way
    KeR = t_univ.gather_ke_blocks(tt(Ke), dp)
    again = t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke), dp, KeR,
                                     precision="default").numpy()
    np.testing.assert_array_equal(again, got)


def test_spill_only_graph_matches_pallas_interpret_and_ops(rng):
    """tests/test_univ_kernel.py's spill-only graph (n=40, r1=8, random
    edges): the spilled part carries most of the result."""
    p1, p2, s1, d1, s2, d2 = _random_graph(rng, 40, 40, 120, 110)
    X, Kp, Ke = _data(rng, 40, 40, 2, 120, 110)
    jp = j_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=8, r2=128,
                          transpose=True)
    dp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=8, r2=128,
                          transpose=True).to("cpu")
    assert len(jp.spill1) > 60 and len(dp.spill2) == 0   # graph 2: 1 block
    got = t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke), dp).numpy()
    pallas = np.asarray(j_univ.assoc_matvec_univ(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jp,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    want = np.asarray(j_assoc_matvec(jnp.asarray(X), jnp.asarray(Kp),
                                     jnp.asarray(Ke), s1, d1, s2, d2,
                                     transpose=True))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("transpose", [True, False])
def test_spill_terms_and_kept_part_against_ops(rng, transpose):
    """The two pieces of the plain version apart, on a Delaunay pair with a
    small r1 (many spills): the kept-edge part alone equals the op over the
    kept edges, and the spill terms (from the plan's own spill lists) equal
    the op over the other association edges."""
    n1, n2, c = 70, 64, 4
    p1, p2, s1, d1, s2, d2 = _pair(rng, n1, n2)
    X, Kp, Ke = _data(rng, n1, n2, c, len(s1), len(s2))
    hp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=8, r2=128,
                          transpose=transpose)
    dp = hp.to("cpu")
    assert len(hp.spill1) > 0
    Xt = tt(X)
    kept = t_univ._unsort(
        t_univ.kept_terms_plain(t_univ.halo(Xt, dp, torch.float32),
                                t_univ.gather_ke_blocks(tt(Ke), dp), dp),
        dp).numpy()
    # the op over kept e1 x kept e2 only: zero the spilled rows / columns
    Kk = Ke.copy()
    Kk[hp.spill1] = 0
    Kk[:, hp.spill2] = 0
    zero = np.zeros_like(Kp)
    want_kept = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(zero), jnp.asarray(Kk), s1, d1, s2, d2,
        transpose=transpose))
    tol = 1e-5 * np.abs(want_kept).max()
    np.testing.assert_allclose(kept, want_kept, rtol=1e-5, atol=tol)
    spill = sum(t.numpy() for t in t_univ.spill_terms_plain(Xt, tt(Ke),
                                                           dp))
    want_spill = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(zero), jnp.asarray(Ke - Kk), s1, d1, s2,
        d2, transpose=transpose))
    np.testing.assert_allclose(spill, want_spill, rtol=1e-5,
                               atol=1e-5 * np.abs(want_spill).max())


@pytest.mark.parametrize("both", [False, True])
def test_zero_edge_sides(rng, both):
    """A 1-2 keypoint image has no Delaunay edges: `Ke[:0]` is accepted, the
    kernel part is empty, and with no edges at all the result is Kp X."""
    n, c = 30, 3
    empty = np.zeros(0, np.int32)
    p1, p2, _, _, s2, d2 = _pair(rng, n, n)
    if both:
        s2, d2 = empty, empty
    X, Kp, Ke = _data(rng, n, n, c, 0, len(s2))
    dp = t_univ.plan_univ(p1, p2, empty, empty, s2, d2, r1=8, r2=128,
                          transpose=True).to("cpu")
    got = t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke), dp).numpy()
    want = np.asarray(j_assoc_matvec(jnp.asarray(X), jnp.asarray(Kp),
                                     jnp.asarray(Ke), empty, empty,
                                     jnp.asarray(s2), jnp.asarray(d2),
                                     transpose=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, Kp[..., None] * X, rtol=1e-6, atol=1e-6)


def test_bf16_features_and_wrapper_checks(rng, monkeypatch):
    """bf16 X: the kept part reads the bf16 values (KeR cast to bf16 too)
    and is rounded to bf16, the spilled products are rounded to bf16; the
    result is f32 and lies within that rounding of the f32 function of the
    rounded X (2**-6 of the range). CPU tensors launch nothing; wrong inputs
    raise."""
    n1, n2, c = 60, 50, 3
    p1, p2, s1, d1, s2, d2 = _pair(rng, n1, n2)
    X, Kp, Ke = _data(rng, n1, n2, c, len(s1), len(s2))
    dp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=8, r2=128,
                          transpose=True).to("cpu")
    before = dict(t_univ.LAUNCHES)
    launch = t_univ.launch_kernel
    monkeypatch.setattr(t_univ, "launch_kernel", lambda *a: pytest.fail(
        "the CUDA kernel must not be launched for CPU tensors"))
    Xb = tt(X).bfloat16()
    got = t_univ.assoc_matvec_univ(Xb, tt(Kp), tt(Ke), dp)
    assert got.dtype == torch.float32
    same = t_univ.assoc_matvec_univ(Xb.float(), tt(Kp), tt(Ke), dp,
                                    precision="default")
    scale = float(same.abs().max())
    assert 0 < float((got - same).abs().max()) <= 2 ** -6 * scale
    assert torch.equal(got, t_univ.assoc_matvec_univ(
        Xb, tt(Kp), tt(Ke), dp, precision="default"))
    assert t_univ.LAUNCHES == before
    with pytest.raises(TypeError):
        t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke),
                                 t_univ.plan_univ(p1, p2, s1, d1, s2, d2))
    with pytest.raises(TypeError):
        t_univ.assoc_matvec_univ(tt(X).double(), tt(Kp), tt(Ke), dp)
    with pytest.raises(ValueError):
        t_univ.assoc_matvec_univ(tt(X)[:5], tt(Kp), tt(Ke), dp)
    with pytest.raises(ValueError):
        t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke)[:-1], dp)
    with pytest.raises(ValueError):
        t_univ.assoc_matvec_univ(tt(X), tt(Kp), tt(Ke), dp,
                                 precision="fast")
    KeR = t_univ.gather_ke_blocks(tt(Ke), dp)
    with pytest.raises(RuntimeError):                  # no CPU kernel
        launch(tt(X), tt(Kp), tt(Ke), KeR, dp)
    # the launch checks its inputs as the wrapper does (the kernel would
    # read Ke with the plan's stride)
    for args in ((tt(X)[:5], tt(Kp), tt(Ke)), (tt(X), tt(Kp)[:, :5], tt(Ke)),
                 (tt(X), tt(Kp), tt(Ke)[:, :-1])):
        with pytest.raises(ValueError):
            launch(*args, KeR, dp)


def test_wrapper_refuses_kernel_inputs_on_another_device(rng):
    """A KeR that lies on another device than X is refused before anything
    reads it, by the wrapper and by the plain version (the kernel would take
    its address as it is)."""
    n1, n2, c = 40, 30, 2
    p1, p2, s1, d1, s2, d2 = _pair(rng, n1, n2)
    X, Kp, Ke = (tt(a) for a in _data(rng, n1, n2, c, len(s1), len(s2)))
    dp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=8, r2=128,
                          transpose=True).to("cpu")
    KeR = t_univ.gather_ke_blocks(Ke, dp)
    elsewhere = torch.empty(KeR.shape, device="meta")
    for fn in (t_univ.assoc_matvec_univ, t_univ.assoc_matvec_univ_plain):
        with pytest.raises(ValueError, match="one device"):
            fn(X, Kp, Ke, dp, elsewhere)
        got = fn(X, Kp, Ke, dp, KeR)             # the same KeR on X's device
        assert torch.equal(got, fn(X, Kp, Ke, dp))


# -------------------------------------------------------------- K5, sweep
def test_inoculate_on_the_cpu(monkeypatch):
    """On a CPU device the warm-up runs the plain version, checks x + 1
    exactly and launches nothing; a wrong plain result raises."""
    x = torch.arange(1024, dtype=torch.float32).reshape(8, 128) / 7
    assert torch.equal(t_inoc.inoculate_plain(x), x + 1)
    before = dict(t_inoc.LAUNCHES)
    secs = t_inoc.inoculate("cpu")
    assert list(secs) == ["plain"] and secs["plain"] >= 0
    assert t_inoc.LAUNCHES == before
    monkeypatch.setattr(t_inoc, "inoculate_plain", lambda x: x + 2)
    with pytest.raises(RuntimeError):
        t_inoc.inoculate("cpu")
    with pytest.raises(TypeError):
        t_inoc.launch(None, x)                    # CPU tensor: no launch


def test_tune_univ_rows_on_the_cpu():
    """A small sweep on the CPU: the JAX script's row keys (less
    `fused_ta`) plus the port's, the plan's b1 / b2 / spill, and the
    documented flags."""
    inp = tune_univ.make_inputs("cpu", n=90, c=2)
    lines = []
    rows = tune_univ.sweep("cpu", inp, configs=[(8, 128)], reps=1,
                           emit=lines.append)
    assert lines[0].startswith("# first launch") and len(lines) == 3
    assert [json.loads(s) for s in lines[1:]] == rows
    keys = {"r1", "r2", "prec", "b1", "b2", "spill", "ker_mb", "ms",
            "edges_per_s", "kernel_ms", "err_vs_plain",
            "bit_identical", "device"}
    hp = t_univ.plan_univ(inp.pts1, inp.pts2, *inp.edges, r1=8, r2=128,
                          transpose=True)
    for row, prec in zip(rows, tune_univ.PRECS):
        assert set(row) == keys and row["prec"] == prec
        assert (row["b1"], row["b2"]) == (hp.b1, hp.b2)
        assert row["spill"] == len(hp.spill1) + len(hp.spill2)
        assert row["err_vs_plain"] == 0.0 and row["device"] == "cpu"
        assert row["bit_identical"] is True
        assert row["ms"] > 0 and row["edges_per_s"] > 0
    assert rows[1]["ker_mb"] * 2 == pytest.approx(rows[0]["ker_mb"],
                                                  abs=0.11)
    assert tune_univ.CONFIGS == [(8, 128), (16, 128), (32, 128), (64, 128),
                                 (32, 256), (16, 256)]
    assert tune_univ.PRECS == ["highest", "default"]
    a = tune_univ.build_parser().parse_args(["--one", "16", "256",
                                             "default"])
    assert a.one == ["16", "256", "default"] and a.device == "cuda"
    assert tune_univ.build_parser().parse_args(
        ["--device", "cpu"]).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tune_univ.run_one(8, 128, "highest", "cuda", inp)


def test_tune_univ_inputs_are_the_jax_scripts():
    """The same draws from seed 0 as scripts/tune_univ.py (made here at a
    smaller n, in the same order)."""
    n, c = 50, 3
    rng = np.random.default_rng(0)
    pts1 = rng.uniform(size=(n, 2)).astype(np.float32) * [400, 300]
    pts2 = rng.uniform(size=(n, 2)).astype(np.float32) * [400, 300]
    _, s1, d1 = build_edges(pts1, stg="tri")
    _, s2, d2 = build_edges(pts2, stg="tri")
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)
    inp = tune_univ.make_inputs("cpu", n=n, c=c)
    assert np.array_equal(inp.pts1, pts1) and np.array_equal(inp.pts2, pts2)
    for a, b in zip(inp.edges, (s1, d1, s2, d2)):
        assert np.array_equal(a, b)
    for a, b in ((inp.X, X), (inp.Kp, Kp), (inp.Ke, Ke)):
        assert np.array_equal(a.numpy(), b)


# ------------------------------------------------------------------ build
def test_library_tag_covers_the_headers(tmp_path, monkeypatch):
    """An edit to a shared `.cuh` header gives every library a new tag (a
    stale library is never loaded); an edit to one `.cu` only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = _build.sources()
    assert set(names) >= {"assoc_univ", "assoc_univ_v3", "assoc_bucket"}
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["common.cuh"]
    for n in names:
        assert '#include "common.cuh"' in (csrc / f"{n}.cu").read_text()
    before = {n: _build._lib_path(n) for n in names}
    assert before == {n: _build._lib_path(n) for n in names}   # stable
    with open(csrc / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    with open(csrc / "assoc_univ.cu", "a") as f:
        f.write("\n// edited\n")
    again = {n: _build._lib_path(n) for n in names}
    assert again["assoc_univ"] != after["assoc_univ"]
    assert all(again[n] == after[n] for n in names if n != "assoc_univ")


# --------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["highest", "default", "bf16"])
def test_cuda_kernel_matches_plain_on_the_card(rng, prec):
    """Needs a GPU and nvcc (run there with `pytest -m gpu`); chip_smoke.py
    makes the same comparisons at n=600. One launch per call, the same bits
    twice; f32 X within 1e-5 of the range of the plain version, bf16 X
    within one bf16 ulp of the kept part (rounded after an f32 sum in
    another order) more, and at most 1 % of the cells beyond the f32
    limit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no interpret mode")
    n, c = 200, 16
    p1, p2, s1, d1, s2, d2 = _pair(rng, n, n, scale=(400, 300))
    X, Kp, Ke = (tt(a).cuda() for a in _data(rng, n, n, c, len(s1),
                                                 len(s2)))
    precision = "highest" if prec == "bf16" else prec
    if prec == "bf16":
        X = X.bfloat16()
    dp = t_univ.plan_univ(p1, p2, s1, d1, s2, d2, r1=8, r2=128,
                          transpose=True).to("cuda")
    dt = t_univ.compute_dtype(X, precision)
    KeR = t_univ.gather_ke_blocks(Ke, dp, dt)
    before = t_univ.LAUNCHES["assoc_univ"]
    got = t_univ.assoc_matvec_univ(X, Kp, Ke, dp, KeR, precision=precision)
    again = t_univ.assoc_matvec_univ(X, Kp, Ke, dp, KeR, precision=precision)
    torch.cuda.synchronize()
    assert t_univ.LAUNCHES["assoc_univ"] == before + 2
    assert torch.equal(got, again)                      # no atomics
    want = t_univ.assoc_matvec_univ_plain(X, Kp, Ke, dp, KeR,
                                          precision=precision)
    scale = 1e-5 * float(want.abs().max())
    tol = scale
    if prec == "bf16":
        kept = t_univ._unsort(t_univ.kept_terms_plain(
            t_univ.halo(X, dp, dt), KeR, dp), dp)
        tol = tol + 2 ** -7 * kept.abs()
    err = (got - want).abs()
    assert bool((err <= tol).all())
    assert float((err > scale).float().mean()) <= 0.01   # a flipped rounding


@pytest.mark.gpu
def test_inoculate_every_library_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no interpret mode")
    before = t_inoc.LAUNCHES["inoculate"]
    secs = t_inoc.inoculate("cuda")
    assert sorted(secs) == _build.sources()
    assert t_inoc.LAUNCHES["inoculate"] == before + len(secs)
