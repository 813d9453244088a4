"""The port's UNIV-scale association matvec (kernels/assoc_univ_v3) on the
CPU: its plain PyTorch version — the function the CUDA kernel is held
against on the card — versus the JAX package's Pallas kernel in interpret
mode and versus the gather/segment-sum op, on the cases of
tests/test_univ_kernel.py (Delaunay pair both orientations, spill-inducing
caps on both plans, zero-edge sides, a padded bucket); the port's kept /
spilled flags against the JAX plan's spill lists, bf16 X against the JAX
kernel's bf16 path, and the CUDA kernel's own tables walked in numpy."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.kernels import assoc_univ_v3 as j_v3
from fpmatch_tpu.ops.assoc import assoc_matvec as j_assoc_matvec
from fpmatch_tpu_torch.kernels import assoc_univ_v3 as t_v3
from fpmatch_tpu_torch.ops.assoc import assoc_matvec as t_assoc_matvec
from test_torch_utils import t2n


def tt(a):
    return torch.from_numpy(np.asarray(a))


def _delaunay(rng, n):
    pts = rng.uniform(size=(n, 2)).astype(np.float32) * [400, 300]
    _, s, d = build_edges(pts, stg="tri")
    return pts, s, d


def _port(X, Kp, Ke, pts2, s1, d1, s2, d2, transpose, n1=None, caps=None):
    plan = t_v3.plan_univ_v3(pts2, s1, d1, s2, d2, transpose=transpose,
                             n1=n1, **(caps or {}))
    return plan, t2n(t_v3.assoc_matvec_univ_v3(tt(X), tt(Kp), tt(Ke),
                                               plan.to("cpu")))


# slot caps keep the interpreted Pallas kernel's unrolled (slot, slot,
# window) nest short and make its plan spill; the port's plan is given the
# same caps, which decide its kept / spilled flags (and nothing else)
CAPS = dict(s1_cap=3, s2_cap=3)


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("c", [1, 17])
def test_plain_matches_pallas_interpret_and_xla(rng, transpose, c):
    """Delaunay pair, n1 != n2, C = 1 and 17 (the model's channel counts).
    f32; sums are taken in another order: 1e-5 of the value range."""
    n1, n2 = 40, 48
    _, s1, d1 = _delaunay(rng, n1)
    pts2, s2, d2 = _delaunay(rng, n2)
    X = rng.normal(size=(n1, n2, c)).astype(np.float32)
    Kp = rng.normal(size=(n1, n2)).astype(np.float32)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)

    plan, got = _port(X, Kp, Ke, pts2, s1, d1, s2, d2, transpose, n1=n1,
                      caps=CAPS)
    assert plan.s1 == np.bincount(d1 if transpose else s1).max()
    assert plan.s2 == np.bincount(d2 if transpose else s2).max()

    want = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jnp.asarray(s1),
        jnp.asarray(d1), jnp.asarray(s2), jnp.asarray(d2),
        transpose=transpose))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)

    # what exceeds the caps goes through the JAX plan's spill lists
    jplan = j_v3.plan_univ_v3(pts2, s1, d1, s2, d2, transpose=transpose,
                              n1=n1, **CAPS)
    pallas = np.asarray(j_v3.assoc_matvec_univ_v3(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jplan,
        j_v3.build_kep(jnp.asarray(Ke), jplan), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=tol)

    # and against the port's own gather / index_add_ op (no plan)
    own = t2n(t_assoc_matvec(tt(X)[None], tt(Kp)[None], tt(Ke)[None],
                             tt(s1)[None], tt(d1)[None], tt(s2)[None],
                             tt(d2)[None], transpose=transpose))[0]
    np.testing.assert_allclose(got, own, rtol=1e-5, atol=tol)


def test_nonlocal_graphs_that_spill_on_the_tpu_side(rng):
    """Random (non-local) graphs with repeated edges and tiny slot caps make
    the JAX plan spill rows and columns to its postlude; the port's plan has
    a slot for every edge. All three must agree."""
    n, c = 36, 4

    def rg(n, m):
        src = rng.integers(0, n, size=m).astype(np.int32)
        dst = (src + rng.integers(1, n, size=m).astype(np.int32)) % n
        return src, dst

    s1, d1 = rg(n, 150)
    s2, d2 = rg(n, 150)
    pts2 = rng.uniform(size=(n, 2)).astype(np.float32)
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = rng.normal(size=(150, 150)).astype(np.float32)

    plan, got = _port(X, Kp, Ke, pts2, s1, d1, s2, d2, True, n1=n,
                      caps=CAPS)
    # every edge is in exactly one slot
    assert sorted(plan.e1_slot[plan.e1_slot >= 0]) == list(range(150))
    assert sorted(plan.e2_slot[plan.e2_slot >= 0]) == list(range(150))

    want = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jnp.asarray(s1),
        jnp.asarray(d1), jnp.asarray(s2), jnp.asarray(d2), transpose=True))
    tol = 2e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)

    jplan = j_v3.plan_univ_v3(pts2, s1, d1, s2, d2, transpose=True,
                              **CAPS)
    assert len(jplan.spill1) > 0 and len(jplan.spill2) > 0
    pallas = np.asarray(j_v3.assoc_matvec_univ_v3(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jplan,
        j_v3.build_kep(jnp.asarray(Ke), jplan), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=10 * tol)


@pytest.mark.parametrize("both", [False, True])
def test_zero_edge_sides(rng, both):
    """A 1-2 keypoint image has no Delaunay edges: the plan keeps >= 1 slot
    per side, `Ke[:0]` is accepted, and with no edges at all the result is
    the Kp diagonal."""
    n, c = 20, 4
    empty = np.zeros(0, np.int32)
    pts2, s2, d2 = _delaunay(rng, n)
    if both:
        s2, d2 = empty, empty
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = np.zeros((8, len(s2)), np.float32)[:0]

    plan, got = _port(X, Kp, Ke, pts2, empty, empty, s2, d2, True, n1=n)
    assert plan.s1 >= 1 and plan.s2 >= 1
    assert (plan.e1_slot == -1).all()
    np.testing.assert_allclose(got, Kp[..., None] * X, rtol=1e-6, atol=1e-6)
    want = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), empty, empty,
        jnp.asarray(s2), jnp.asarray(d2), transpose=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_padded_bucket_with_wider_ke(rng):
    """The model's shapes: a bucket of 32 nodes holding 26 / 29 real ones,
    Ke padded to (E_MAX, E_MAX) with zeros, edge lists padded with slots
    that alias node 0. The plan is built from the REAL edges; the padded
    op is the reference."""
    N, E, c = 32, 200, 3
    n1, n2 = 26, 29
    _, s1, d1 = _delaunay(rng, n1)
    p2, s2, d2 = _delaunay(rng, n2)
    pts2 = t_v3.pad_points(p2, N)              # padded as the CLI pads it
    X = np.zeros((N, N, c), np.float32)
    X[:n1, :n2] = rng.normal(size=(n1, n2, c))
    Kp = np.zeros((N, N), np.float32)
    Kp[:n1, :n2] = rng.normal(size=(n1, n2))
    Ke = np.zeros((E, E), np.float32)
    Ke[:len(s1), :len(s2)] = rng.normal(size=(len(s1), len(s2)))
    pad = lambda a: np.pad(a, (0, E - len(a)))

    plan, got = _port(X, Kp, Ke, pts2, s1, d1, s2, d2, True, n1=N)
    assert (plan.e1_slot[n1:] == -1).all() and (plan.e2_slot[n2:] == -1).all()
    want = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), pad(s1), pad(d1),
        pad(s2), pad(d2), transpose=True))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert (got[n1:] == 0).all() and (got[:, n2:] == 0).all()


def _star(n_leaves):
    """Both directions between node 0 and nodes 1..n_leaves: node 0 has
    in- and out-degree n_leaves, every other node 1."""
    k = np.arange(1, n_leaves + 1, dtype=np.int32)
    z = np.zeros(n_leaves, np.int32)
    return np.concatenate([k, z]), np.concatenate([z, k])


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("c", [1, 17])
def test_degree_80_star_has_no_slot_limit(rng, transpose, c):
    """A star with 80 edges into (and out of) node 0 of graph 1: the row of
    node 0 has 80 slots, more than the kernel stages in shared memory at
    once. The plan takes it, and the plain version equals the JAX gather /
    segment-sum op at 1e-5 of the value range."""
    n = 90
    s1, d1 = _star(80)
    pts2, s2, d2 = _delaunay(rng, n)
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)
    plan, got = _port(X, Kp, Ke, pts2, s1, d1, s2, d2, transpose, n1=n)
    assert plan.s1 == 80
    want = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jnp.asarray(s1),
        jnp.asarray(d1), jnp.asarray(s2), jnp.asarray(d2),
        transpose=transpose))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_bf16_features_f32_accumulation(rng):
    """bf16 X: values are gathered from the bf16-rounded X and Ke is rounded
    to bf16 on the pairs the JAX plan keeps (keep1[e1] and keep2[e2]), f32
    Ke on the spilled pairs; products, sums and result f32. So the result is
    the f32 function of the rounded X and that mixed Ke, bit for bit, and
    sits within bf16 rounding of the unrounded one."""
    n, c = 30, 5
    _, s1, d1 = _delaunay(rng, n)
    pts2, s2, d2 = _delaunay(rng, n)
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)
    hp = t_v3.plan_univ_v3(pts2, s1, d1, s2, d2, **CAPS)
    assert (~hp.keep1).any() and (~hp.keep2).any() and hp.keep1.any()
    plan = hp.to("cpu")
    Xb = tt(X).bfloat16()
    got = t_v3.assoc_matvec_univ_v3(Xb, tt(Kp), tt(Ke), plan)
    assert got.dtype == torch.float32
    kept = np.outer(hp.keep1, hp.keep2)
    mixed = np.where(kept, t2n(tt(Ke).bfloat16().float()), Ke)
    same = t_v3.assoc_matvec_univ_v3(Xb.float(), tt(Kp), tt(mixed), plan)
    assert torch.equal(got, same)
    full = t_v3.assoc_matvec_univ_v3(tt(X), tt(Kp), tt(Ke), plan)
    scale = float(full.abs().max())
    assert float((got - full).abs().max()) <= 2 ** -7 * scale


def _spill_cases(rng):
    """(pts2, edges, transpose, n1, caps) of the Delaunay pair in both
    orientations with the test caps and with the JAX plan's automatic caps,
    of the spill-heavy non-local graph of
    test_nonlocal_graphs_that_spill_on_the_tpu_side, and of the Delaunay
    pair in a padded bucket of 64 as the serving CLI plans it."""
    n1, n2 = 40, 48
    _, s1, d1 = _delaunay(rng, n1)
    pts2, s2, d2 = _delaunay(rng, n2)
    cases = [(pts2, (s1, d1, s2, d2), t, n1, caps)
             for t in (True, False) for caps in (CAPS, {})]
    n = 36
    rg = lambda: (lambda s: (s, (s + rng.integers(1, n, 150)) % n))(
        rng.integers(0, n, 150))
    (a1, b1), (a2, b2) = rg(), rg()
    cases.append((rng.uniform(size=(n, 2)).astype(np.float32),
                  (a1, b1, a2, b2), True, n, CAPS))
    # the serving CLI's padded bucket (pad nodes sorted last), automatic caps
    N = 64
    cases.append((t_v3.pad_points(pts2, N), (s1, d1, s2, d2), True, N, {}))
    return cases


def test_kept_flags_are_the_jax_plans_complement_of_its_spills(rng):
    """The port's keep1 / keep2 are the complement of the JAX plan's spill1
    / spill2, edge for edge, for Delaunay pairs in both orientations (test
    caps and automatic caps), for the spill-heavy non-local graph and for a
    padded bucket planned as the serving CLIs plan it."""
    for pts2, edges, transpose, n1, caps in _spill_cases(rng):
        hp = t_v3.plan_univ_v3(pts2, *edges, transpose=transpose, n1=n1,
                               **caps)
        jp = j_v3.plan_univ_v3(pts2, *edges, transpose=transpose, n1=n1,
                               **caps)
        want1 = np.ones(len(edges[0]), bool)
        want1[jp.spill1] = False
        want2 = np.ones(len(edges[2]), bool)
        want2[jp.spill2] = False
        np.testing.assert_array_equal(hp.keep1, want1)
        np.testing.assert_array_equal(hp.keep2, want2)
        if caps:
            assert not want1.all() and not want2.all()


@pytest.mark.parametrize("case", ["delaunay_t", "delaunay_f", "nonlocal"])
def test_bf16_plain_matches_pallas_bf16_path(rng, case):
    """bf16 X through the JAX kernel's bf16 path (KeP rounded to bf16 by
    build_kep, spilled pairs in f32; interpret mode) and through the port's
    plain version: the same products, so within 1e-5 of the range (only the
    order of the f32 sums differs)."""
    pts2, edges, transpose, n1, caps = {
        "delaunay_t": lambda c: c[0], "delaunay_f": lambda c: c[2],
        "nonlocal": lambda c: c[4]}[case](_spill_cases(rng))
    n2, c = len(pts2), 17
    X = rng.normal(size=(n1, n2, c)).astype(np.float32)
    Kp = rng.normal(size=(n1, n2)).astype(np.float32)
    Ke = rng.normal(size=(len(edges[0]), len(edges[2]))).astype(np.float32)
    plan = t_v3.plan_univ_v3(pts2, *edges, transpose=transpose, n1=n1,
                             **caps).to("cpu")
    got = t2n(t_v3.assoc_matvec_univ_v3(tt(X).bfloat16(), tt(Kp), tt(Ke),
                                        plan))
    jp = j_v3.plan_univ_v3(pts2, *edges, transpose=transpose, n1=n1, **caps)
    want = np.asarray(j_v3.assoc_matvec_univ_v3(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jp,
        j_v3.build_kep(jnp.asarray(Ke), jp, dtype=jnp.bfloat16),
        compute_dtype=jnp.bfloat16, interpret=True))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    # an all-f32 Ke (the port before the kept-pair rounding) is further off
    f32_ke = t2n(t_v3.assoc_matvec_univ_v3(
        tt(X).bfloat16().float(), tt(Kp), tt(Ke), plan))
    assert np.abs(f32_ke - want).max() > 1e-5 * scale


def _walk(hp, X, Kp, Ke, rounded):
    """The CUDA kernel's loops over its own tables, in numpy (f64 sums): a
    block per row of rows1 over ptr1 / ent1, a thread per position t of
    cols2 over its slice of ent2; spill bits decide the bf16 rounding."""
    n1, n2, C = X.shape
    Y = Kp[..., None].astype(np.float64) * X
    seen = np.zeros((len(hp.keep1), len(hp.keep2)), np.int64)
    for i1 in hp.rows1:
        for in1, f1 in hp.ent1[hp.ptr1[i1]:hp.ptr1[i1 + 1]]:
            e1 = f1 & 0x7fffffff
            for t in range(n2):
                at = hp.sptr2[t // 32] + t % 32 + 32 * np.arange(hp.cnt2[t])
                for in2, f2 in hp.ent2[at]:
                    e2 = f2 & 0x7fffffff
                    seen[e1, e2] += 1
                    ke = Ke[e1, e2]
                    if rounded and f1 >= 0 and f2 >= 0:
                        ke = t2n(tt(np.float32(ke)).bfloat16().float())
                    Y[i1, hp.cols2[t]] += ke * X[in1, in2]
    return Y, seen


@pytest.mark.parametrize("rounded", [False, True])
def test_kernel_tables_count_every_pair_once(rng, rounded):
    """The kernel's tables (degree-sorted rows, per-warp slices of the
    degree-sorted graph-2 CSR, spill bits), walked as the kernel walks them:
    every (e1, e2) pair once, and the result of the plain version; with the
    bf16 rounding, that of the plain version on bf16 X."""
    pts2, edges, transpose, n1, caps = _spill_cases(rng)[4]    # non-local
    n2, c = len(pts2), 3
    hp = t_v3.plan_univ_v3(pts2, *edges, transpose=transpose, n1=n1, **caps)
    assert (np.diff(hp.cnt2) <= 0).all()              # largest first
    assert (np.diff(np.diff(hp.ptr1)[hp.rows1]) <= 0).all()
    X = rng.normal(size=(n1, n2, c)).astype(np.float32)
    if rounded:
        X = t2n(tt(X).bfloat16().float())
    Kp = rng.normal(size=(n1, n2)).astype(np.float32)
    Ke = rng.normal(size=(len(edges[0]), len(edges[2]))).astype(np.float32)
    Y, seen = _walk(hp, X, Kp, Ke, rounded)
    assert (seen == 1).all()
    xin = tt(X).bfloat16() if rounded else tt(X)
    want = t2n(t_v3.assoc_matvec_univ_v3(xin, tt(Kp), tt(Ke), hp.to("cpu")))
    np.testing.assert_allclose(Y, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_wrapper_checks_and_cpu_route(rng, monkeypatch):
    """On CPU tensors the wrapper takes the plain version and launches
    nothing; wrong shapes / types / plan devices raise."""
    n, c = 10, 2
    pts, s, d = _delaunay(rng, n)
    plan = t_v3.plan_univ_v3(pts, s, d, s, d)
    X = torch.zeros(n, n, c)
    Kp = torch.zeros(n, n)
    Ke = torch.zeros(len(s), len(s))
    before = dict(t_v3.LAUNCHES)
    monkeypatch.setattr(t_v3, "_launch", lambda *a: pytest.fail(
        "the CUDA kernel must not be launched for CPU tensors"))
    t_v3.assoc_matvec_univ_v3(X, Kp, Ke, plan.to("cpu"))
    assert t_v3.LAUNCHES == before
    with pytest.raises(TypeError):
        t_v3.assoc_matvec_univ_v3(X, Kp, Ke, plan)          # host plan
    with pytest.raises(TypeError):
        t_v3.assoc_matvec_univ_v3(X.double(), Kp, Ke, plan.to("cpu"))
    with pytest.raises(ValueError):
        t_v3.assoc_matvec_univ_v3(X[:5], Kp, Ke, plan.to("cpu"))
    with pytest.raises(ValueError):     # Ke narrower than the plan's edges
        t_v3.assoc_matvec_univ_v3(X, Kp, Ke[:, :-1], plan.to("cpu"))
    # no slot limit: a row's edges are a CSR run of any length
    big = t_v3.plan_univ_v3(np.zeros((3, 2)), np.zeros(80, int),
                            np.zeros(80, int), np.zeros(1, int),
                            np.zeros(1, int), n1=3)
    assert big.s1 == 80 and np.diff(big.ptr1).max() == 80


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_the_card(rng):
    """Needs a GPU and nvcc (run there with `pytest -m gpu`); chip_smoke.py
    makes the same comparison at the serving shapes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no interpret mode")
    n, c = 120, 17
    _, s1, d1 = _delaunay(rng, n)
    pts2, s2, d2 = _delaunay(rng, n)
    X = tt(rng.normal(size=(n, n, c)).astype(np.float32)).cuda()
    Kp = tt(rng.normal(size=(n, n)).astype(np.float32)).cuda()
    Ke = tt(rng.normal(size=(len(s1), len(s2))).astype(np.float32)).cuda()
    plan = t_v3.plan_univ_v3(pts2, s1, d1, s2, d2, **CAPS).to("cuda")
    before = t_v3.LAUNCHES["assoc_univ_v3"]
    got = t_v3.assoc_matvec_univ_v3(X, Kp, Ke, plan)
    torch.cuda.synchronize()
    assert t_v3.LAUNCHES["assoc_univ_v3"] == before + 1
    want = t_v3.assoc_matvec_univ_v3_plain(X, Kp, Ke, plan)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, t_v3.assoc_matvec_univ_v3(X, Kp, Ke, plan))
    # bf16 X: each term rounds as in the plain version, so the same limit
    got = t_v3.assoc_matvec_univ_v3(X.bfloat16(), Kp, Ke, plan)
    want = t_v3.assoc_matvec_univ_v3_plain(X.bfloat16(), Kp, Ke, plan)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_timing_script_needs_a_card():
    """scripts/time_univ_v3.py times the kernel on the card only: without a
    CUDA device it stops before timing anything."""
    from fpmatch_tpu_torch.scripts import time_univ_v3
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        time_univ_v3.main([])
