"""The port's UNIV-scale association matvec (kernels/assoc_univ_v3) on the
CPU: its plain PyTorch version — the function the CUDA kernel is held
against on the card — versus the JAX package's Pallas kernel in interpret
mode and versus the gather/segment-sum op, on the cases of
tests/test_univ_kernel.py (Delaunay pair both orientations, spill-inducing
caps on the JAX side, zero-edge sides, a padded bucket)."""
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


def _port(X, Kp, Ke, n1, n2, s1, d1, s2, d2, transpose):
    plan = t_v3.plan_univ_v3(n1, n2, s1, d1, s2, d2, transpose=transpose)
    return plan, t2n(t_v3.assoc_matvec_univ_v3(tt(X), tt(Kp), tt(Ke),
                                               plan.to("cpu")))


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

    plan, got = _port(X, Kp, Ke, n1, n2, s1, d1, s2, d2, transpose)
    assert plan.s1 == np.bincount(d1 if transpose else s1).max()
    assert plan.s2 == np.bincount(d2 if transpose else s2).max()

    want = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jnp.asarray(s1),
        jnp.asarray(d1), jnp.asarray(s2), jnp.asarray(d2),
        transpose=transpose))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)

    # slot caps keep the interpreted kernel's unrolled (slot, slot, window)
    # nest short; what exceeds them goes through the JAX plan's spill lists
    jplan = j_v3.plan_univ_v3(pts2, s1, d1, s2, d2, transpose=transpose,
                              n1=n1, s1_cap=3, s2_cap=3)
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

    plan, got = _port(X, Kp, Ke, n, n, s1, d1, s2, d2, True)
    # every edge is in exactly one slot
    assert sorted(plan.e1_slot[plan.e1_slot >= 0]) == list(range(150))
    assert sorted(plan.e2_slot[plan.e2_slot >= 0]) == list(range(150))

    want = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jnp.asarray(s1),
        jnp.asarray(d1), jnp.asarray(s2), jnp.asarray(d2), transpose=True))
    tol = 2e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)

    jplan = j_v3.plan_univ_v3(pts2, s1, d1, s2, d2, transpose=True,
                              s1_cap=3, s2_cap=3)
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
    _, s2, d2 = _delaunay(rng, n)
    if both:
        s2, d2 = empty, empty
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = np.zeros((8, len(s2)), np.float32)[:0]

    plan, got = _port(X, Kp, Ke, n, n, empty, empty, s2, d2, True)
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
    _, s2, d2 = _delaunay(rng, n2)
    X = np.zeros((N, N, c), np.float32)
    X[:n1, :n2] = rng.normal(size=(n1, n2, c))
    Kp = np.zeros((N, N), np.float32)
    Kp[:n1, :n2] = rng.normal(size=(n1, n2))
    Ke = np.zeros((E, E), np.float32)
    Ke[:len(s1), :len(s2)] = rng.normal(size=(len(s1), len(s2)))
    pad = lambda a: np.pad(a, (0, E - len(a)))

    plan, got = _port(X, Kp, Ke, N, N, s1, d1, s2, d2, True)
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
    _, s2, d2 = _delaunay(rng, n)
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)
    plan, got = _port(X, Kp, Ke, n, n, s1, d1, s2, d2, transpose)
    assert plan.s1 == 80
    want = np.asarray(j_assoc_matvec(
        jnp.asarray(X), jnp.asarray(Kp), jnp.asarray(Ke), jnp.asarray(s1),
        jnp.asarray(d1), jnp.asarray(s2), jnp.asarray(d2),
        transpose=transpose))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_bf16_features_f32_accumulation(rng):
    """bf16 X: values are gathered and multiplied from the bf16-rounded X;
    Ke, the accumulator and the result stay f32 — so the result equals the
    f32 function of the rounded X to f32 accuracy, and sits within bf16
    rounding (2**-8 relative per term) of the unrounded one."""
    n, c = 30, 5
    _, s1, d1 = _delaunay(rng, n)
    _, s2, d2 = _delaunay(rng, n)
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)
    plan = t_v3.plan_univ_v3(n, n, s1, d1, s2, d2).to("cpu")
    Xb = tt(X).bfloat16()
    got = t_v3.assoc_matvec_univ_v3(Xb, tt(Kp), tt(Ke), plan)
    assert got.dtype == torch.float32
    same = t_v3.assoc_matvec_univ_v3(Xb.float(), tt(Kp), tt(Ke), plan)
    full = t_v3.assoc_matvec_univ_v3(tt(X), tt(Kp), tt(Ke), plan)
    scale = float(full.abs().max())
    assert float((got - same).abs().max()) <= 1e-5 * scale
    assert float((got - full).abs().max()) <= 2 ** -7 * scale


def test_wrapper_checks_and_cpu_route(rng, monkeypatch):
    """On CPU tensors the wrapper takes the plain version and launches
    nothing; wrong shapes / types / plan devices raise."""
    n, c = 10, 2
    _, s, d = _delaunay(rng, n)
    plan = t_v3.plan_univ_v3(n, n, s, d, s, d)
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
    # no slot limit: the kernel walks a row's slots in chunks
    big = t_v3.plan_univ_v3(3, 3, np.zeros(80, int), np.zeros(80, int),
                            np.zeros(1, int), np.zeros(1, int))
    assert big.s1 == 80


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_the_card(rng):
    """Needs a GPU and nvcc (run there with `pytest -m gpu`); chip_smoke.py
    makes the same comparison at the serving shapes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no interpret mode")
    n, c = 120, 17
    _, s1, d1 = _delaunay(rng, n)
    _, s2, d2 = _delaunay(rng, n)
    X = tt(rng.normal(size=(n, n, c)).astype(np.float32)).cuda()
    Kp = tt(rng.normal(size=(n, n)).astype(np.float32)).cuda()
    Ke = tt(rng.normal(size=(len(s1), len(s2))).astype(np.float32)).cuda()
    plan = t_v3.plan_univ_v3(n, n, s1, d1, s2, d2).to("cuda")
    before = t_v3.LAUNCHES["assoc_univ_v3"]
    got = t_v3.assoc_matvec_univ_v3(X, Kp, Ke, plan)
    torch.cuda.synchronize()
    assert t_v3.LAUNCHES["assoc_univ_v3"] == before + 1
    want = t_v3.assoc_matvec_univ_v3_plain(X, Kp, Ke, plan)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
