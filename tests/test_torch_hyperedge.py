"""The triangle hyperedge term and the classifier's k statistics on the CPU,
the port against the JAX package: `ops.assoc.assoc_tri_matvec` /
`assoc_tri_degree` and `ops.spline.hyperedge_angle_attrs` forward and
backward, the triangle lists of the synthetic batches and of the pipeline,
and the whole NGMNet with `hyperedge`, with `cls_k_features`, and with both
(f32 and `--bf16`), weights carried across by `convert.from_flax_variables`.

Bounds: the ops within 1e-5 of each result's largest value (the f32 sums
run in another order: JAX's segment sums, the port's one-hot products); the
triangle degree exactly. The model's outputs to test_torch_ngm's bounds (1e-4,
AFA-U's keys 1e-3, sk_tau 0.05 and damped AFA-U mixing), in bf16 to
test_torch_bf16's. One jitted Flax init with both options serves every
model test: the hyperedge-only and cls-k-only trees are cut from it (the
triangle affinity and `lin_t` dropped, or the three extra rows of the match
classifier's `fc`).
"""
import copy
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.core.build_graphs import delaunay_triangles
from fpmatch_tpu.data import benchmark as j_benchmark
from fpmatch_tpu.data import pipeline as j_pipeline
from fpmatch_tpu.data.synthetic import synthetic_pair_batch as j_synth
from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu.ops.assoc import assoc_tri_degree as j_tri_degree
from fpmatch_tpu.ops.assoc import assoc_tri_matvec as j_tri_matvec
from fpmatch_tpu.ops.spline import hyperedge_angle_attrs as j_angles
from fpmatch_tpu_torch.convert import from_flax_variables
from fpmatch_tpu_torch.data import benchmark as t_benchmark
from fpmatch_tpu_torch.data import pipeline as t_pipeline
from fpmatch_tpu_torch.data.synthetic import synthetic_pair_batch as t_synth
from fpmatch_tpu_torch.models import ngm as t_ngm
from fpmatch_tpu_torch.models.ngm import NGMNet, build_model
from fpmatch_tpu_torch.ops.assoc import assoc_tri_degree, assoc_tri_matvec
from fpmatch_tpu_torch.ops.spline import hyperedge_angle_attrs
from test_torch_bf16 import (_compare_outputs, bf16_cfg, compile_exact,
                             rel)
from test_torch_ngm import (_compare, _mixed_batch, _perm_equal_up_to_ties,
                            _torch_batch)
from test_torch_utils import (damp_afau_mixing, np_tree,
                              randomize_batch_stats, shared_init, t2n,
                              tiny_jax_config, to_torch_config)

OP_TOL = 1e-5
FIXTURE = Path(__file__).parent / "fixtures" / "PolyU-mini" / "DBII"


def tt(a):
    return torch.from_numpy(np.array(a))


def _tri_case(rng, B=2, n1=9, n2=8, t1=7, t2=5, C=3, pad=(2, 1)):
    """Random triangles (rectangular T1 != T2) whose last `pad` slots are
    padding: corners 0 and Kt 0, as the pipeline pads."""
    X = rng.normal(size=(B, n1, n2, C)).astype(np.float32)
    tri1 = rng.integers(0, n1, (B, t1, 3)).astype(np.int32)
    tri2 = rng.integers(0, n2, (B, t2, 3)).astype(np.int32)
    m1 = np.arange(t1)[None] < t1 - pad[0] - np.arange(B)[:, None]
    m2 = np.arange(t2)[None] < t2 - pad[1] - np.arange(B)[:, None] * 0
    tri1[~m1] = 0
    tri2[~m2] = 0
    Kt = rng.normal(size=(B, t1, t2)).astype(np.float32)
    Kt *= m1[:, :, None] & m2[:, None, :]
    return X, Kt, tri1, tri2, m1, m2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assoc_tri_matvec_and_degree_match_jax(rng, dtype):
    """Forward and the gradients in X and Kt (a random cotangent through
    `jax.vjp` against torch.autograd), padded slots and T1 != T2 included;
    with bf16 X both sides sum each corner pair in bf16. The degree is the
    same counts exactly."""
    X, Kt, tri1, tri2, m1, m2 = _tri_case(rng)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    Xj = jnp.asarray(X).astype(jdt)
    fn = jax.vmap(j_tri_matvec)
    want, vjp = jax.vjp(lambda x, k: fn(x, k, tri1, tri2), Xj,
                        jnp.asarray(Kt))
    dY = rng.normal(size=want.shape).astype(np.float32)
    jdX, jdKt = vjp(jnp.asarray(dY).astype(want.dtype))

    Xt = tt(X).to(getattr(torch, dtype)).requires_grad_()
    Kt_t = tt(Kt).requires_grad_()
    got = assoc_tri_matvec(Xt, Kt_t, tt(tri1), tt(tri2))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel(t2n(got), want) <= OP_TOL
    got.backward(tt(dY))
    assert Xt.grad.dtype == Xt.dtype
    assert rel(t2n(Xt.grad.float()), np.asarray(jdX, np.float32)) <= (
        OP_TOL if dtype == "float32" else 2.0 ** -8)
    assert rel(t2n(Kt_t.grad), jdKt) <= OP_TOL

    n1, n2 = X.shape[1], X.shape[2]
    jdeg = jax.vmap(lambda a, b, c, d: j_tri_degree(a, b, c, d, n1, n2))(
        m1, m2, tri1, tri2)
    deg = assoc_tri_degree(tt(m1), tt(m2), tt(tri1), tt(tri2), n1, n2)
    assert np.array_equal(t2n(deg), np.asarray(jdeg))
    assert deg.sum() > 0


def test_hyperedge_angle_attrs_match_jax_with_finite_padded_gradient(rng):
    """Cosines of the corner angles, zero on padded slots (which alias node
    0, so their edge vectors are 0): the forward within 1e-5, the gradient
    in x finite and equal to JAX's (the safe norm)."""
    G, N, F, T = 2, 7, 5, 6
    x = rng.normal(size=(G, N, F)).astype(np.float32)
    tri = np.stack([rng.permutation(N)[:3] for _ in range(G * T)]).reshape(
        G, T, 3).astype(np.int32)
    mask = (np.arange(T)[None] < np.array([[4], [6]])).astype(np.float32)
    tri[mask == 0] = 0
    want, vjp = jax.vjp(lambda a: jax.vmap(j_angles)(a, tri, mask),
                        jnp.asarray(x))
    dY = rng.normal(size=want.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(dY))
    xt = tt(x).requires_grad_()
    got = hyperedge_angle_attrs(xt, tt(tri), tt(mask))
    assert rel(t2n(got), want) <= OP_TOL
    assert (t2n(got)[mask == 0] == 0).all()
    got.backward(tt(dY))
    assert torch.isfinite(xt.grad).all()
    assert rel(t2n(xt.grad), jdx) <= OP_TOL


def test_triangle_batches_bit_identical_to_jax(tmp_path):
    """`synthetic_pair_batch` and `PairDataset` -> `collate` with
    `hyperedge=True` give the JAX package's `tri` / `n_tris` (and every
    other field) bit for bit; t_max cuts the triangle lists."""
    jcfg = tiny_jax_config(n_max=16, e_max=96, hyperedge=True)
    tcfg = to_torch_config(jcfg)
    jb = j_synth(jcfg, 3, genuine_ratio=0.5, n_range=(10, 15),
                 image_hw=(32, 48), seed=4)
    tb = t_synth(tcfg, 3, genuine_ratio=0.5, n_range=(10, 15),
                 image_hw=(32, 48), seed=4)
    for name, a, b in zip(jb._fields, jb, tb):
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(np.asarray(a), b), name
            assert np.asarray(a).dtype == b.dtype, name
    assert tb.tri.shape == (3, 2, 16, 3)
    assert (tb.n_tris == 16).any()              # cut at t_max

    kw = dict(root=str(FIXTURE), task="classify")
    for sets in ("train", "test"):
        jpd = j_pipeline.PairDataset(j_benchmark.make_benchmark(
            "PolyUDBII", sets, output_dir=str(tmp_path / "j"), **kw), jcfg)
        tpd = t_pipeline.PairDataset(t_benchmark.make_benchmark(
            "PolyUDBII", sets, output_dir=str(tmp_path / "t"), **kw), tcfg)
        idx = [0, len(tpd) - 1]
        want = j_pipeline.collate([jpd.get(i) for i in idx], jcfg)
        got = t_pipeline.collate([tpd.get(i) for i in idx], tcfg)
        for name in ("tri", "n_tris", "points", "n_nodes", "src"):
            a, b = np.asarray(getattr(want, name)), getattr(got, name)
            assert np.array_equal(a, b) and a.dtype == b.dtype, (sets, name)
        assert got.n_tris.min() > 0


# ------------------------------------------------------------- the model
def _with_triangles(b, t_max):
    """`_mixed_batch` cuts nodes off some views: their triangles are made
    again from the points that stay (the JAX package's Delaunay)."""
    B = b.points.shape[0]
    tri = np.zeros((B, 2, t_max, 3), np.int32)
    n_tris = np.zeros((B, 2), np.int32)
    for i in range(B):
        for v in range(2):
            tv = delaunay_triangles(b.points[i, v, :b.n_nodes[i, v]])[:t_max]
            tri[i, v, :len(tv)] = tv
            n_tris[i, v] = len(tv)
    return b._replace(tri=tri, n_tris=n_tris)


def _cut(v, hyperedge, cls_k):
    """The variables of a model with fewer options, cut from `both`'s."""
    v = copy.deepcopy(v)
    p = v["params"]
    if not hyperedge:
        del p["tri_aff"]
        for i in range(3):
            del p[f"gnn_{i}"]["lin_t"]
    if not cls_k:
        fc = p["match_cls"]["fc"]
        fc["kernel"] = fc["kernel"][:-3]
    return v


@pytest.fixture(scope="module")
def both_case():
    """B = 3 (n1 == n2, n1 < n2, n1 > n2 impostor) with triangles, and one
    jitted Flax init of the model with both options (random BatchNorm
    statistics, damped AFA-U mixing)."""
    import dataclasses

    jcfg = tiny_jax_config(sk_tau=0.05, hyperedge=True, cls_k_features=True)
    # 12 triangle slots: the larger views' 14 triangles are cut
    jcfg = dataclasses.replace(jcfg, shapes=dataclasses.replace(
        jcfg.shapes, t_max=12))
    batch = _with_triangles(_mixed_batch(jcfg, seed=3), jcfg.shapes.t_max)
    assert (batch.n_tris == jcfg.shapes.t_max).any()
    v = damp_afau_mixing(randomize_batch_stats(shared_init(jcfg)))
    return jcfg, batch, v


def _jax_forward(jcfg, v, batch):
    return jax.jit(functools.partial(JNet(jcfg).apply, train=False))(
        v, batch)


def _replay_jax_picks(monkeypatch, want):
    """The port's greedy fill must keep as many matches as the JAX one and
    pick alike up to ties of the JAX ranking map (test_torch_ngm); JAX's
    picks are then used, so the classifier's outputs are compared on the
    same picks (near-uniform maps at random init hold ties at 1e-6, which
    JAX's own jitted and eager runs break differently)."""
    jperm = torch.from_numpy(np.array(want["perm_mat"]))
    real = t_ngm.greedy_perm_batch

    def same_ties(rank, ks, n1, n2):
        _perm_equal_up_to_ties(want, {"perm_mat": real(rank, ks, n1, n2)})
        return jperm

    monkeypatch.setattr(t_ngm, "greedy_perm_batch", same_ties)


@pytest.mark.parametrize("hyperedge,cls_k", [(True, False), (False, True),
                                             (True, True)])
def test_ngm_options_match_jax(both_case, hyperedge, cls_k, monkeypatch):
    """Every output key against the JAX model of the same options, 1e-4
    (AFA-U's keys 1e-3), perm_mat up to ties (`_replay_jax_picks`); the
    options are live (the triangle term moves the scores; the k statistics
    move the logits)."""
    import dataclasses

    jcfg0, batch, v0 = both_case
    jcfg = dataclasses.replace(jcfg0, ngm=dataclasses.replace(
        jcfg0.ngm, hyperedge=hyperedge, cls_k_features=cls_k))
    v = _cut(np_tree(v0), hyperedge, cls_k)
    if not hyperedge:
        batch = batch._replace(tri=None, n_tris=None)
    want = _jax_forward(jcfg, v, batch)
    tcfg = to_torch_config(jcfg)
    net = build_model(tcfg, device="cpu",
                      state_dict=from_flax_variables(v, tcfg))
    assert hasattr(net, "tri_aff") == hyperedge
    assert net.match_cls.fc.in_features == 32 + 3 * cls_k
    tb = _torch_batch(batch).to("cpu")
    _replay_jax_picks(monkeypatch, want)
    got = net(tb)
    _compare(want, got, 1e-4)
    monkeypatch.undo()
    if hyperedge:
        none = net(tb._replace(n_tris=torch.zeros_like(tb.n_tris)))
        assert not torch.allclose(none["raw_scores"], got["raw_scores"])
    if cls_k:
        with torch.no_grad():
            net.match_cls.fc.weight[0, -3:] += 1.0
        moved = net(tb)
        assert not torch.allclose(moved["cls_logits"], got["cls_logits"])


def _j_tri_aff(cfg, v, batch):
    """The JAX forward (exact bf16 rounding) and its `tri_aff` output (the
    triangle affinity before the 0.5)."""
    out, inter = compile_exact(
        lambda v, b: JNet(cfg).apply(
            v, b, train=False, mutable=["intermediates"],
            capture_intermediates=lambda m, _: m.name == "tri_aff"),
        v, batch)
    return out, np.asarray(inter["intermediates"]["tri_aff"]["__call__"][0],
                           np.float32)


def test_ngm_both_options_bf16_match_jax(both_case, monkeypatch):
    """Both options under `--bf16` against the JAX model in bf16 (exact
    bf16 rounding, test_torch_bf16.compile_exact) at that file's sk_tau
    0.5. The triangle affinities are the one ill-conditioned step: their
    corner-angle cosines take differences of nearly equal bf16 feature
    vectors (at this tiny width and image size), so one bf16 ulp of a
    node feature moves Kt by percents, and JAX's own bf16 Kt is 0.15 from
    its f32 Kt here. So:
      * the port's bf16 Kt lies within a quarter of that gap of JAX's bf16
        Kt (the port really runs the bf16 path, and runs it alike);
      * given JAX's bf16 Kt, every output of the port agrees with JAX's to
        test_torch_bf16's model bounds (1e-4, AFA-U 1e-3, picks up to
        ties): the triangle term reads the layer's input as it comes (f32
        in the first layer, bf16 after), `lin_t` runs in bf16, the angle
        cosines in f32."""
    import dataclasses

    jcfg, batch, v = both_case
    jcfg = dataclasses.replace(jcfg, ngm=dataclasses.replace(jcfg.ngm,
                                                             sk_tau=0.5))
    bcfg = bf16_cfg(jcfg)
    v = np_tree(v)
    want, j_kt = _j_tri_aff(bcfg, v, batch)
    _, j_kt32 = _j_tri_aff(jcfg, v, batch)
    sd = from_flax_variables(v, to_torch_config(jcfg))
    net = build_model(to_torch_config(bcfg), device="cpu", state_dict=sd)
    seen, kt = [], {}
    real = t_ngm.hyperedge_angle_attrs
    monkeypatch.setattr(t_ngm, "hyperedge_angle_attrs",
                        lambda x, *a: seen.append(x.dtype) or real(x, *a))
    tb = _torch_batch(batch).to("cpu")
    hook = net.tri_aff.register_forward_hook(
        lambda m, a, o: kt.setdefault("port", o))
    net(tb)
    hook.remove()
    assert seen == [torch.float32]
    gap = np.abs(j_kt32 - j_kt).max()
    assert gap > 0.05
    assert np.abs(t2n(kt["port"]) - j_kt).max() <= gap / 4

    net.tri_aff.register_forward_hook(lambda m, a, o: tt(j_kt))
    got = net(tb)
    assert got["raw_scores"].dtype == torch.float32
    _compare_outputs(want, got)


def test_ngm_hyperedge_refuses_the_univ_route(both_case):
    """The JAX model raises "hyperedge + univ kernel" for a UNIV plan; so
    does the port, before any aggregation."""
    from fpmatch_tpu_torch.kernels.assoc_univ_v3 import plan_univ_v3

    jcfg, batch, v = both_case
    tcfg = to_torch_config(jcfg)
    net = build_model(tcfg, device="cpu",
                      state_dict=from_flax_variables(np_tree(v), tcfg))
    b1 = _torch_batch(jax.tree_util.tree_map(lambda a: a[:1], batch))
    N = tcfg.shapes.n_max
    ne = b1.n_edges[0]
    pts = np.full((N, 2), 1e9, np.float32)
    pts[:, 0] += np.arange(N)
    plan = plan_univ_v3(pts, b1.src[0, 0, :ne[0]], b1.dst[0, 0, :ne[0]],
                        b1.src[0, 1, :ne[1]], b1.dst[0, 1, :ne[1]],
                        transpose=True, n1=N)
    with pytest.raises(NotImplementedError, match="hyperedge \\+ univ"):
        net(b1.to("cpu"), univ_plan=plan)
    assert isinstance(net, NGMNet)
