"""`--bf16` mixed precision on the CPU: the port against the JAX package in
bfloat16, op by op, layer by layer, the whole model on both routes, one train
step, the association matvec's bf16 gradient, and the three CLIs.

What bf16 means is the JAX package's explicit casts (`fpmatch_tpu/models/
ngm.py`, `backbone.py`, `layers.py`, `ops/`): bf16 convolutions with f32
BatchNorms, a bf16 graph side with f32 affinities, f32 sums and an f32 tail
(Sinkhorn, AFA-U, soft top-k, the classifiers, the losses), f32 parameters.

The reference rounds after every op. XLA on the CPU is allowed by default to
skip the bf16 rounding between the ops it fuses under `jit`
(`xla_allow_excess_precision`), which moves a jitted bf16 result by up to a
bf16 ulp of an intermediate at each such place: so every jitted JAX
reference here is compiled with that option off (`compile_exact`), and is
then the op-by-op computation the JAX code writes down (as its eager run).

Bounds: a single op or layer agrees within 2**-6 of each tensor's largest
magnitude (both sides round at the same places; what is left is the order of
f32 sums inside bf16 matmuls and convolutions). Model-level tests hold the
model's outputs as test_torch_ngm does (sk_tau 0.05, damped AFA-U mixing,
greedy picks compared up to ties), and check that the port really ran in
bf16: on Kp, Ke and the first assoc-GNN layer's output, the port's bf16 is
closer to JAX's bf16 than JAX's f32 is.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.core.config import default_stages as j_stages
from fpmatch_tpu.data.synthetic import synthetic_pair_batch as j_synth
from fpmatch_tpu.kernels.assoc_univ_v3 import plan_univ_v3 as j_plan
from fpmatch_tpu.models import backbone as j_bb
from fpmatch_tpu.models import layers as j_layers
from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu.ops.assoc import assoc_matvec as j_assoc_matvec
from fpmatch_tpu.ops.feature_align import feature_align as j_feature_align
from fpmatch_tpu.ops.spline import spline_conv as j_spline_conv
from fpmatch_tpu.train import state as j_state
from fpmatch_tpu.train import step as j_step
from fpmatch_tpu_torch.cli import evaluate as t_evaluate
from fpmatch_tpu_torch.cli import match as t_match
from fpmatch_tpu_torch.cli import train as t_train
from fpmatch_tpu_torch.convert import (flax_tree_to_state_dict,
                                       from_flax_variables)
from fpmatch_tpu_torch.core.config import default_stages
from fpmatch_tpu_torch.kernels.assoc_univ_v3 import plan_univ_v3 as t_plan
from fpmatch_tpu_torch.models import backbone as t_bb
from fpmatch_tpu_torch.models import layers as t_layers
from fpmatch_tpu_torch.models import ngm as t_ngm
from fpmatch_tpu_torch.models.ngm import build_model
from fpmatch_tpu_torch.ops.assoc import assoc_matvec_auto
from fpmatch_tpu_torch.ops.feature_align import feature_align
from fpmatch_tpu_torch.ops.spline import spline_conv
from fpmatch_tpu_torch.train import state as t_state
from fpmatch_tpu_torch.train import step as t_step
from test_torch_ngm import (KEYS, AFAU_KEYS, _mixed_batch,
                            _perm_equal_up_to_ties, _torch_batch)
from test_torch_utils import (build_tiny, damp_afau_mixing, load_into,
                              np_tree, randomize_batch_stats, shared_init,
                              t2n, tiny_jax_config, tiny_widths,
                              to_torch_config)

BF = jnp.bfloat16
OP_BOUND = 2.0 ** -6


def bf16_cfg(cfg):
    """The `--bf16` change of a config (either package's)."""
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"),
        ngm=dataclasses.replace(cfg.ngm, compute_dtype="bfloat16"))


def compile_exact(fn, *args, **static):
    """`jax.jit(fn)` compiled with bf16 rounded after every op (XLA's
    `xla_allow_excess_precision` off), run on `args`."""
    f = jax.jit(functools.partial(fn, **static))
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def f32(t):
    return t2n(t.float())


def tt(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ ops and layers
def test_bf16_ops_and_layers_match_jax(rng):
    """feature_align and spline_conv keep bf16 (both packages blend and
    convolve in the map's / the features' dtype); SplineNet,
    InnerProductAffinity (f32 out) and AssocGNNLayer (bf16 out) with
    `dtype=bf16`, each within 2**-6 of the JAX result's largest value."""
    # feature_align: f32 weights cast to the map's dtype, a bf16 blend
    feat = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    pts = rng.uniform(0, 40, size=(2, 10, 2)).astype(np.float32)
    want = np.asarray(compile_exact(jax.vmap(
        lambda f, p: j_feature_align(f, p, (48, 32))),
        jnp.asarray(feat).astype(BF), pts), np.float32)
    got = feature_align(tt(feat).bfloat16(), tt(pts), (48, 32))
    assert got.dtype == torch.bfloat16
    assert rel(f32(got), want) <= OP_BOUND

    # spline_conv in x's dtype, its parameters cast at use
    G, N, E, C, Co = 2, 10, 30, 16, 12
    x = rng.normal(size=(G, N, C)).astype(np.float32)
    src = rng.integers(0, N, (G, E)).astype(np.int32)
    dst = rng.integers(0, N, (G, E)).astype(np.int32)
    attr = rng.uniform(0, 1, (G, E, 2)).astype(np.float32)
    W = (rng.normal(size=(25, C, Co)) / 4).astype(np.float32)
    R = (rng.normal(size=(C, Co)) / 4).astype(np.float32)
    bias = rng.normal(size=(Co,)).astype(np.float32)
    em = np.arange(E)[None] < np.array([[25], [30]])
    nm = np.arange(N)[None] < np.array([[9], [10]])
    want = np.asarray(compile_exact(jax.vmap(
        lambda x, s, d, a, e, n: j_spline_conv(x, s, d, a, W, R, bias, e, n)),
        jnp.asarray(x).astype(BF), src, dst, attr, em, nm), np.float32)
    got = spline_conv(tt(x).bfloat16(), tt(src), tt(dst), tt(attr), tt(W),
                      tt(R), tt(bias), tt(em), tt(nm))
    assert got.dtype == torch.bfloat16
    assert rel(f32(got), want) <= OP_BOUND

    # SplineNet (two convolutions, the 0.1 residual blend) in bf16
    jsn = j_layers.SplineNet(features=C, num_layers=2)
    v = jax.jit(jsn.init)(jax.random.PRNGKey(1), x[0], src[0], dst[0],
                          attr[0], em[0], nm[0])
    v = jax.tree_util.tree_map(lambda a: a + 0.05, v)      # nonzero biases
    want = np.asarray(compile_exact(jax.vmap(
        lambda *a: jsn.apply(v, *a)), jnp.asarray(x).astype(BF), src, dst,
        attr, em, nm), np.float32)
    tsn = load_into(t_layers.SplineNet(features=C, num_layers=2),
                    v["params"])
    got = tsn(tt(x).bfloat16(), tt(src), tt(dst), tt(attr), tt(em), tt(nm))
    assert got.dtype == torch.bfloat16
    assert rel(f32(got), want) <= OP_BOUND

    # InnerProductAffinity: bf16 operands, an f32 product never rounded
    X = rng.normal(size=(2, 10, 32)).astype(np.float32)
    Y = rng.normal(size=(2, 12, 32)).astype(np.float32)
    w = rng.normal(size=(2, 20)).astype(np.float32)
    jaff = j_layers.InnerProductAffinity(32)
    v = jax.jit(jaff.init)(jax.random.PRNGKey(2), X, Y, w)
    want = compile_exact(jaff.apply, v, jnp.asarray(X).astype(BF),
                         jnp.asarray(Y).astype(BF), w)
    got = load_into(t_layers.InnerProductAffinity(32, 20), v["params"])(
        tt(X).bfloat16(), tt(Y).bfloat16(), tt(w))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel(t2n(got), want) <= OP_BOUND

    # AssocGNNLayer with dtype=bf16 (bucket route: aggregation from bf16
    # features, bf16 Dense layers, the f32 Sinkhorn channel cast back)
    B, n, e = 2, 9, 20
    Xa = rng.normal(size=(B, n, n, 3)).astype(np.float32)
    Kp = rng.normal(size=(B, n, n)).astype(np.float32)
    edges = [rng.integers(0, n, (B, e)).astype(np.int32) for _ in range(4)]
    e_mask = np.arange(e)[None] < np.array([[17], [20]])
    Ke = (rng.normal(size=(B, e, e))
          * (e_mask[:, :, None] & e_mask[:, None, :])).astype(np.float32)
    kp_present = np.ones((B, n, n), np.float32)
    n1 = n2 = np.full(B, n, np.int32)
    jl = j_layers.AssocGNNLayer(out_features=8, sk_channel=1, sk_iter=4,
                                sk_tau=0.5, dtype=BF)
    args = (Xa, Kp, Ke, *edges, kp_present, e_mask, e_mask, n1, n2)
    v = jax.jit(jl.init)(jax.random.PRNGKey(3), *(a[0] for a in args))
    want = compile_exact(jax.vmap(lambda *a: jl.apply(v, *a)), *args)
    tl = load_into(t_layers.AssocGNNLayer(3, out_features=8, sk_channel=1,
                                          sk_iter=4, sk_tau=0.5,
                                          dtype=torch.bfloat16), v["params"])
    got = tl(*(tt(a) for a in args))
    assert got.dtype == torch.bfloat16 and want.dtype == BF
    assert rel(f32(got), want) <= OP_BOUND


def test_bf16_backbone_matches_jax(rng):
    """A narrow ResNet in bf16, both BatchNorm modes: bf16 convolutions, f32
    BatchNorms, so the three outputs are f32; within 2**-6, and the batch
    statistics of train mode agree as in f32 (1e-4)."""
    kw = dict(stem_channels=8, stage_channels=(8, 8, 16, 16),
              blocks_per_stage=1)
    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    jm = j_bb.ResNet18Backbone(dtype=BF, **kw)
    v = randomize_batch_stats(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    tm = load_into(t_bb.ResNet18Backbone(dtype=torch.bfloat16, **kw),
                   v["params"], v["batch_stats"])
    for train in (False, True):
        out = compile_exact(
            lambda v, x: jm.apply(v, x, train, mutable=["batch_stats"]
                                  if train else False),
            v, jnp.asarray(x).astype(BF))
        want, stats = out if train else (out, None)
        got = tm(tt(x).bfloat16(), train)
        for g, w in zip((got[0][0], got[1], got[2]),
                        (want[0][0], want[1], want[2])):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            assert rel(t2n(g), w) <= OP_BOUND
        if train:
            sd = flax_tree_to_state_dict({}, np_tree(stats["batch_stats"]))
            bufs = dict(tm.named_buffers())
            for k, a in sd.items():
                np.testing.assert_allclose(t2n(bufs[k]), t2n(a), rtol=1e-4,
                                           atol=1e-4, err_msg=k)


# --------------------------------------- the association matvec's gradient
@pytest.mark.parametrize("transpose", [False, True])
def test_assoc_matvec_bf16_gradient_matches_jax_vjp(rng, transpose):
    """`ops.assoc.assoc_matvec_auto` on bf16 X (its plain path, what the
    card's kernels are held to) against `jax.vjp` of the JAX op on bf16 X:
    dX (bf16) and dKe within 2**-6 of their range, dKe bf16-representable
    and 0 on masked slots, dKp (f32) within 1e-6. Where JAX sums its bf16
    terms in bf16, the port sums them in f32 and rounds once: each entry of
    dX and dKe lies within one bf16 rounding of the exact sum of the rounded
    terms, and the port is no further from that sum than JAX."""
    B, n, E, C = 2, 12, 30, 5
    X = rng.normal(size=(B, n, n, C)).astype(np.float32)
    Kp = rng.normal(size=(B, n, n)).astype(np.float32)
    m = np.arange(E)[None] < np.array([[26], [30]])
    Ke = (rng.normal(size=(B, E, E)) * (m[:, :, None] & m[:, None, :])
          ).astype(np.float32)
    ed = [rng.integers(0, n, (B, E)).astype(np.int32) for _ in range(4)]
    dY = rng.normal(size=(B, n, n, C)).astype(np.float32)
    Xb = tt(X).bfloat16()
    x = Xb.clone().requires_grad_()
    kp, ke = tt(Kp).requires_grad_(), tt(Ke).requires_grad_()
    y = assoc_matvec_auto(x, kp, ke, *(tt(e) for e in ed),
                          transpose=transpose, e1_mask=tt(m), e2_mask=tt(m))
    assert y.dtype == torch.float32
    y.backward(tt(dY))
    assert x.grad.dtype == torch.bfloat16
    assert torch.equal(ke.grad.bfloat16().float(), ke.grad)
    assert (ke.grad[~(tt(m)[:, :, None] & tt(m)[:, None, :])] == 0).all()

    o1, i1, o2, i2 = ((ed[1], ed[0], ed[3], ed[2]) if transpose
                      else (ed[0], ed[1], ed[2], ed[3]))
    for b in range(B):
        fn = lambda X, Kp, Ke: j_assoc_matvec(
            X, Kp, Ke, *(jnp.asarray(e[b]) for e in ed), transpose=transpose)
        xb = jnp.asarray(Xb[b].float().numpy()).astype(BF)
        _, vjp = jax.vjp(fn, xb, jnp.asarray(Kp[b]), jnp.asarray(Ke[b]))
        jdX, jdKp, jdKe = (np.asarray(a, np.float32) for a in vjp(
            jnp.asarray(dY[b])))
        pdX, pdKp, pdKe = f32(x.grad[b]), t2n(kp.grad[b]), t2n(ke.grad[b])
        mb = m[b][:, None] & m[b][None, :]
        assert rel(pdX, jdX) <= OP_BOUND
        assert rel(pdKe[mb], jdKe[mb]) <= OP_BOUND
        np.testing.assert_allclose(pdKp, jdKp, rtol=1e-6, atol=1e-6)

        # the exact sums (float64) of the terms as both round them
        yb = t2n(tt(dY[b]).bfloat16().double())
        xf = t2n(Xb[b].double())
        keb = t2n(tt(Ke[b]).bfloat16().double())
        prods = t2n(torch.from_numpy(
            yb[o1[b]][:, o2[b]] * xf[i1[b]][:, i2[b]]).bfloat16().double())
        exact_dKe = prods.sum(-1)
        terms = t2n(torch.from_numpy(
            yb[o1[b]][:, o2[b]] * keb[..., None]).bfloat16().double())
        exact_dX = Kp[b][..., None].astype(np.float64) * dY[b]
        np.add.at(exact_dX, (i1[b][:, None], i2[b][None, :]), terms)
        for got, jax_v, ex in ((pdX, jdX, exact_dX),
                               (pdKe[mb], jdKe[mb], exact_dKe[mb])):
            tol = 2.0 ** -8 * np.abs(ex) + 1e-6 * np.abs(ex).max()
            assert (np.abs(got - ex) <= tol).all()
            assert np.abs(got - ex).max() <= np.abs(jax_v - ex).max()


# ------------------------------------------------------------- the model
def _filter(mdl, name):
    return mdl.name in ("vertex_aff", "edge_aff", "gnn_0")


def _j_forward(cfg, v, batch, **kw):
    """JAX forward (exact bf16 rounding) and its Kp, Ke, gnn_0 output."""
    out, inter = compile_exact(
        lambda v, b: JNet(cfg, **kw).apply(
            v, b, train=False, capture_intermediates=_filter,
            mutable=["intermediates"]), v, batch)
    it = inter["intermediates"]
    first = it["gnn_0"]["__call__"][0] if "gnn_0" in it else None
    return out, (it["vertex_aff"]["__call__"][0],
                 0.5 * it["edge_aff"]["__call__"][0], first)


def _j_gnn0_bucket(cfg, v, batch, Kp, Ke):
    """The bucket route's first assoc-GNN layer, as the JAX model calls it
    (its vmapped layer cannot report an intermediate), on JAX's Kp / Ke."""
    N, E = batch.points.shape[2], batch.src.shape[2]
    nn_ = np.asarray(batch.n_nodes)
    ne = np.asarray(batch.n_edges)
    vm = ((np.arange(N)[None, :, None] < nn_[:, 0, None, None])
          & (np.arange(N)[None, None, :] < nn_[:, 1, None, None]))
    em = np.arange(E)[None, None, :] < ne[:, :, None]
    c = cfg.ngm
    layer = j_layers.AssocGNNLayer(
        out_features=c.gnn_feat[0], sk_channel=c.sk_emb,
        sk_iter=c.sk_layer_iter, sk_tau=c.sk_tau,
        dtype=BF if c.compute_dtype == "bfloat16" else jnp.float32)
    args = (Kp[..., None], Kp, Ke, batch.src[:, 0], batch.dst[:, 0],
            batch.src[:, 1], batch.dst[:, 1], vm.astype(np.float32),
            em[:, 0], em[:, 1], nn_[:, 0], nn_[:, 1])
    p = {"params": v["params"]["gnn_0"]}
    return compile_exact(jax.vmap(lambda *a: layer.apply(p, *a)), *args)


class _Taps:
    """Forward hooks on the port's vertex_aff, edge_aff and gnn_0."""

    def __init__(self, net):
        self.out = {}
        for name in ("vertex_aff", "edge_aff", "gnn_0"):
            getattr(net, name).register_forward_hook(
                lambda m, a, o, name=name: self.out.__setitem__(name, o))

    def three(self):
        return (self.out["vertex_aff"], 0.5 * self.out["edge_aff"],
                self.out["gnn_0"])


def _closer_than_f32(port, jax_bf16, jax_f32):
    """On Kp, Ke and the first GNN layer's output: port bf16 nearer JAX
    bf16 than JAX f32 is (a port that silently ran f32 would not be)."""
    for name, p, jb, jf in zip(("Kp", "Ke", "gnn_0"), port, jax_bf16,
                               jax_f32):
        jb = np.asarray(jb, np.float32)
        d_port = float(np.abs(f32(p) - jb).max())
        d_f32 = float(np.abs(np.asarray(jf, np.float32) - jb).max())
        assert d_port < d_f32, (name, d_port, d_f32)


@pytest.fixture(scope="module")
def model_case():
    """The tiny model at sk_tau 0.05: one jitted Flax init with random
    BatchNorm statistics and damped AFA-U mixing, as test_torch_ngm's (the
    parameters do not depend on the bucket sizes, so both routes use it),
    and the bucket batch."""
    jcfg = tiny_jax_config(sk_tau=0.5)
    batch = _mixed_batch(jcfg, seed=3)
    v = damp_afau_mixing(randomize_batch_stats(shared_init(jcfg)))
    return jcfg, batch, v


def _compare_outputs(want, got):
    """test_torch_ngm's bounds: 1e-4, AFA-U's keys 1e-3, perm_mat up to
    ties of the ranking map."""
    _perm_equal_up_to_ties(want, got)
    for k in KEYS:
        if k == "perm_mat":
            continue
        t = 1e-3 if k in AFAU_KEYS else 1e-4
        np.testing.assert_allclose(f32(got[k]), np.asarray(want[k]),
                                   rtol=t, atol=t, err_msg=k)


def test_ngm_bf16_bucket_route_matches_jax(model_case):
    """B = 3 (n1 < n2, n1 > n2, an impostor) in bf16 against the JAX model
    in bf16; every output f32. One converted state_dict drives the port in
    both precisions (parameters stay f32), and its f32 run is the JAX f32
    model's."""
    jcfg, batch, v = model_case
    bcfg = bf16_cfg(jcfg)
    want, (jKp, jKe, _) = _j_forward(bcfg, v, batch)
    want32, (fKp, fKe, _) = _j_forward(jcfg, v, batch)
    sd = from_flax_variables(v, to_torch_config(jcfg))
    net = build_model(to_torch_config(bcfg), device="cpu", state_dict=sd)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    taps = _Taps(net)
    got = net(_torch_batch(batch).to("cpu"))
    assert all(got[k].dtype == torch.float32 for k in KEYS)
    assert taps.out["gnn_0"].dtype == torch.bfloat16
    _compare_outputs(want, got)
    jg0 = _j_gnn0_bucket(bcfg, v, batch, jKp, jKe)
    fg0 = _j_gnn0_bucket(jcfg, v, batch, fKp, fKe)
    _closer_than_f32(taps.three(), (jKp, jKe, jg0), (fKp, fKe, fg0))
    assert rel(f32(taps.out["gnn_0"]), jg0) <= OP_BOUND

    net32 = build_model(to_torch_config(jcfg), device="cpu", state_dict=sd)
    got32 = net32(_torch_batch(batch).to("cpu"))
    for k in ("Kp", "raw_scores", "sinkhorn"):
        np.testing.assert_allclose(t2n(got32[k]), np.asarray(want32[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_ngm_bf16_univ_route_matches_jax(model_case, monkeypatch):
    """B = 1 on the UNIV route in bf16: the JAX plan + Pallas kernel
    (interpret mode) with `compute_dtype` bf16
    (its kernel reads bf16 features and bf16 Ke on the pairs the plan keeps)
    against the port's plan + plain kernel version, reached from
    `compute_dtype` alone (univ_bf16 off). JAX's f32 result of the closer
    check is its bucket route (the same Kp, Ke and first layer: the routes
    differ only in how the aggregation's sum is taken)."""
    jcfg0, _, v = model_case
    jcfg = tiny_jax_config(n_max=16, e_max=96, sk_tau=0.5)
    batch = j_synth(jcfg, 1, n_range=(11, 15), image_hw=(32, 48), seed=7)
    N = jcfg.shapes.n_max
    n2 = int(batch.n_nodes[0, 1])
    e1, e2 = int(batch.n_edges[0, 0]), int(batch.n_edges[0, 1])
    s1, d1 = np.asarray(batch.src[0, 0, :e1]), np.asarray(batch.dst[0, 0, :e1])
    s2, d2 = np.asarray(batch.src[0, 1, :e2]), np.asarray(batch.dst[0, 1, :e2])
    pts2 = np.full((N, 2), 1e9, np.float32)
    pts2[:n2] = np.asarray(batch.points[0, 1, :n2])
    pts2[n2:, 0] += np.arange(N - n2)
    # slot caps keep the interpreted Pallas kernel's nest short
    caps = dict(transpose=True, n1=N, s1_cap=2, s2_cap=2)
    bcfg = bf16_cfg(jcfg)
    want, jax_bf16 = _j_forward(bcfg, v, batch,
                                univ_plan=j_plan(pts2, s1, d1, s2, d2,
                                                 **caps))
    _, (fKp, fKe, _) = _j_forward(jcfg, v, batch)
    jax_f32 = (fKp, fKe, _j_gnn0_bucket(jcfg, v, batch, fKp, fKe))

    net = build_model(to_torch_config(bcfg), device="cpu",
                      state_dict=from_flax_variables(
                          v, to_torch_config(jcfg0)))
    assert not net.univ_bf16
    calls, firsts = [], []
    univ = t_ngm.assoc_matvec_univ_v3
    layer_fwd = t_layers.AssocGNNLayerBatched.forward
    monkeypatch.setattr(t_ngm, "assoc_matvec_univ_v3",
                        lambda X, *a, **k: calls.append(X.dtype)
                        or univ(X, *a, **k))
    monkeypatch.setattr(t_layers.AssocGNNLayerBatched, "forward",
                        lambda *a, **k: firsts.append(layer_fwd(*a, **k))
                        or firsts[-1])
    taps = _Taps(net)
    got = net(_torch_batch(batch).to("cpu"),
              univ_plan=t_plan(pts2, s1, d1, s2, d2, **caps))
    assert calls == [torch.bfloat16] * 3
    _compare_outputs(want, got)
    port = (taps.out["vertex_aff"], 0.5 * taps.out["edge_aff"], firsts[0])
    _closer_than_f32(port, jax_bf16, jax_f32)


# ------------------------------------------------------- one train step
def test_bf16_train_step_stage1_matches_jax(model_case, monkeypatch):
    """Stage 1 (grad clip; backbone, trunk and classifier train) in bf16,
    one step from the same init against `fpmatch_tpu.train.step.
    make_train_step` of the bf16 model, the JAX greedy picks replayed; the
    bf16 backward of the association matvec runs (a bf16 cotangent reaches
    gnn_0). Loss terms within 1e-3 relative (ks_loss and the total 1e-2: the
    AFA-U head, test_torch_train). Gradients (Adam's first moment, 0.1 g, on
    the JAX side), all finite, and where the two frameworks sum alike:

      * every weight matrix of the graph side (f32 sums inside the matmuls
        on both sides): cosine 0.999 per tensor, each entry within 2**-4 of
        the partition-floored scale (the bf16 operands of the backward differ
        by bf16 roundings the embedded Sinkhorns amplify);
      * the backbone: cosine 0.95 over the partition. XLA's CPU convolution
        backward and the bf16 sums below differ from oneDNN's f32
        accumulation by amounts the 10 train-mode BatchNorm backwards
        amplify (two JAX compiles of the same step, with and without excess
        precision, agree only to 0.94 here);
      * biases and BatchNorm parameters: finite. A bias in bf16 is added by
        broadcast, so its gradient is a sum over B N1 N2 cells, which XLA
        takes in bf16 and torch in f32: the two differ by more than the
        gradient itself."""
    import optax.tree_utils as otu

    jcfg, batch, v = model_case
    bcfg = bf16_cfg(jcfg)
    stage_j, stage = j_stages()[0], default_stages()[0]
    state = j_state.create_state(v, stage_j)
    step = j_step.make_train_step(JNet(bcfg), stage_j)
    new, metrics = step.lower(state, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})(state, batch)
    mu = {}
    for _, t in otu.tree_get_all_with_path(new.opt_state, "mu"):
        mu.update({k: s for k, s in t.items()
                   if jax.tree_util.tree_leaves(s)})
    want = {k: t2n(a) / 0.1
            for k, a in flax_tree_to_state_dict(np_tree(mu)).items()}
    perm = np.asarray(compile_exact(
        lambda v, b: JNet(bcfg).apply(v, b, train=True,
                                      mutable=["batch_stats"], bn_cls=False),
        v, batch)[0]["perm_mat"])

    real_greedy = t_ngm.greedy_perm_batch

    def same_ties(rank, ks, n1, n2):
        got = real_greedy(rank, ks, n1, n2)
        assert torch.equal(got.sum((1, 2)), tt(perm).sum((1, 2)))
        return tt(perm)

    monkeypatch.setattr(t_ngm, "greedy_perm_batch", same_ties)
    net = build_model(to_torch_config(bcfg), device="cpu",
                      state_dict=from_flax_variables(v, to_torch_config(jcfg)))
    cotangents = []
    net.gnn_0.register_full_backward_hook(
        lambda m, gi, go: cotangents.append(go[0].dtype))
    tstate = t_state.create_state(net, stage)
    tstate, tm = t_step.make_train_step(net, stage)(
        tstate, _torch_batch(batch).to("cpu"))
    assert cotangents == [torch.bfloat16]
    for k in ("loss", "total_loss", "cls_loss", "ks_loss"):
        tol = 1e-2 if k in ("ks_loss", "total_loss") else 1e-3
        w = float(metrics[k])
        assert abs(float(tm[k]) - w) <= tol * max(abs(w), 1e-6), k

    grads = {n: t2n(p.grad) for n, p in net.named_parameters()
             if p.grad is not None}
    assert set(grads) == set(want)
    part_of = {n: t_state.partition_of(n.split(".")[0]) for n in grads}
    pmax = {}
    for n, g in want.items():
        pmax[part_of[n]] = max(pmax.get(part_of[n], 0.0),
                               float(np.abs(g).max()))
    cos = lambda a, b: float(np.dot(a.ravel(), b.ravel()) / max(
        np.linalg.norm(a) * np.linalg.norm(b), 1e-30))
    n_matrices = 0
    for n, g in grads.items():
        assert np.isfinite(g).all(), n
        if part_of[n] == "backbone" or g.ndim < 2 or \
                n.startswith(("afau.row_block.", "afau.final_row_")):
            continue            # the last: float32-noise-bound (test_torch_train)
        floor = 1e-2 * pmax[part_of[n]]
        scale = max(float(np.abs(want[n]).max()), floor)
        assert float(np.abs(g - want[n]).max()) <= 2.0 ** -4 * scale, n
        if float(np.abs(want[n]).max()) >= floor:
            assert cos(g, want[n]) >= 0.999, (n, cos(g, want[n]))
        n_matrices += 1
    assert n_matrices >= 25
    bb = [n for n in grads if part_of[n] == "backbone"]
    assert cos(np.concatenate([grads[n].ravel() for n in bb]),
               np.concatenate([want[n].ravel() for n in bb])) >= 0.95


# --------------------------------------------------------------- the CLIs
def _f32_checkpoint(cfg, d):
    """An f32 checkpoint, in the port's format, of the tiny-width model of
    the f32 config `cfg` (a CLI's)."""
    assert cfg.ngm.compute_dtype == "float32"
    d.mkdir()
    torch.save(build_model(tiny_widths(cfg), device="cpu",
                           seed=3).state_dict(),
               d / "f32.pt")
    (d / "checkpoint.json").write_text(json.dumps({"latest": "f32"}))
    return str(d)


def _bf16_model(seen):
    cfg, model, sd = seen[-1]
    assert cfg.backbone.dtype == cfg.ngm.compute_dtype == "bfloat16"
    assert model.compute_dtype == model.backbone_dtype == torch.bfloat16
    return sd


@pytest.mark.parametrize("route", ["bucket", "univ"])
def test_cli_match_bf16_on_the_cpu(tmp_path, monkeypatch, capsys, route):
    """`cli.match --bf16 --device cpu` on both routes with keypoint files:
    the flag reaches the config and the model, an f32 checkpoint loads into
    the bf16 model, the JSON is finite and its match list consistent. On the
    UNIV route the aggregation gets bf16 features."""
    from fpmatch_tpu_torch.cli import model_config_from_args

    cv2 = pytest.importorskip("cv2")
    seen = build_tiny(monkeypatch)
    rng = np.random.default_rng(0)
    files = []
    for i in range(2):
        img = rng.integers(0, 256, size=(280, 300), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"f{i}.png"), img)
        pts = rng.uniform([20, 20], [280, 260], size=(14, 2))
        with open(tmp_path / f"f{i}.tsv", "w") as f:
            f.write("x\ty\n" + "".join(f"{x:.2f}\t{y:.2f}\n" for x, y in pts))
        files.append(tmp_path / f"f{i}")
    calls = []
    univ = t_ngm.assoc_matvec_univ_v3
    monkeypatch.setattr(t_ngm, "assoc_matvec_univ_v3",
                        lambda X, *a, **k: calls.append(X.dtype)
                        or univ(X, *a, **k))
    argv = [f"{files[0]}.png", f"{files[1]}.png", "--kpts1",
            f"{files[0]}.tsv", "--kpts2", f"{files[1]}.tsv", "--n-max", "24",
            "--e-max", "160", "--univ", "32", "--device", "cpu",
            "--univ-kernel" if route == "univ" else "--no-univ-kernel"]
    ckpt = _f32_checkpoint(model_config_from_args(
        t_match.build_parser().parse_args(argv)), tmp_path / "ckpt")
    argv += ["--checkpoint-dir", ckpt, "--bf16"]
    capsys.readouterr()
    assert t_match.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _bf16_model(seen) is not None and out["checkpoint"] == "f32"
    assert calls == ([torch.bfloat16] * 3 if route == "univ" else [])
    assert all(np.isfinite(out[k]) for k in ("score", "cls_prob", "k_prob"))
    assert out["n_matched"] == len(out["matches"])


def test_cli_evaluate_bf16_on_the_cpu(tmp_path, monkeypatch):
    """`cli.evaluate --bf16 --device cpu` over 4 pairs of the fixture split
    from an f32 checkpoint: the bf16 model scores every pair, finite."""
    import csv

    from fpmatch_tpu_torch.cli import model_config_from_args
    from test_torch_evaluate import CLI_ARGS

    seen = build_tiny(monkeypatch)
    ckpt = _f32_checkpoint(model_config_from_args(
        t_evaluate.build_parser().parse_args(CLI_ARGS)), tmp_path / "ckpt")
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    report = t_evaluate.main(CLI_ARGS + [
        "--output-dir", str(out), "--batch-size", "2", "--limit", "4",
        "--num-viz", "0", "--device", "cpu", "--checkpoint-dir", ckpt,
        "--bf16"])
    assert _bf16_model(seen) is not None
    rows = list(csv.reader(open(out / "scores.csv")))
    assert len(rows) == 1 + 4
    assert all(np.isfinite(float(x)) for r in rows[1:] for x in r[3:])
    assert np.isfinite(report["eer"])


def test_cli_train_bf16_on_the_cpu(tmp_path, monkeypatch):
    """`cli.train --bf16 --device cpu` on a small generated split,
    warm-started from an f32 checkpoint (every tensor restored): stage 1
    (the trunk's bf16 backward) and stage 2, finite losses, f32 parameters,
    and checkpoints that load into an f32 model of the same widths."""
    from fpmatch_tpu_torch.core.config import Config, ShapeConfig
    from fpmatch_tpu_torch.data.generator import generate_synthetic_dataset
    from fpmatch_tpu_torch.train import checkpoints as t_ckpt

    seen = build_tiny(monkeypatch)
    restored = []
    warm = t_ckpt.warm_start

    def counted(sd, r):
        out, kept = warm(sd, r)
        restored.append((len(sd), kept))
        return out, kept

    monkeypatch.setattr(t_ckpt, "warm_start", counted)
    root = str(tmp_path / "Synthetic")
    generate_synthetic_dataset(root, fingers_per_split=(3, 2, 2), n_pores=30,
                               seed=0, size=(200, 180))
    f32 = _f32_checkpoint(Config(shapes=ShapeConfig(n_max=32, e_max=192)),
                          tmp_path / "f32")
    hist = []
    report = t_train.main(
        ["--data-root", root, "--stages", "1,2", "--epochs", "1",
         "--passes", "1", "--length", "4", "--test-length", "4",
         "--batch-size", "2", "--n-max", "32", "--e-max", "192",
         "--thread-workers", "--device", "cpu", "--bf16",
         "--init-from", f"{f32}:f32",
         "--checkpoint-dir", str(tmp_path / "ckpt")],
        on_stage_end=lambda st, h: hist.append(h[-1]))
    cfg, model, _ = seen[0]
    _bf16_model(seen[:1])
    assert restored and restored[0][0] == restored[0][1]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert len(hist) == 2 and all(np.isfinite(h["train_total_loss"])
                                  for h in hist)
    assert np.isfinite(report["total_loss"])
    sd = t_ckpt.restore_params(tmp_path / "ckpt", "stage1_last")
    f32_cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"),
        ngm=dataclasses.replace(cfg.ngm, compute_dtype="float32"))
    build_model(f32_cfg, device="cpu", state_dict=sd)
