"""The port's training path on the CPU against the JAX package's: one train
step per stage for stages 1 (grad clip), 2 (k head only) and 6 (classifier
only) against `fpmatch_tpu.train.step.make_train_step` on the same Flax init
and batch, the train-mode BatchNorms, the learning-rate scheduler, the
augmentation, the state / checkpoint / loop pieces and `cli.train --smoke`.

One JAX compile per stage, shared through module-scoped fixtures (the init is
jitted: Flax's eager init of the whole model takes ~45 s on the CPU). As in
test_torch_ngm, the models run at sk_tau = 0.05 with the AFA-U score-mixing
weights damped (test_torch_utils.damp_afau_mixing), so that the comparison is
about the arithmetic and not about float32 noise amplified 100x per Sinkhorn
stage.

Tolerances of the train step, and why:
  * loss terms: 1e-4 relative (the forward agrees to 1e-4, test_torch_ngm),
    ks_loss and the total that holds it 1e-3 (the AFA-U head's instance
    norms magnify 3e-7 input differences ~300x on a near-uniform Sinkhorn
    map, see test_torch_ngm);
  * gradients, per tensor, relative to the tensor's largest value: 1e-3
    (the backward runs the forward's noise amplifiers backwards: embedded
    Sinkhorns at tau 0.05, instance norms); a tensor whose gradient is
    below 1 % of its partition's largest is held at that 1 % level. The
    gradients the optimizer saw are Adam's first moment, 0.1 g, which is
    what is compared on the JAX side (its train step returns no gradients);
    the row half of the AFA-U head is float32-noise-bound at this init
    (NOISE_BOUND below) and held to finiteness only;
  * the greedy discretization ranks a near-uniform map, so ties at the
    1e-6 level decide a pick: the port's greedy must keep as many matches
    as the JAX one, and the JAX picks are then used on both sides (the
    ranking itself is tested bit for bit in test_torch_ops);
  * updated parameters where |g| > 1e-3 max|g| of their tensor: Adam's
    first step moves every such weight by ~lr sign(g), so they agree to
    1e-3 lr; below that a sign may flip on noise;
  * BatchNorm running statistics 1e-5; frozen parameters and statistics
    bit for bit.
"""
import dataclasses
import functools
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from fpmatch_tpu.core.config import default_stages as j_stages
from fpmatch_tpu.data import augmentation as j_aug
from fpmatch_tpu.data import benchmark as j_benchmark
from fpmatch_tpu.data import pipeline as j_pipeline
from fpmatch_tpu.models import backbone as j_backbone
from fpmatch_tpu.models import layers as j_layers
from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu.train import scheduler as j_scheduler
from fpmatch_tpu.train import state as j_state
from fpmatch_tpu.train import step as j_step
from fpmatch_tpu_torch.cli import train as t_cli_train
from fpmatch_tpu_torch.convert import (flax_tree_to_state_dict,
                                       from_flax_variables)
from fpmatch_tpu_torch.core.config import Config, ShapeConfig, default_stages
from fpmatch_tpu_torch.data import augmentation as t_aug
from fpmatch_tpu_torch.data import benchmark as t_benchmark
from fpmatch_tpu_torch.data import pipeline as t_pipeline
from fpmatch_tpu_torch.models import backbone as t_backbone
from fpmatch_tpu_torch.models import layers as t_layers
from fpmatch_tpu_torch.models import ngm as t_ngm
from fpmatch_tpu_torch.models.ngm import build_model
from fpmatch_tpu_torch.train import checkpoints as t_ckpt
from fpmatch_tpu_torch.train import loop as t_loop
from fpmatch_tpu_torch.train import scheduler as t_scheduler
from fpmatch_tpu_torch.train import state as t_state
from fpmatch_tpu_torch.train import step as t_step
from fpmatch_tpu_torch.utils.logging import MetricsLogger
import test_torch_hyperedge
from test_torch_ngm import _mixed_batch, _torch_batch
from test_torch_utils import (build_tiny, damp_afau_mixing, np_tree,
                              randomize_batch_stats, shared_init, t2n,
                              tiny_jax_config, tiny_widths, to_torch_config)

FIXTURE = Path(__file__).parent / "fixtures" / "PolyU-mini" / "DBII"
GRAD_TOL = 1e-3
# the row half of the AFA-U head: its input rows (zeros + attention over a
# near-uniform Sinkhorn map) are nearly identical, so its instance norms
# divide ~1e-6 differences by sqrt(1e-5) and float32 rounding decides these
# gradients in both packages (relative differences of 0.1 - 2 at this init);
# they are held to finiteness and to the optimizer step they drove
NOISE_BOUND = ("afau.row_block.", "afau.final_row_")
LOSS_TOL = {"loss": 1e-4, "total_loss": 1e-3, "cls_loss": 1e-4,
            "ks_loss": 1e-3}


@pytest.fixture(scope="module")
def case():
    """The JAX config, a B = 3 batch mixing n1 < n2, n1 > n2 and an impostor
    (test_torch_ngm._mixed_batch), and a Flax init with random BatchNorm
    statistics and damped AFA-U mixing weights."""
    jcfg = tiny_jax_config(sk_tau=0.05)
    batch = _mixed_batch(jcfg, seed=3)
    v = damp_afau_mixing(randomize_batch_stats(shared_init(jcfg)))
    return jcfg, batch, v


@pytest.fixture(scope="module")
def jax_steps(case):
    """{stage number: (new params, new batch_stats, mu, nu, metrics)} of one
    JAX train step from the shared init, mu / nu as state_dict-named numpy
    arrays of the trained parameters."""
    return jax_train_steps(*case, (1, 2, 6))


def jax_train_steps(jcfg, batch, v, nums):
    """{stage number: (new params, new batch_stats, mu, nu, metrics, greedy
    picks)} of one JAX train step per stage in `nums` from `v`."""
    out, perms = {}, {}
    for num in nums:
        stage = j_stages()[num - 1]
        state = j_state.create_state(v, stage)
        new, metrics = j_step.make_train_step(JNet(jcfg), stage)(state,
                                                                  batch)
        moments = {}
        for key in ("mu", "nu"):
            tree = {}
            for _, t in j_opt_leaves(new.opt_state, key):
                tree.update({name: sub for name, sub in t.items()
                             if jax.tree_util.tree_leaves(sub)})
            moments[key] = {k: t2n(a) for k, a in flax_tree_to_state_dict(
                np_tree(tree)).items()}
        # the greedy picks depend on the backbone's BatchNorm mode only
        bn_main = stage.train_main if jcfg.train.bn_follows_trainability \
            else True
        if bn_main not in perms:
            fwd = jax.jit(functools.partial(
                JNet(jcfg).apply, train=True, mutable=["batch_stats"],
                bn_main=bn_main, bn_cls=False))
            perms[bn_main] = np.asarray(fwd(v, batch)[0]["perm_mat"])
        perm = perms[bn_main]
        out[num] = (np_tree(new.params), np_tree(new.batch_stats),
                    moments["mu"], moments["nu"],
                    {k: float(a) for k, a in metrics.items()}, perm)
    return out


def j_opt_leaves(opt_state, key):
    import optax.tree_utils as otu

    return otu.tree_get_all_with_path(opt_state, key)


def _net(case):
    jcfg, _, v = case
    tcfg = to_torch_config(jcfg)
    return build_model(tcfg, device="cpu",
                       state_dict=from_flax_variables(v, tcfg))


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("num", [1, 2, 6])
def test_train_step_matches_jax(case, jax_steps, num, monkeypatch):
    check_train_step(case, jax_steps[num], num, monkeypatch)


def check_train_step(case, jax_step, num, monkeypatch, param_ulps=0):
    """One port train step of stage `num` from `case`'s init against the
    JAX step `jax_step` (an entry of `jax_train_steps`), to the bounds of
    this file's docstring; `param_ulps` adds that many float32 ulps of each
    updated parameter to its bound (an update of ~lr rounds to the ulp of
    a weight of magnitude 2 or more, 2.4e-7, beyond the 1e-3 lr + 1e-7)."""
    jcfg, batch, v = case
    stage = default_stages()[num - 1]
    j_params, j_stats, mu, nu, j_metrics, j_perm = jax_step
    real_greedy = t_ngm.greedy_perm_batch

    def same_ties(rank, ks, n1, n2):
        got = real_greedy(rank, ks, n1, n2)
        assert torch.equal(got.sum((1, 2)), torch.from_numpy(j_perm).sum(
            (1, 2)))
        return torch.from_numpy(j_perm)

    monkeypatch.setattr(t_ngm, "greedy_perm_batch", same_ties)
    net = _net(case)
    before = {k: t.clone() for k, t in net.state_dict().items()}
    state = t_state.create_state(net, stage)
    step = t_step.make_train_step(net, stage)
    state, metrics = step(state, _torch_batch(batch).to("cpu"))
    assert state.step == 1

    for k, tol in LOSS_TOL.items():
        assert abs(float(metrics[k]) - j_metrics[k]) <= tol * max(
            abs(j_metrics[k]), 1e-6), (k, float(metrics[k]), j_metrics[k])

    live = t_state.live_partitions(stage)
    want_sd = {k: t2n(a) for k, a in flax_tree_to_state_dict(
        j_params, j_stats).items()}
    params = dict(net.named_parameters())
    part_of = {n: t_state.partition_of(n.split(".")[0]) for n in params}
    part_max = {}
    for name, m in mu.items():
        part_max[part_of[name]] = max(part_max.get(part_of[name], 0.0),
                                      float(np.abs(m).max()))
    n_live = 0
    for name, p in params.items():
        part = part_of[name]
        if not live[part]:
            assert p.grad is None and not p.requires_grad, name
            assert torch.equal(p.detach(), before[name]), name
            continue
        n_live += 1
        g = t2n(p.grad)
        st = state.optimizer.state[p]
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(t2n(st["exp_avg"]), 0.1 * g, rtol=1e-6,
                                   atol=0, err_msg=name)
        if name.startswith(NOISE_BOUND):
            continue
        # a gradient below 1 % of its partition's largest (e.g. a bias that
        # feeds a normalization or a Sinkhorn, zero in exact arithmetic) is
        # held at that 1 % level: its own digits are rounding noise
        top = float(np.abs(mu[name]).max())
        floor = 1e-2 * part_max[part]
        scale = max(top, floor)
        for got, want in ((g, mu[name] / 0.1),
                          (t2n(st["exp_avg"]), mu[name])):
            err = float(np.abs(got - want).max())
            assert err <= GRAD_TOL * scale * float(np.abs(want).max()) \
                / max(top, 1e-30), (name, err)
        if top < floor:
            continue
        assert _rel(t2n(st["exp_avg_sq"]), nu[name]) <= 2 * GRAD_TOL, name
        big = np.abs(mu[name]) > 1e-3 * top
        lr = {"backbone": stage.backbone_lr, "main": stage.lr,
              "k": stage.k_lr, "cls": stage.cls_lr}[part]
        diff = np.abs(t2n(p) - want_sd[name])[big]
        ulps = param_ulps * np.spacing(np.abs(want_sd[name]))[big]
        assert (diff <= 1e-3 * lr + 1e-7 + ulps).all(), name
    assert n_live == sum(len(ps) for part, ps in
                         t_state.partition_params(net).items() if live[part])

    for name, buf in net.named_buffers():
        if not name.endswith(("running_mean", "running_var")):
            continue
        trains_bn = (stage.train_main if name.startswith("backbone")
                     else stage.train_cls)
        if trains_bn:
            np.testing.assert_allclose(t2n(buf), want_sd[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            assert not torch.equal(buf, before[name]), name
        else:
            assert torch.equal(buf, before[name]), name


@pytest.fixture(scope="module")
def options_case():
    """`case` with the model's two options: the same batch with triangles
    (test_torch_hyperedge._with_triangles), a jitted Flax init of the tiny
    model with `hyperedge` and `cls_k_features`."""
    jcfg = tiny_jax_config(sk_tau=0.05, hyperedge=True, cls_k_features=True)
    batch = test_torch_hyperedge._with_triangles(_mixed_batch(jcfg, seed=3),
                                                 jcfg.shapes.t_max)
    return jcfg, batch, damp_afau_mixing(randomize_batch_stats(
        shared_init(jcfg)))


def test_train_step_with_hyperedge_and_cls_k_matches_jax(options_case,
                                                         monkeypatch):
    """Stage 1 (grad clip; backbone, trunk, k head and classifier train):
    the triangle affinity, every layer's `lin_t` and the widened `fc` get
    gradients, and every tensor is held as in test_torch_train; an updated
    parameter to its bound plus one float32 ulp of itself (this init has
    weights of magnitude 2 and more in `gnn_0.self0`, whose fan-in is 1: an
    update of lr = 1e-4 rounds to their 2.4e-7 ulp on either side)."""
    jres = jax_train_steps(*options_case, (1,))[1]
    assert "tri_aff.A.weight" in jres[2]
    assert "gnn_2.lin_t.weight" in jres[2]
    check_train_step(options_case, jres, 1, monkeypatch, param_ulps=1)


def test_stage_one_clips_and_stage_two_skips_the_trunk_backward(case):
    """Stage 1 clips the global norm as optax does (g * max / ||g|| above
    the limit, without torch's 1e-6); stage 2 computes no gradient of the
    backbone / association GNN at all (frozen parameters need none)."""
    net = _net(case)
    _, batch, _ = case
    tb = _torch_batch(batch).to("cpu")
    stage1 = default_stages()[0]
    state = t_state.create_state(net, stage1)
    total, _ = t_step.loss_and_metrics(net, tb, stage1, train=True)
    total.backward()
    grads = [p.grad.clone() for g in state.optimizer.param_groups
             for p in g["params"]]
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads])))
    assert norm > stage1.grad_clip        # the clip is active on this batch
    got = t_state.clip_by_global_norm_(
        [p for g in state.optimizer.param_groups for p in g["params"]],
        stage1.grad_clip)
    assert abs(float(got) - norm) <= 1e-5 * norm
    for p, g in zip((p for g in state.optimizer.param_groups
                     for p in g["params"]), grads):
        assert torch.allclose(p.grad, g / norm * stage1.grad_clip,
                              rtol=1e-6, atol=0)

    stage2 = default_stages()[1]
    state = t_state.create_state(net, stage2)
    assert [g["partition"] for g in state.optimizer.param_groups] == ["k"]
    total, (_, out) = t_step.loss_and_metrics(net, tb, stage2, train=True)
    assert not out["Kp"].requires_grad and not out["sinkhorn"].requires_grad
    total.backward()
    for name, p in net.named_parameters():
        assert (p.grad is not None) == name.startswith("afau"), name


def test_partitions_learning_rates_and_optimizer_numbers(case):
    net = _net(case)
    for name, _ in net.named_children():
        assert t_state.partition_of(name) == j_state.partition_of(name)
    stage = default_stages()[2]
    opt = t_state.make_optimizer(net, stage)
    assert t_state.get_learning_rates(opt) == {
        "backbone": stage.backbone_lr, "main": stage.lr, "k": stage.k_lr,
        "cls": stage.cls_lr}
    t_state.set_learning_rates(opt, {"main": 0.5, "nope": 1.0})
    assert t_state.get_learning_rates(opt)["main"] == 0.5
    d = opt.defaults
    assert (d["betas"], d["eps"], d["weight_decay"]) == ((0.9, 0.999), 1e-8,
                                                         1e-2)
    with pytest.raises(ValueError, match="trains no partition"):
        t_state.make_optimizer(net, dataclasses.replace(
            stage, train_main=False, train_k=False, train_cls=False))


def test_clip_matches_optax(rng):
    import optax

    grads = [rng.normal(size=s).astype(np.float32) * 3 for s in
             ((4, 5), (7,), (2, 3, 2))]
    for max_norm in (0.5, 100.0):
        want = optax.clip_by_global_norm(max_norm).update(
            [jax.numpy.asarray(g) for g in grads], None)[0]
        ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(ps, grads):
            p.grad = torch.from_numpy(g.copy())
        t_state.clip_by_global_norm_(ps, max_norm)
        for p, w in zip(ps, want):
            np.testing.assert_allclose(t2n(p.grad), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- BatchNorm

def test_masked_batchnorm_train_matches_flax(rng):
    x = rng.normal(size=(3, 6, 5, 4)).astype(np.float32) * 2 + 1
    mask = np.zeros((3, 6, 5, 1), np.float32)
    mask[0, :4, :3] = 1
    mask[1, :6, :5] = 1
    mask[2, :1, :2] = 1
    m = j_layers.MaskedBatchNorm()
    v = m.init(jax.random.PRNGKey(0), x, mask, train=False)
    v = randomize_batch_stats(
        {"params": {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                    "bias": rng.normal(size=4).astype(np.float32)},
         "batch_stats": v["batch_stats"]})
    want, mut = m.apply(v, x, mask, train=True, mutable=["batch_stats"])
    bn = t_layers.MaskedBatchNorm(4)
    bn.load_state_dict(flax_tree_to_state_dict(v["params"],
                                               v["batch_stats"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    mt = torch.from_numpy(mask).permute(0, 3, 1, 2)
    got = bn(xt, mt, train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    stats = mut["batch_stats"]
    np.testing.assert_allclose(t2n(bn.running_mean), stats["mean"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t2n(bn.running_var), stats["var"], rtol=1e-6,
                               atol=1e-6)


def test_backbone_batchnorm_train_matches_flax(rng):
    """Biased batch variance in the running update (nn.BatchNorm2d would
    fold in the unbiased one), momentum 0.9, on a micro ResNet."""
    kw = dict(stem_channels=8, stage_channels=(8, 8, 16, 16),
              blocks_per_stage=1)
    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    m = j_backbone.ResNet18Backbone(**kw)
    v = randomize_batch_stats(jax.jit(m.init)(jax.random.PRNGKey(1), x))
    want, mut = jax.jit(functools.partial(m.apply, mutable=["batch_stats"]),
                        static_argnums=2)(v, x, True)
    net = t_backbone.ResNet18Backbone(**kw)
    sd = flax_tree_to_state_dict(v["params"], v["batch_stats"])
    for k, t in net.state_dict().items():
        sd.setdefault(k, t)
    net.load_state_dict(sd)
    got = net(torch.from_numpy(x), train=True)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    stats = flax_tree_to_state_dict({}, mut["batch_stats"])
    for k, w in stats.items():
        np.testing.assert_allclose(t2n(net.state_dict()[k]), t2n(w),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    after = {k: t.clone() for k, t in net.state_dict().items()}
    net(torch.from_numpy(x), train=False)    # eval reads, never writes
    assert all(torch.equal(t, after[k]) for k, t in net.state_dict().items())


# ------------------------------------------------------------- scheduler

def test_warmup_plateau_matches_jax():
    losses = [5.0, 4.0, 4.5, 4.6, 3.0, 3.5, 3.6, 3.7, 3.8, 3.9, 2.0, 2.0,
              2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]
    kw = dict(base_lrs={"main": 1e-4, "backbone": 1e-5, "k": 1e-3},
              warmup_epochs=2, factor=0.5, patience=1)
    js, ts = j_scheduler.WarmupPlateau(**kw), t_scheduler.WarmupPlateau(**kw)
    for vl in losses:
        assert ts.step(vl) == js.step(vl)
        assert (ts.reduced, ts.scale, ts.bad_epochs, ts.best) == \
            (js.reduced, js.scale, js.bad_epochs, js.best)
    assert js.scale < 1.0                   # the schedule did drop


# ---------------------------------------------------------- augmentation

@pytest.fixture(scope="module")
def fixture_image(tmp_path_factory):
    entry = next(iter(j_benchmark.make_benchmark(
        "PolyUDBII", "train", root=str(FIXTURE), task="classify",
        output_dir=str(tmp_path_factory.mktemp("index"))
    ).data_dict.values()))
    img = j_pipeline._load_image(entry["path"])
    return img, j_pipeline._annos_of(entry["kpts"])


@pytest.mark.parametrize("name", list(j_aug.TRANSFORMS))
def test_every_transform_is_bit_identical_to_jax(fixture_image, name):
    """Same numpy seed, same cv2 (this machine's): the same pixels and
    keypoints. The card's machine has another cv2; pixels are compared
    only here."""
    img, annos = fixture_image
    assert list(t_aug.TRANSFORMS) == list(j_aug.TRANSFORMS)
    for seed in (0, 1):
        wi, wa = j_aug.apply_single_transform(img, annos, name,
                                              np.random.default_rng(seed))
        gi, ga = t_aug.apply_single_transform(img, annos, name,
                                              np.random.default_rng(seed))
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
        assert ga == wa


def test_augment_pair_functions_are_bit_identical_to_jax(fixture_image):
    img, annos = fixture_image
    for fn, args in (("augment_image", (img, annos)),
                     ("augment_image_pair", (img, annos)),
                     ("augment_two_images", (img, annos, img[::-1].copy(),
                                             annos))):
        want = getattr(j_aug, fn)(*args, np.random.default_rng(7))
        got = getattr(t_aug, fn)(*args, np.random.default_rng(7))
        for w, g in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            assert np.array_equal(np.asarray(w), np.asarray(g)), fn


def test_train_split_pair_samples_are_bit_identical_to_jax(tmp_path):
    """A train PairDataset augments by default, seeded per (seed, epoch,
    index) as the JAX package's: genuine and impostor samples of two epochs
    equal the JAX package's field for field."""
    jcfg = tiny_jax_config(n_max=16, e_max=96, univ=16)
    tcfg = to_torch_config(jcfg)
    kw = dict(root=str(FIXTURE), task="classify")
    jpd = j_pipeline.PairDataset(j_benchmark.make_benchmark(
        "PolyUDBII", "train", output_dir=str(tmp_path / "j"), **kw), jcfg)
    tpd = t_pipeline.PairDataset(t_benchmark.make_benchmark(
        "PolyUDBII", "train", output_dir=str(tmp_path / "t"), **kw), tcfg)
    assert jpd.augment and tpd.augment
    labels = set()
    for idx in (0, len(tpd) - 1):
        for epoch in (0, 3):
            want, got = jpd.get(idx, epoch), tpd.get(idx, epoch)
            labels.add(got.label)
            for f in dataclasses.fields(want):
                a, b = getattr(want, f.name), getattr(got, f.name)
                for x, y in zip(jax.tree_util.tree_leaves(a),
                                jax.tree_util.tree_leaves(b)):
                    assert np.array_equal(np.asarray(x), np.asarray(y)), \
                        f.name
    assert labels == {0.0, 1.0}
    assert not np.array_equal(tpd.get(0, 0).images[0],
                              tpd.get(0, 1).images[0])


# ------------------------------------------- checkpoints, loop, logging, CLI

def test_checkpoints_round_trip_and_warm_start(case, tmp_path):
    net = _net(case)
    state = t_state.create_state(net, default_stages()[0])
    _, batch, _ = case
    state, _ = t_step.make_train_step(net, default_stages()[0])(
        state, _torch_batch(batch).to("cpu"))
    t_ckpt.save_checkpoint(tmp_path, "stage1_last", state,
                           extra={"stage": "stage1"})
    assert t_ckpt.read_meta(tmp_path) == {"latest": "stage1_last",
                                          "stage": "stage1"}
    other = t_state.create_state(_net(case), default_stages()[0])
    t_ckpt.restore_state(tmp_path, "stage1_last", other)
    assert other.step == 1
    for (k, a), b in zip(net.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k
    sd = t_ckpt.restore_params(tmp_path, "stage1_last")
    sd["spline.conv0_root"] = torch.zeros(3, 3)    # a shape that changed
    new, kept = t_ckpt.warm_start(other.model.state_dict(), sd)
    assert kept == len(sd) - 1
    assert torch.equal(new["spline.conv0_root"],
                       other.model.state_dict()["spline.conv0_root"])


def test_train_stage_reloads_best_on_lr_drop_and_stops_early(case, tmp_path,
                                                              monkeypatch):
    """Validation loss that never improves after epoch 0: the plateau
    scheduler drops the rate (patience 0) and the loop reloads the best
    state; early stop after two bad epochs; the stage ends on the best
    weights; best / last / numbered checkpoints are written."""
    net = _net(case)
    _, batch, _ = case
    tb = _torch_batch(batch).to("cpu")
    stage = dataclasses.replace(default_stages()[5], num_epochs=6,
                                warmup_epochs=0, patience=0)
    state = t_state.create_state(net, stage)
    first = {k: t.clone() for k, t in net.state_dict().items()}
    val = [0]

    def val_loader():
        val[0] += 1
        return iter([tb])

    class Val:
        def __iter__(self):
            return val_loader()

    real_eval = t_loop.make_eval_step

    def eval_step_factory(model, st):
        inner = real_eval(model, st)

        def fn(b):
            m, out = inner(b)
            m = dict(m, total_loss=torch.tensor(1.0 if val[0] == 1 else 2.0))
            return m, out
        return fn

    monkeypatch.setattr(t_loop, "make_eval_step", eval_step_factory)
    lines = []
    state, hist = t_loop.train_stage(
        net, state, stage, [tb], Val(), checkpoint_dir=str(tmp_path),
        passes_per_epoch=2, early_stop_patience=2, log_fn=lines.append,
        numbered_checkpoints=True)
    assert len(hist) == 3 and "early stop at epoch 2" in lines[-1]
    assert all("train_step_ms" in r and r["train_pairs_per_s"] > 0
               for r in hist)
    best = t_ckpt.restore_params(tmp_path, "stage6_best")
    for k, t in net.state_dict().items():
        assert torch.equal(t, best[k]), k
    assert any(not torch.equal(t, first[k]) for k, t in best.items())
    names = {p.stem for p in tmp_path.glob("*.pt")}
    assert {"stage6_best", "stage6_last", "stage6_epoch0002"} <= names


def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path), use_tensorboard=False)
    log.log_scalars(3, {"a": 1.5, "b": 2}, prefix="stage1/")
    log.close()
    row = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert row["step"] == 3 and row["stage1/a"] == 1.5 and row["stage1/b"] == 2


def test_cli_train_smoke_on_the_cpu(tmp_path, monkeypatch):
    """`cli.train --smoke --device cpu --thread-workers` end to end: the
    generated split, stages 1 and 6, a finite final report, checkpoints
    that load back into a model of the smoke's shapes. The model is built
    at tiny widths (`test_torch_utils.build_tiny`); `chip_smoke.py` runs
    `--smoke` at full width on the card."""
    built = build_tiny(monkeypatch)
    seen = []
    t0 = time.time()
    report = t_cli_train.main(
        ["--smoke", "--device", "cpu", "--thread-workers",
         "--checkpoint-dir", str(tmp_path / "ckpt"),
         "--log-dir", str(tmp_path / "log")],
        on_stage_end=lambda st, hist: seen.append((st.name, hist)))
    assert [s for s, _ in seen] == ["stage1", "stage6"]
    assert all(np.isfinite(h[0]["train_total_loss"]) for _, h in seen)
    assert np.isfinite(report["total_loss"]) and report["n_pairs"] > 0
    meta = t_ckpt.read_meta(tmp_path / "ckpt")
    assert meta["latest"] == "stage6_last" and meta["stage"] == "stage6"
    sd = t_ckpt.restore_params(tmp_path / "ckpt", "stage6_best")
    smoke = ShapeConfig(n_max=32, e_max=192, t_max=96, univ_size=64)
    assert built[0][0].shapes == smoke
    build_model(tiny_widths(Config(shapes=smoke)), device="cpu",
                state_dict=sd)
    rows = (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 2
    assert time.time() - t0 < 300


def test_cli_train_smoke_with_hyperedge_and_cls_k_on_the_cpu(tmp_path,
                                                             monkeypatch):
    """`cli.train --smoke --hyperedge --cls-k-features` at tiny widths: the
    model carries both options, the training batches their triangles (at
    most t_max 96 each), stages 1 and 6 give finite losses, the checkpoint
    loads back into a model of the same options."""
    built = build_tiny(monkeypatch)
    tris, seen = [], []
    real_fwd = t_ngm.NGMNet.forward
    monkeypatch.setattr(t_ngm.NGMNet, "forward",
                        lambda self, b, *a, **k: tris.append(b.tri.shape)
                        or real_fwd(self, b, *a, **k))
    report = t_cli_train.main(
        ["--smoke", "--device", "cpu", "--thread-workers", "--hyperedge",
         "--cls-k-features", "--checkpoint-dir", str(tmp_path / "ckpt")],
        on_stage_end=lambda st, hist: seen.append((st.name, hist)))
    cfg, model, _ = built[0]
    assert cfg.ngm.hyperedge and cfg.ngm.cls_k_features
    assert hasattr(model, "tri_aff")
    assert tris and all(t[2:] == (96, 3) for t in tris)
    assert [s for s, _ in seen] == ["stage1", "stage6"]
    assert all(np.isfinite(h[0]["train_total_loss"]) for _, h in seen)
    assert np.isfinite(report["total_loss"])
    sd = t_ckpt.restore_params(tmp_path / "ckpt", "stage6_last")
    build_model(cfg, device="cpu", state_dict=sd)


def test_cli_train_options_that_wait_raise(tmp_path):
    """Every flag of the JAX CLI is taken; what is left are its refusals of
    a mesh (test_torch_cli_mesh runs the meshes): a batch size not
    divisible by the data axis, --n-max not divisible by the edge axis, and
    on `cuda` more ranks than visible cards (which, without a GPU, is any
    mesh); `cuda` without a GPU is an error."""
    for flags, msg in (
            (["--mesh", "2x1", "--batch-size", "3", "--device", "cpu"],
             "batch size 3 not divisible by data axis 2"),
            (["--mesh", "1x3", "--n-max", "64", "--device", "cpu"],
             "--n-max 64 not divisible by edge axis 3"),
            (["--mesh", "1x2"] if not torch.cuda.is_available() else
             ["--mesh", f"{torch.cuda.device_count() + 1}x1"],
             "needs .* devices, only .* visible")):
        with pytest.raises(SystemExit, match=msg):
            t_cli_train.main(flags + ["--checkpoint-dir", str(tmp_path)])
    args = t_cli_train.build_parser().parse_args([])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            t_cli_train.main(["--checkpoint-dir", str(tmp_path)])


def test_cli_train_has_every_flag_of_the_jax_cli():
    """Same flags and defaults as the JAX package's parser, plus --device
    (read from its source: building it there needs no JAX)."""
    import re

    src = (Path(__file__).resolve().parents[1] / "fpmatch_tpu" / "cli" /
           "train.py").read_text()
    want = set(re.findall(r'add_argument\("(--[a-z0-9-]+)"', src))
    got = {a for act in t_cli_train.build_parser()._actions
           for a in act.option_strings if a.startswith("--")}
    assert got - {"--help"} == want | {"--device"}

