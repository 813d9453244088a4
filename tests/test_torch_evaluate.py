"""The batched-evaluate slice of the port on the CPU against the JAX package:
verification metrics, the permutation loss, the dataset index / pair
protocols / pair construction on the committed PolyU-mini files, the
synthetic dataset generator, the loader (one worker, threads, spawned
processes), the eval step with weights carried across by
`convert.from_flax_variables`, the checkpoint files and the `cli.evaluate`
entry point.

Limits: the numpy curves are copies and must agree exactly; tensor metrics
and the loss 1e-6; the eval step as in test_torch_ngm (losses / accuracy /
cls_prob / ds_mat 1e-4, the AFA-U outputs k_prob / ks_loss / ks_error 1e-3,
perm_mat identical up to ties), at sk_tau = 0.05 with the AFA-U mixing
weights damped, for the reasons given there.
"""
import csv
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.core.config import default_stages as j_default_stages
from fpmatch_tpu.data import benchmark as j_benchmark
from fpmatch_tpu.data import generator as j_generator
from fpmatch_tpu.data import pipeline as j_pipeline
from fpmatch_tpu.evaluation import metrics as j_metrics
from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu.train import losses as j_losses
from fpmatch_tpu.train.state import TrainState
from fpmatch_tpu.train.step import make_eval_step as j_make_eval_step
from fpmatch_tpu_torch.cli import evaluate as t_evaluate
from fpmatch_tpu_torch.convert import from_flax_variables
from fpmatch_tpu_torch.core.config import default_stages as t_default_stages
from fpmatch_tpu_torch.data import benchmark as t_benchmark
from fpmatch_tpu_torch.data import generator as t_generator
from fpmatch_tpu_torch.data import pipeline as t_pipeline
from fpmatch_tpu_torch.evaluation import metrics as t_metrics
from fpmatch_tpu_torch.models.ngm import PairBatch, build_model
from fpmatch_tpu_torch.train import checkpoints as t_checkpoints
from fpmatch_tpu_torch.train import losses as t_losses
from fpmatch_tpu_torch.train import step as t_step
from test_torch_ngm import _perm_equal_up_to_ties
from test_torch_utils import (build_tiny, damp_afau_mixing,
                              randomize_batch_stats, shared_init, t2n,
                              tiny_jax_config, to_torch_config)

FIXTURE = Path(__file__).parent / "fixtures" / "PolyU-mini" / "DBII"


# ------------------------------------------------------------------ metrics

def _scored(seed, n=60, ties=False):
    rng = np.random.default_rng(seed)
    labels = (rng.uniform(size=n) < 0.45).astype(np.float32)
    scores = rng.normal(size=n) + 0.8 * labels
    if ties:
        scores = np.round(scores, 1)
    return labels, scores.astype(np.float32)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_verification_curves_are_the_same_numbers(seed, ties):
    labels, scores = _scored(seed, ties=ties)
    for name in ("roc_curve", "eer", "pr_curve", "pr_auc"):
        want = getattr(j_metrics, name)(labels, scores)
        got = getattr(t_metrics, name)(labels, scores)
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        assert len(want) == len(got), name
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), np.asarray(g)), name
    fpr, tpr, _ = j_metrics.roc_curve(labels, scores)
    assert t_metrics.auc(fpr, tpr) == j_metrics.auc(fpr, tpr)
    want = j_metrics.verification_metrics(labels, scores)
    got = t_metrics.verification_metrics(labels, scores)
    assert list(got) == list(want)
    assert set(t_evaluate.METRIC_COLUMNS) == set(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("labels", [np.ones(5, np.float32),
                                    np.zeros(5, np.float32)])
def test_verification_metrics_one_class_only(labels):
    scores = np.linspace(0, 1, 5).astype(np.float32)
    want = j_metrics.verification_metrics(labels, scores)
    got = t_metrics.verification_metrics(labels, scores)
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))


def _perm_case(seed, B=4, N=9):
    rng = np.random.default_rng(seed)
    ns1 = rng.integers(3, N + 1, size=B).astype(np.int32)
    ns2 = rng.integers(3, N + 1, size=B).astype(np.int32)
    pred = np.zeros((B, N, N), np.float32)
    gt = np.zeros((B, N, N), np.float32)
    for b in range(B):
        k = min(ns1[b], ns2[b])
        for m, keep in ((pred, 0.8), (gt, 0.7)):
            cols = rng.permutation(ns2[b])[:k]
            rows = rng.permutation(ns1[b])[:k]
            on = rng.uniform(size=k) < keep
            m[b, rows[on], cols[on]] = 1
    pred[0] = gt[0]                                       # one exact sample
    gt[1] = 0                                             # one empty GT
    return pred, gt, ns1, ns2


@pytest.mark.parametrize("name", ["matching_recall", "matching_precision",
                                  "matching_accuracy", "matching_f1"])
def test_matching_metrics_match_jax(name):
    pred, gt, ns1, ns2 = _perm_case(5)
    want = np.asarray(getattr(j_metrics, name)(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(ns1),
        jnp.asarray(ns2)))
    got = getattr(t_metrics, name)(
        torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(ns1),
        torch.from_numpy(ns2))
    assert tuple(got.shape) == want.shape == (4,)
    np.testing.assert_allclose(t2n(got), want, rtol=1e-6, atol=1e-6)


def test_pck_and_clustering_metrics_match_jax(rng):
    P = rng.uniform(0, 50, size=(3, 8, 2)).astype(np.float32)
    Q = (P + rng.normal(0, 3, size=P.shape)).astype(np.float32)
    ns = np.array([8, 5, 1], np.int32)
    th = np.array([1.0, 3.0, 10.0], np.float32)
    want = np.asarray(j_metrics.pck(jnp.asarray(Q), jnp.asarray(P),
                                    jnp.asarray(ns), jnp.asarray(th)))
    got = t_metrics.pck(torch.from_numpy(Q), torch.from_numpy(P),
                        torch.from_numpy(ns), torch.from_numpy(th))
    np.testing.assert_allclose(t2n(got), want, rtol=1e-6, atol=1e-6)
    a = rng.integers(0, 3, size=30)
    b = rng.integers(0, 3, size=30)
    for name in ("clustering_accuracy", "rand_index", "clustering_purity"):
        assert getattr(t_metrics, name)(a, b) == \
            getattr(j_metrics, name)(a, b), name


def test_permutation_loss_matches_jax(rng):
    """Forward value at 1e-6, with a fully converged cell (p == 1.0) and a
    zero cell in the valid block: the clamp keeps both finite."""
    B, N = 3, 7
    ds = rng.uniform(0, 1, size=(B, N, N)).astype(np.float32)
    ds[0, 0, 0], ds[0, 1, 1] = 1.0, 0.0
    _, gt, ns1, ns2 = _perm_case(7, B=B, N=N)
    want = float(j_losses.permutation_loss(
        jnp.asarray(ds), jnp.asarray(gt), jnp.asarray(ns1), jnp.asarray(ns2)))
    got = t_losses.permutation_loss(
        torch.from_numpy(ds), torch.from_numpy(gt), torch.from_numpy(ns1),
        torch.from_numpy(ns2))
    assert np.isfinite(want) and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)
    m = t_losses._valid_mask(torch.from_numpy(ns1), torch.from_numpy(ns2),
                             N, N)
    assert np.array_equal(t2n(m), np.asarray(j_losses._valid_mask(
        jnp.asarray(ns1), jnp.asarray(ns2), N, N)))


# ------------------------------------------------- dataset, pairs, samples

def _benches(tmp_path, split, task):
    kw = dict(root=str(FIXTURE), task=task)
    jb = j_benchmark.make_benchmark("PolyUDBII", split,
                                    output_dir=str(tmp_path / "j"), **kw)
    tb = t_benchmark.make_benchmark("PolyUDBII", split,
                                    output_dir=str(tmp_path / "t"), **kw)
    return jb, tb


@pytest.mark.parametrize("split,task", [("train", "classify"),
                                        ("test", "classify"),
                                        ("test", "match"),
                                        ("val", "classify")])
def test_fixture_index_and_pair_protocols_equal(tmp_path, split, task):
    jb, tb = _benches(tmp_path, split, task)
    assert tb.data_dict == jb.data_dict and len(tb.data_dict) > 0
    assert list(tb.data_dict) == list(jb.data_dict)
    assert tb.classes == jb.classes
    assert json.loads(tb.dataset.index_path().read_text()) == \
        json.loads(jb.dataset.index_path().read_text())
    assert tb.dataset.index_path().name == jb.dataset.index_path().name
    assert tb.classify_pairs() == jb.classify_pairs()
    assert tb.match_combinations() == jb.match_combinations()
    assert tb._session_pairs() == jb._session_pairs()
    assert tb._sibling_partners() == jb._sibling_partners()
    for a, b in jb.classify_pairs():
        assert tb.is_genuine(a, b) == jb.is_genuine(a, b)


def _shape_cfgs():
    jcfg = tiny_jax_config(n_max=16, e_max=96, univ=16, sk_tau=0.05)
    return jcfg, to_torch_config(jcfg)


def _same_sample(want, got):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        flat_a = jax.tree_util.tree_leaves(a)
        flat_b = jax.tree_util.tree_leaves(b)
        assert len(flat_a) == len(flat_b), f.name
        for x, y in zip(flat_a, flat_b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize("task", ["classify", "match"])
def test_pair_dataset_get_equal_field_for_field(tmp_path, task):
    """Images after `standardize` (the fixture's 96x96 files are resized),
    points, Delaunay edges, GT permutation, label and class names of every
    pair of the test split."""
    jb, tb = _benches(tmp_path, "test", task)
    jcfg, tcfg = _shape_cfgs()
    jpd = j_pipeline.PairDataset(jb, jcfg, augment=False)
    tpd = t_pipeline.PairDataset(tb, tcfg, augment=False)
    assert tpd.pairs == jpd.pairs and len(tpd) == len(jpd) > 2
    labels = set()
    for i in range(len(jpd) + 1):                  # + 1: indices wrap
        want, got = jpd.get(i), tpd.get(i)
        _same_sample(want, got)
        labels.add(got.label)
    if task == "classify":
        assert labels == {0.0, 1.0}


def test_generators_write_the_same_bytes(tmp_path):
    """Multi-impression mode with a sibling finger, small images: every file
    the JAX package's generator writes, the port's writes byte for byte."""
    kw = dict(fingers_per_split=(1, 2, 1), n_pores=24, seed=5,
              size=(160, 128), sessions=2, stances=2, sibling_fraction=0.5)
    j_generator.generate_synthetic_dataset(str(tmp_path / "j"), **kw)
    t_generator.generate_synthetic_dataset(str(tmp_path / "t"), **kw)
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert len(files) >= 2 * 4 * 4 and any(f.name == "siblings.json"
                                           for f in files)
    assert files == sorted(p.relative_to(tmp_path / "t")
                           for p in (tmp_path / "t").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
    img_j, pores_j = j_generator.render_fingerprint(3, (96, 80), n_pores=10)
    img_t, pores_t = t_generator.render_fingerprint(3, (96, 80), n_pores=10)
    assert np.array_equal(img_j, img_t) and np.array_equal(pores_j, pores_t)


def _same_batch(want, got):
    for name, a, b in zip(want._fields, want, got):
        if a is None:
            assert b is None, name
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("mode", ["one_worker", "threads", "processes"])
def test_loader_order_and_content(tmp_path, mode):
    """Sequential order, a short last batch, the same host batches as the
    JAX package's loader whatever runs the per-sample work; a second pass
    gives the same batches again."""
    jb, tb = _benches(tmp_path, "test", "classify")
    jcfg, tcfg = _shape_cfgs()
    jpd = j_pipeline.PairDataset(jb, jcfg, augment=False)
    tpd = t_pipeline.PairDataset(tb, tcfg, augment=False)
    bs = 3
    assert len(tpd) % bs != 0
    want = list(j_pipeline.DataLoader(jpd, jcfg, batch_size=bs, num_workers=1,
                                      drop_last=False))
    kw = {"one_worker": dict(num_workers=1),
          "threads": dict(num_workers=3, use_processes=False),
          "processes": dict(num_workers=2, use_processes=True)}[mode]
    loader = t_pipeline.DataLoader(tpd, tcfg, batch_size=bs, drop_last=False,
                                   **kw)
    try:
        assert len(loader) == len(want) == -(-len(tpd) // bs)
        for _ in range(2):
            got = list(loader)
            assert [b.label.shape[0] for b in got] == \
                [np.asarray(b.label).shape[0] for b in want]
            for w, g in zip(want, got):
                _same_batch(w, g)
    finally:
        loader.close()
    assert len(t_pipeline.DataLoader(tpd, tcfg, batch_size=bs,
                                     drop_last=True)) == len(tpd) // bs


def test_loader_device_cache_and_hook(tmp_path):
    """`device="cpu"` yields tensors; `device_prefetch` on the CPU changes
    nothing; `cache` replays the first pass; the host hook sees numpy."""
    _, tb = _benches(tmp_path, "test", "classify")
    _, tcfg = _shape_cfgs()
    tpd = t_pipeline.PairDataset(tb, tcfg, augment=False)
    host = list(t_pipeline.DataLoader(tpd, tcfg, batch_size=4, num_workers=1,
                                      drop_last=False))
    seen = []

    def hook(b):
        seen.append(type(b.images))
        return b

    loader = t_pipeline.DataLoader(tpd, tcfg, batch_size=4, num_workers=1,
                                   drop_last=False, device="cpu",
                                   device_prefetch=True, cache=True,
                                   host_batch_hook=hook)
    first = list(loader)
    assert all(t is np.ndarray for t in seen) and len(seen) == len(host)
    assert all(isinstance(b.images, torch.Tensor) for b in first)
    for h, d in zip(host, first):
        _same_batch(h, type(h)(*(None if a is None else t2n(a) for a in d)))
    again = list(loader)
    assert len(seen) == len(host)                  # replayed, not rebuilt
    assert all(a is b for a, b in zip(first, again))
    with pytest.raises(ValueError):
        t_pipeline.DataLoader(tpd, tcfg, device_prefetch=True)


def test_parts_that_wait_for_training_raise(tmp_path):
    """Training is ported: a train split now yields augmented pairs (seeded
    per index and epoch) and `loss_and_metrics(train=True)` runs with a
    gradient; cli.evaluate's `--augment` still waits (see
    test_cli_evaluate_options_that_wait_raise)."""
    _, tcfg = _shape_cfgs()
    tb_train = t_benchmark.make_benchmark(
        "PolyUDBII", "train", root=str(FIXTURE), task="classify",
        output_dir=str(tmp_path / "t"))
    pd = t_pipeline.PairDataset(tb_train, tcfg)    # a train split augments
    assert pd.augment
    s0, s1 = pd.get(0, epoch=0), pd.get(0, epoch=1)
    assert not np.array_equal(s0.images[0], s1.images[0])
    batch = t_pipeline.collate([s0, pd.get(len(pd) - 1)], tcfg)
    net = build_model(tcfg, device="cpu", seed=0)
    stage = t_default_stages()[0]
    total, (metrics, _) = t_step.loss_and_metrics(
        net, batch.to("cpu"), stage, train=True)
    assert total.requires_grad and np.isfinite(float(total))
    assert set(metrics) == {"loss", "total_loss", "ks_loss", "ks_error",
                            "cls_loss", "accuracy"}


# ------------------------------------------------------------- the eval step

@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """Three pairs of the fixture's test split (genuine and impostor),
    collated by the JAX package, a narrow model initialised by Flax."""
    tmp = tmp_path_factory.mktemp("eval_case")
    jb, _ = _benches(tmp, "test", "classify")
    jcfg, tcfg = _shape_cfgs()
    jpd = j_pipeline.PairDataset(jb, jcfg, augment=False)
    n = len(jpd)
    picks = [0, n // 2 - 1, n - 1]
    batch = j_pipeline.collate([jpd.get(i) for i in picks], jcfg)
    assert set(np.asarray(batch.label)) == {0.0, 1.0}
    model = JNet(jcfg)
    v = damp_afau_mixing(randomize_batch_stats(shared_init(jcfg)))
    net = build_model(tcfg, device="cpu",
                      state_dict=from_flax_variables(v, tcfg))
    return jcfg, tcfg, batch, model, v, net


@pytest.mark.parametrize("stage_index", [-1, 2, 3])
def test_eval_step_matches_jax(eval_case, stage_index):
    """Stage 6 (cls only; what evaluation uses), stage 3 (perm + ks + cls)
    and stage 4 (ks + cls): the loss composition follows the flags."""
    jcfg, tcfg, batch, model, v, net = eval_case
    jstage, tstage = (j_default_stages()[stage_index],
                      t_default_stages()[stage_index])
    assert dataclasses.asdict(jstage) == dataclasses.asdict(tstage)
    state = TrainState(v["params"], v["batch_stats"], None, jnp.zeros(()))
    want_m, want = j_make_eval_step(model, jstage)(state, batch)
    got_m, got = t_step.make_eval_step(net, tstage)(PairBatch(*(
        None if a is None else np.asarray(a) for a in batch)).to("cpu"))
    assert set(got) == set(want) == set(t_step.EVAL_OUTPUTS)
    assert set(got_m) == set(want_m)
    for k in want_m:
        tol = 1e-3 if k in ("ks_loss", "ks_error") else 1e-4
        if k == "total_loss" and tstage.loss_ks:
            tol = 1e-3
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=tol, atol=tol, err_msg=k)
    _perm_equal_up_to_ties(want, got)
    for k, tol in (("cls_prob", 1e-4), ("ds_mat", 1e-4), ("k_prob", 1e-3)):
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)
    assert not any(t.requires_grad for t in got.values())


def test_eval_step_masked_reranks_the_greedy_fill(eval_case):
    jcfg, tcfg, batch, model, v, net = eval_case
    from fpmatch_tpu.train.step import make_eval_step_masked as j_masked

    N = jcfg.shapes.n_max
    mask = np.zeros((3, N, N), np.float32)
    mask[:, np.arange(N), (np.arange(N) + 1) % N] = 1   # a shifted diagonal
    state = TrainState(v["params"], v["batch_stats"], None, jnp.zeros(()))
    _, want = j_masked(model, j_default_stages()[-1])(state, batch,
                                                       jnp.asarray(mask))
    tb = PairBatch(*(None if a is None else np.asarray(a)
                     for a in batch)).to("cpu")
    _, got = t_step.make_eval_step_masked(net, t_default_stages()[-1])(
        tb, torch.from_numpy(mask))
    assert np.array_equal(t2n(got["perm_mat"]), np.asarray(want["perm_mat"]))
    assert (t2n(got["perm_mat"]) <= mask).all()


def test_evaluate_loader_hungarian_matches_the_jax_flow(eval_case, tmp_path):
    """`evaluate_loader(..., discretize="hungarian")` against what the JAX
    CLI runs per batch: eval step, host LAPJV (`hungarian_host`) on its
    ds_mat, masked eval step. Every pair's matches lie in its LAPJV mask."""
    from fpmatch_tpu.ops.hungarian import hungarian_host as j_hungarian
    from fpmatch_tpu.train.step import make_eval_step_masked as j_masked

    jcfg, tcfg, _, model, v, net = eval_case
    jb, tb = _benches(tmp_path, "test", "classify")
    jpd = j_pipeline.PairDataset(jb, jcfg, augment=False)
    tpd = t_pipeline.PairDataset(tb, tcfg, augment=False)
    jpd.pairs, tpd.pairs = jpd.pairs[:6], tpd.pairs[:6]
    # two batches of one shape: one JAX compile of each step
    loader = t_pipeline.DataLoader(tpd, tcfg, batch_size=3, num_workers=1,
                                   drop_last=False, device="cpu")
    perms = []
    res = t_evaluate.evaluate_loader(
        net, loader, discretize="hungarian",
        on_batch=lambda bi, b, out: perms.append(
            (b, t2n(out["perm_mat"]), t2n(out["ds_mat"]))))
    state = TrainState(v["params"], v["batch_stats"], None, jnp.zeros(()))
    stage = j_default_stages()[-1]
    jstep, jmasked = j_make_eval_step(model, stage), j_masked(model, stage)
    cls, kp = [], []
    for b in j_pipeline.DataLoader(jpd, jcfg, batch_size=3, num_workers=1,
                                   drop_last=False):
        _, out = jstep(state, b)
        mask = j_hungarian(np.asarray(out["ds_mat"]),
                           np.asarray(b.n_nodes[:, 0]),
                           np.asarray(b.n_nodes[:, 1]))
        _, out = jmasked(state, b, mask)
        cls.append(np.asarray(out["cls_prob"]))
        kp.append(np.asarray(out["k_prob"]))
    assert len(res["scores"]) == 6 and len(perms) == 2
    np.testing.assert_allclose(res["cls_scores"], np.concatenate(cls),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["k_probs"], np.concatenate(kp),
                               rtol=1e-3, atol=1e-3)
    for b, perm, _ in perms:
        first = t_step.make_eval_step(net, t_default_stages()[-1])(b)[1]
        mask = t2n(hungarian_mask_of(first, b))
        assert (perm <= mask).all() and perm.sum() > 0
    with pytest.raises(ValueError):
        t_evaluate.evaluate_loader(net, loader, discretize="exact")


def hungarian_mask_of(out, batch):
    from fpmatch_tpu_torch.ops.hungarian import hungarian

    return hungarian(out["ds_mat"], batch.n_nodes[:, 0], batch.n_nodes[:, 1])


def test_evaluate_loader_scores_every_pair_once(eval_case, tmp_path):
    """`cli.evaluate.evaluate_loader` over the fixture's test split with the
    narrow model: one score per pair in pair order, a short last batch, the
    report of the fused score, and the same numbers as the eval step of the
    JAX package batch by batch."""
    jcfg, tcfg, _, model, v, net = eval_case
    jb, tb = _benches(tmp_path, "test", "classify")
    jpd = j_pipeline.PairDataset(jb, jcfg, augment=False)
    tpd = t_pipeline.PairDataset(tb, tcfg, augment=False)
    loader = t_pipeline.DataLoader(tpd, tcfg, batch_size=4, num_workers=1,
                                   drop_last=False, device="cpu",
                                   device_prefetch=True)
    seen = []
    res = t_evaluate.evaluate_loader(
        net, loader, score="fused",
        on_batch=lambda bi, b, out: seen.append(int(b.label.shape[0])))
    n = len(tpd)
    assert sum(seen) == n and seen[-1] == n % 4 != 0
    assert len(res["batch_seconds"]) == len(seen)
    for k in ("labels", "scores", "cls_scores", "k_probs"):
        assert res[k].shape == (n,), k
    assert np.array_equal(res["labels"],
                          [float(tb.is_genuine(*p)) for p in tpd.pairs])
    np.testing.assert_allclose(res["scores"],
                               res["cls_scores"] * res["k_probs"])
    assert res["report"] == t_metrics.verification_metrics(res["labels"],
                                                           res["scores"])
    state = TrainState(v["params"], v["batch_stats"], None, jnp.zeros(()))
    jstep = j_make_eval_step(model, j_default_stages()[-1])
    cls, kp = [], []
    for b in j_pipeline.DataLoader(jpd, jcfg, batch_size=3, num_workers=1,
                                   drop_last=False):
        _, out = jstep(state, b)
        cls.append(np.asarray(out["cls_prob"]))
        kp.append(np.asarray(out["k_prob"]))
    np.testing.assert_allclose(res["cls_scores"], np.concatenate(cls),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["k_probs"], np.concatenate(kp),
                               rtol=1e-3, atol=1e-3)
    assert set(res["metrics"]) == {"loss", "total_loss", "ks_loss",
                                   "ks_error", "cls_loss", "accuracy"}
    with pytest.raises(ValueError):
        t_evaluate.evaluate_loader(net, [])


# ---------------------------------------------------- checkpoints and the CLI

def test_checkpoint_files_round_trip(eval_case, tmp_path):
    """`<dir>/<name>.pt` + checkpoint.json with `latest`; restoring gives
    the saved tensors; `cli.match` reads the same sidecar."""
    from fpmatch_tpu_torch.cli import match as t_match

    *_, net = eval_case
    d = tmp_path / "ckpt"
    assert t_checkpoints.read_meta(str(d)) == {}
    p = t_checkpoints.save_checkpoint(str(d), "a", net, extra={"stage": 6})
    assert Path(p) == d / "a.pt" and Path(p).exists()
    t_checkpoints.save_checkpoint(str(d), "b", net.state_dict())
    meta = json.loads((d / "checkpoint.json").read_text())
    assert meta == {"latest": "b", "stage": 6} == \
        t_checkpoints.read_meta(str(d))
    sd = t_checkpoints.restore_params(str(d), "a")
    want = net.state_dict()
    assert list(sd) == list(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    assert not hasattr(t_match, "read_meta")      # it lives here now


CLI_ARGS = ["--dataset", "PolyUDBII", "--data-root", str(FIXTURE),
            "--n-max", "16", "--e-max", "96", "--univ", "16",
            "--thread-workers"]


def test_cli_evaluate_on_the_cpu_writes_the_artifacts(tmp_path, monkeypatch,
                                                      capsys):
    """Full-width model from `--seed`, 5 of the fixture's test pairs in
    batches of 2 (so the last batch is short): eval.log, scores.csv with one
    row per pair in pair order, metrics.csv with the ten columns, the three
    plots and `--num-viz` match drawings. A second run from a saved
    checkpoint gives the same scores."""
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)                   # the index cache: ./data/
    out = tmp_path / "out"
    argv = CLI_ARGS + ["--output-dir", str(out), "--batch-size", "2",
                       "--limit", "5", "--num-viz", "3", "--device", "cpu",
                       "--seed", "4",
                       "--checkpoint-dir", str(tmp_path / "none")]
    report = t_evaluate.main(argv)
    assert "random weights" in capsys.readouterr().out
    assert (out / "eval.log").read_text().count("\n") >= 5
    rows = list(csv.reader(open(out / "scores.csv")))
    assert rows[0] == ["id_a", "id_b", "label", "score", "cls_prob", "k_prob"]
    assert len(rows) == 1 + 5
    tb = t_benchmark.make_benchmark("PolyUDBII", "test", root=str(FIXTURE),
                                    task="classify",
                                    output_dir=str(tmp_path / "idx"))
    pairs = tb.classify_pairs()
    keep = sorted(np.random.default_rng(0).choice(len(pairs), size=5,
                                                  replace=False))
    for r, i in zip(rows[1:], keep):
        assert (r[0], r[1]) == pairs[i]
        assert int(r[2]) == int(tb.is_genuine(*pairs[i]))
        assert abs(float(r[3]) - float(r[4]) * float(r[5])) < 2e-6
    mrows = list(csv.reader(open(out / "metrics.csv")))
    assert mrows[0] == ["accuracy", "precision", "recall", "f1", "roc_auc",
                       "pr_auc", "far", "frr", "eer", "threshold"]
    assert [float(x) for x in mrows[1]] == [report[c] for c in mrows[0]]
    for name in ("roc_curve.png", "pr_curve.png", "k_histogram.png",
                 "match_00.png", "match_01.png", "match_02.png"):
        assert (out / name).stat().st_size > 0, name
    assert not (out / "match_03.png").exists()
    assert not (out / "sibling_metrics.csv").exists()    # no siblings.json

    # the same weights through a checkpoint file
    from fpmatch_tpu_torch.cli import model_config_from_args

    args = t_evaluate.build_parser().parse_args(argv)
    net = build_model(model_config_from_args(args), device="cpu", seed=4)
    t_checkpoints.save_checkpoint(str(tmp_path / "ck"), "seed4", net)
    out2 = tmp_path / "out2"
    t_evaluate.main(CLI_ARGS + [
        "--output-dir", str(out2), "--batch-size", "5", "--limit", "5",
        "--num-viz", "0", "--device", "cpu", "--seed", "9",
        "--checkpoint-dir", str(tmp_path / "ck")])
    assert "restored checkpoint seed4" in (out2 / "eval.log").read_text()
    rows2 = list(csv.reader(open(out2 / "scores.csv")))
    assert [r[:3] for r in rows2] == [r[:3] for r in rows]
    np.testing.assert_allclose(
        np.array([r[3:] for r in rows2[1:]], float),
        np.array([r[3:] for r in rows[1:]], float), atol=2e-4)
    assert not list(out2.glob("match_*.png"))


def test_cli_evaluate_discretize_hungarian_runs(tmp_path, monkeypatch):
    """`--discretize hungarian` (it raised until the native library was
    ported): one score per pair, and the log says which discretization."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_evaluate, "have_matplotlib", lambda: False)
    out = tmp_path / "out"
    t_evaluate.main(CLI_ARGS + [
        "--output-dir", str(out), "--batch-size", "2", "--limit", "3",
        "--device", "cpu", "--checkpoint-dir", str(tmp_path / "none"),
        "--discretize", "hungarian"])
    assert "discretize=hungarian" in (out / "eval.log").read_text()
    rows = list(csv.reader(open(out / "scores.csv")))
    assert len(rows) == 4
    for r in rows[1:]:
        assert abs(float(r[3]) - float(r[4]) * float(r[5])) < 2e-6


def test_cli_evaluate_without_matplotlib_skips_the_drawings(tmp_path,
                                                           monkeypatch):
    """Where matplotlib is missing the scores and metrics are still written;
    only the drawings and plots are left out, with a warning in eval.log."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_evaluate, "have_matplotlib", lambda: False)
    monkeypatch.setattr(t_evaluate, "plot_curves", lambda *a: pytest.fail(
        "plots must not be drawn without matplotlib"))
    monkeypatch.setattr(t_evaluate, "save_match_viz", lambda *a: pytest.fail(
        "matches must not be drawn without matplotlib"))
    out = tmp_path / "out"
    t_evaluate.main(CLI_ARGS + [
        "--output-dir", str(out), "--batch-size", "2", "--limit", "2",
        "--device", "cpu", "--checkpoint-dir", str(tmp_path / "none")])
    assert "matplotlib is not installed" in (out / "eval.log").read_text()
    assert len(list(csv.reader(open(out / "scores.csv")))) == 3
    assert (out / "metrics.csv").exists() and not list(out.glob("*.png"))


def test_cli_evaluate_hyperedge_cls_k_augment_on_the_cpu(tmp_path,
                                                          monkeypatch):
    """`--hyperedge --cls-k-features --augment` (tiny widths,
    test_torch_utils.build_tiny): the model carries both options, the test
    pairs are augmented as the JAX CLI's `PairDataset(bench, cfg,
    augment=args.augment)` (the first pair differs from its plain form),
    every batch carries its triangles into the model, and the scores are
    finite, one row per pair."""
    from fpmatch_tpu_torch.models import ngm as t_ngm

    built = build_tiny(monkeypatch)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_evaluate, "have_matplotlib", lambda: False)
    loaders, tris = [], []
    real_eval = t_evaluate.evaluate_loader
    monkeypatch.setattr(t_evaluate, "evaluate_loader",
                        lambda model, loader, **k: loaders.append(loader)
                        or real_eval(model, loader, **k))
    real_fwd = t_ngm.NGMNet.forward
    monkeypatch.setattr(t_ngm.NGMNet, "forward",
                        lambda self, b, *a, **k: tris.append(b.n_tris)
                        or real_fwd(self, b, *a, **k))
    out = tmp_path / "out"
    report = t_evaluate.main(CLI_ARGS + [
        "--output-dir", str(out), "--batch-size", "2", "--limit", "3",
        "--device", "cpu", "--checkpoint-dir", str(tmp_path / "none"),
        "--hyperedge", "--cls-k-features", "--augment"])
    cfg, model, _ = built[0]
    assert cfg.ngm.hyperedge and cfg.ngm.cls_k_features
    assert hasattr(model, "tri_aff") and model.match_cls.fc.in_features == \
        cfg.ngm.match_cls_channels[-1] + 3
    pd = loaders[0].dataset
    assert pd.augment
    plain = t_pipeline.PairDataset(pd.bench, cfg, augment=False)
    plain.pairs = pd.pairs
    assert not np.array_equal(pd.get(0).images[0], plain.get(0).images[0])
    assert len(tris) == 2 and all(int(t.min()) > 0 for t in tris)
    rows = list(csv.reader(open(out / "scores.csv")))
    assert len(rows) == 1 + 3
    assert np.isfinite(np.array([r[3:] for r in rows[1:]], float)).all()
    assert np.isfinite(report["eer"])


def test_cli_evaluate_defaults_to_cuda_and_refuses_without_a_gpu(tmp_path):
    args = t_evaluate.build_parser().parse_args([])
    assert (args.device, args.batch_size, args.n_max, args.e_max, args.univ,
            args.num_viz, args.score, args.discretize) == \
        ("cuda", 8, 64, 384, 600, 4, "fused", "greedy")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_evaluate.main(CLI_ARGS + ["--output-dir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_cli_evaluate_has_every_flag_of_the_jax_cli():
    """Same flags and defaults as the JAX package's parser, plus --device and
    --seed (read from its source: building it there needs no JAX)."""
    import re

    src = (Path(__file__).resolve().parents[1] / "fpmatch_tpu" / "cli" /
           "evaluate.py").read_text()
    want = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src))
    got = {a.option_strings[0] for a in t_evaluate.build_parser()._actions
           if a.option_strings and a.option_strings[0] != "-h"}
    assert len(want) >= 15
    assert got == want | {"--device", "--seed"}
