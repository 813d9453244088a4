"""The slice as a whole on the CPU: the port's NGMNet against the JAX
package's, weights carried across by `convert.from_flax_variables`, on a
`__graft_entry__._tiny_config`-sized model.

  * bucket route: B = 3 mixing n1 < n2, n1 > n2 and an impostor with k ~ 0;
  * UNIV route: B = 1, JAX `plan_univ_v3` + Pallas kernel in interpret mode
    versus the port's plan + plain kernel version.

`perm_mat` must be identical; every other output key agrees within 1e-4,
except the three that come out of the AFA-U head (k_prob, ks_loss, ks_error:
1e-3). To make that a statement about the arithmetic and not about float32
noise, the models run at sk_tau = 0.05 (the layers' own default; the config's
0.01 multiplies rounding noise by 100 at each of five Sinkhorn / top-k stages)
and with the AFA-U score-mixing weights scaled into a well-conditioned range
(see test_torch_utils.damp_afau_mixing). Why AFA-U keeps 1e-3: a randomly
initialised matcher gives it a nearly uniform Sinkhorn map, so its
instance norms divide by sqrt(var + 1e-5) with var ~ 1e-5 over nearly
identical rows and magnify the 3e-7 difference of their input some 300
times; on a generic cost matrix the head itself agrees to 1e-4
(test_torch_models.test_afau_encoder_matches). One more test keeps the
untouched init and tau = 0.01 and states what still holds there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.data.synthetic import synthetic_pair_batch as j_synth
from fpmatch_tpu.kernels.assoc_univ_v3 import plan_univ_v3 as j_plan
from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu_torch.convert import from_flax_variables
from fpmatch_tpu_torch.data.synthetic import synthetic_pair_batch as t_synth
from fpmatch_tpu_torch.kernels.assoc_univ_v3 import plan_univ_v3 as t_plan
from fpmatch_tpu_torch.models.ngm import NGMNet, PairBatch, build_model
from test_torch_utils import (damp_afau_mixing, randomize_batch_stats,
                              shared_init, t2n, tiny_jax_config,
                              to_torch_config)

KEYS = ("ds_mat", "raw_scores", "sinkhorn", "perm_mat", "Kp", "ks_loss",
        "ks_error", "cls_loss", "cls_logits", "cls_prob", "k_prob")


def _mixed_batch(jcfg, seed):
    """Three pairs: genuine n1 == n2, then n1 < n2 and n1 > n2 made by
    cutting nodes (and the edges that touch them) off one view; the last one
    is relabelled impostor with gt_k = 0."""
    b = j_synth(jcfg, 3, genuine_ratio=1.0, n_range=(8, 12),
                image_hw=(32, 48), seed=seed)
    b = jax.tree_util.tree_map(np.array, b)
    N = jcfg.shapes.n_max
    for i, view in ((1, 0), (2, 1)):
        keep = int(b.n_nodes[i, view]) - 3
        s, d = b.src[i, view], b.dst[i, view]
        ne = int(b.n_edges[i, view])
        ok = (s[:ne] < keep) & (d[:ne] < keep)
        s2, d2 = s[:ne][ok], d[:ne][ok]
        b.src[i, view] = 0
        b.dst[i, view] = 0
        b.src[i, view, :len(s2)] = s2
        b.dst[i, view, :len(d2)] = d2
        b.n_edges[i, view] = len(s2)
        b.n_nodes[i, view] = keep
        b.points[i, view, keep:] = 0
        if view == 0:
            b.gt_perm[i, keep:] = 0
        else:
            b.gt_perm[i, :, keep:] = 0
    b.gt_perm[2] = 0
    b.label[2] = 0.0
    b = b._replace(gt_k=b.gt_perm.sum((1, 2)).astype(np.float32))
    assert b.n_nodes[1, 0] < b.n_nodes[1, 1]
    assert b.n_nodes[2, 0] > b.n_nodes[2, 1]
    return b


def _torch_batch(b):
    return PairBatch(*(None if a is None else np.asarray(a) for a in b))


AFAU_KEYS = ("k_prob", "ks_loss", "ks_error")


def _perm_equal_up_to_ties(want, got, tie=1e-4):
    """Same number of matches per pair, and wherever the two greedy fills
    picked different cells, the cells they chose between rank the same to
    `tie` in the JAX soft-top-k map (an exact tie there is broken by float32
    noise, not by the implementation)."""
    pw, pg = np.asarray(want["perm_mat"]), t2n(got["perm_mat"])
    ds = np.asarray(want["ds_mat"])
    assert np.array_equal(pw.sum((1, 2)), pg.sum((1, 2)))
    for b in range(len(pw)):
        only_w = np.sort(ds[b][(pw[b] == 1) & (pg[b] == 0)])
        only_g = np.sort(ds[b][(pg[b] == 1) & (pw[b] == 0)])
        np.testing.assert_allclose(only_g, only_w, rtol=0, atol=tie)


def _compare(want, got, tol, tol_k=1e-3, exact_perm=True):
    assert set(got) == set(KEYS) == set(want)
    if exact_perm:
        assert np.array_equal(t2n(got["perm_mat"]),
                              np.asarray(want["perm_mat"]))
    else:
        _perm_equal_up_to_ties(want, got)
    for k in KEYS:
        if k == "perm_mat" and not exact_perm:
            continue
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        t = tol_k if k in AFAU_KEYS else tol
        np.testing.assert_allclose(t2n(got[k]), w, rtol=t, atol=t, err_msg=k)


def test_synthetic_batch_same_seed_same_batch():
    """Same RNG call order: the port's generator reproduces the JAX
    package's batch bit for bit (impostors included)."""
    jcfg = tiny_jax_config()
    jb = j_synth(jcfg, 4, genuine_ratio=0.5, n_range=(6, 12),
                 image_hw=(32, 48), seed=11)
    tb = t_synth(to_torch_config(jcfg), 4, genuine_ratio=0.5,
                 n_range=(6, 12), image_hw=(32, 48), seed=11)
    assert set(np.asarray(jb.label)) == {0.0, 1.0}
    for name, a, b in zip(jb._fields, jb, tb):
        if a is None:
            assert b is None
        else:
            assert np.array_equal(np.asarray(a), b), name
            assert np.asarray(a).dtype == b.dtype, name


@pytest.fixture(scope="module")
def bucket_case():
    jcfg = tiny_jax_config(sk_tau=0.05)
    batch = _mixed_batch(jcfg, seed=3)
    model = JNet(jcfg)
    v = damp_afau_mixing(randomize_batch_stats(shared_init(jcfg)))
    return jcfg, batch, model, v


def test_ngm_bucket_route_matches_jax(bucket_case):
    """B = 3, mixed orientations + an impostor, every output key, 1e-4."""
    jcfg, batch, model, v = bucket_case
    want = model.apply(v, batch, train=False)
    tcfg = to_torch_config(jcfg)
    net = build_model(tcfg, device="cpu",
                      state_dict=from_flax_variables(v, tcfg))
    got = net(_torch_batch(batch).to("cpu"))
    assert 0 < float(got["perm_mat"].sum()) < 30
    _compare(want, got, 1e-4)


def test_ngm_bucket_route_uint8_luma_images(bucket_case):
    """The serving CLI ships (B, 2, H, W, 1) uint8 luma; both models
    normalize on the device and broadcast to RGB. Uniform-noise images give
    this pair exact ties in the soft-top-k map, so perm_mat is compared up to
    ties and the classifier outputs that read it are left out."""
    jcfg, batch, model, v = bucket_case
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, size=batch.images.shape[:4] + (1,),
                        dtype=np.uint8)
    batch = batch._replace(images=imgs)
    want = model.apply(v, batch, train=False)
    tcfg = to_torch_config(jcfg)
    net = build_model(tcfg, device="cpu",
                      state_dict=from_flax_variables(v, tcfg))
    got = net(_torch_batch(batch).to("cpu"))
    _perm_equal_up_to_ties(want, got)
    for k in ("Kp", "raw_scores", "sinkhorn", "ds_mat"):
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(t2n(got["k_prob"]), np.asarray(want["k_prob"]),
                               rtol=1e-3, atol=1e-3)


def test_ngm_hungarian_mask_argument(bucket_case):
    """The second-pass protocol's mask re-ranks the greedy fill."""
    jcfg, batch, model, v = bucket_case
    rng = np.random.default_rng(6)
    mask = (rng.uniform(size=batch.gt_perm.shape) < 0.5).astype(np.float32)
    want = model.apply(v, batch, train=False,
                       hungarian_mask=jnp.asarray(mask))
    tcfg = to_torch_config(jcfg)
    net = build_model(tcfg, device="cpu",
                      state_dict=from_flax_variables(v, tcfg))
    got = net(_torch_batch(batch).to("cpu"),
              hungarian_mask=torch.from_numpy(mask))
    _compare(want, got, 1e-4)


@pytest.fixture(scope="module")
def univ_case():
    """B = 1 at n_max 16 for the UNIV route: the JAX config, the batch, the
    padded graph-2 points, the edge lists, the plan's arguments (slot caps
    keep the interpreted Pallas kernel's unrolled nest short; the port's
    plan takes the same ones) and one Flax init."""
    jcfg = tiny_jax_config(n_max=16, e_max=96, sk_tau=0.05)
    batch = j_synth(jcfg, 1, n_range=(11, 15), image_hw=(32, 48), seed=7)
    N = jcfg.shapes.n_max
    n2 = int(batch.n_nodes[0, 1])
    e1, e2 = int(batch.n_edges[0, 0]), int(batch.n_edges[0, 1])
    s1, d1 = np.asarray(batch.src[0, 0, :e1]), np.asarray(batch.dst[0, 0, :e1])
    s2, d2 = np.asarray(batch.src[0, 1, :e2]), np.asarray(batch.dst[0, 1, :e2])
    pts2 = np.full((N, 2), 1e9, np.float32)
    pts2[:n2] = np.asarray(batch.points[0, 1, :n2])
    pts2[n2:, 0] += np.arange(N - n2)
    caps = dict(transpose=True, n1=N, s1_cap=3, s2_cap=3)
    v = damp_afau_mixing(randomize_batch_stats(shared_init(jcfg)))
    return jcfg, batch, (pts2, s1, d1, s2, d2), caps, v


@pytest.mark.parametrize("univ_bf16", [False, True])
def test_ngm_univ_route_matches_jax(univ_case, univ_bf16):
    """B = 1 through the UNIV branch on both sides: JAX plan + Pallas kernel
    (interpret mode) vs the port's plan + plain kernel version. With
    univ_bf16 the aggregation reads bf16-rounded features on both sides and
    both round Ke to bf16 on the pairs the JAX plan keeps (f32 Ke on its
    spilled pairs): the same products, so the bounds of the f32 case hold,
    perm_mat included."""
    jcfg, batch, (pts2, s1, d1, s2, d2), caps, v = univ_case
    jplan = j_plan(pts2, s1, d1, s2, d2, **caps)
    want = JNet(jcfg, univ_plan=jplan, univ_bf16=univ_bf16).apply(
        v, batch, train=False)

    tcfg = to_torch_config(jcfg)
    plan = t_plan(pts2, s1, d1, s2, d2, **caps)
    net = build_model(tcfg, device="cpu", univ_bf16=univ_bf16,
                      state_dict=from_flax_variables(v, tcfg))
    tb = _torch_batch(batch).to("cpu")
    got = net(tb, univ_plan=plan)
    _compare(want, got, 1e-4)
    if univ_bf16:
        return
    # the same model, default route: the two routes of the port agree
    default = net(tb)
    for k in KEYS:
        t = 1e-3 if k in AFAU_KEYS else 1e-4
        np.testing.assert_allclose(t2n(default[k]), t2n(got[k]), rtol=t,
                                   atol=t, err_msg=k)
    # and a plan given at construction is the same as one given per call
    net.univ_plan = plan
    again = net(tb)
    assert all(torch.equal(again[k], got[k]) for k in KEYS)
    with pytest.raises(ValueError):
        net(PairBatch(*(None if a is None else torch.cat([a, a])
                        for a in tb)))


def test_eval_step_masked_univ_route_matches_jax(univ_case, monkeypatch):
    """The masked step of a UNIV request against the JAX model built with
    its plan (Pallas interpret mode; the outputs of JAX's masked step are its
    forward's with the mask), given the same plan and mask. The plan must reach the forward: the UNIV
    aggregation runs once per GNN layer in the masked pass, and a step built
    without the plan would take the bucket route instead."""
    from fpmatch_tpu_torch.core.config import default_stages as t_stages
    from fpmatch_tpu_torch.models import ngm as t_ngm
    from fpmatch_tpu_torch.train import step as t_step

    jcfg, batch, (pts2, s1, d1, s2, d2), caps, v = univ_case
    N = jcfg.shapes.n_max
    jmodel = JNet(jcfg, univ_plan=j_plan(pts2, s1, d1, s2, d2, **caps))
    mask = np.zeros((1, N, N), np.float32)
    mask[0, np.arange(N), (np.arange(N) + 2) % N] = 1
    # the JAX masked step's outputs are its forward's with the mask (eager
    # here: jitting the interpreted Pallas kernel costs half a minute)
    want = jmodel.apply(v, batch, train=False,
                        hungarian_mask=jnp.asarray(mask))

    tcfg = to_torch_config(jcfg)
    net = build_model(tcfg, device="cpu",
                      state_dict=from_flax_variables(v, tcfg))
    calls = []
    univ = t_ngm.assoc_matvec_univ_v3
    monkeypatch.setattr(t_ngm, "assoc_matvec_univ_v3",
                        lambda *a, **k: calls.append(1) or univ(*a, **k))
    plan = t_plan(pts2, s1, d1, s2, d2, **caps)
    tb = _torch_batch(batch).to("cpu")
    _, got = t_step.make_eval_step_masked(net, t_stages()[-1],
                                          univ_plan=plan)(
        tb, torch.from_numpy(mask))
    assert len(calls) == tcfg.ngm.gnn_layers == 3
    assert np.array_equal(t2n(got["perm_mat"]), np.asarray(want["perm_mat"]))
    assert (t2n(got["perm_mat"]) <= mask).all()
    for k, tol in (("cls_prob", 1e-4), ("ds_mat", 1e-4), ("k_prob", 1e-3)):
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)
    # the unmasked step carries the plan too
    t_step.make_eval_step(net, t_stages()[-1], univ_plan=plan)(tb)
    assert len(calls) == 6
    t_step.make_eval_step_masked(net, t_stages()[-1])(
        tb, torch.from_numpy(mask))
    assert len(calls) == 6                  # no plan: the bucket route


def test_ngm_untouched_init_at_model_temperature():
    """Flax's own init (AFA-U mixing weights in U(-10, 10)) and the config's
    tau = 0.01. The discrete result and everything upstream of the noise
    amplifiers still agree tightly: Kp to 1e-5, raw_scores to 1e-4,
    perm_mat up to ties in the ranking map; the Sinkhorn-amplified maps
    (100x per stage) and what is computed from them to 1e-2."""
    jcfg = tiny_jax_config()
    batch = _mixed_batch(jcfg, seed=3)
    model = JNet(jcfg)
    v = shared_init(jcfg)
    want = model.apply(v, batch, train=False)
    tcfg = to_torch_config(jcfg)
    net = build_model(tcfg, device="cpu",
                      state_dict=from_flax_variables(v, tcfg))
    got = net(_torch_batch(batch).to("cpu"))
    _perm_equal_up_to_ties(want, got, tie=1e-2)
    for k, tol in (("Kp", 1e-5), ("raw_scores", 1e-4), ("cls_logits", 1e-2),
                   ("cls_prob", 1e-2), ("sinkhorn", 1e-2), ("ds_mat", 1e-2),
                   ("k_prob", 1e-2)):
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), rtol=tol,
                                   atol=tol, err_msg=k)


def test_ngm_options_that_wait_raise():
    """Every option of the JAX model is taken (test_torch_hyperedge,
    test_torch_configs, test_torch_parallel); what is left are the JAX
    model's own refusals of the edge-sharded route: a row plan without a
    rank grid (ValueError, the JAX model's "no mesh"), and with hyperedge
    (NotImplementedError). Train mode works."""
    from fpmatch_tpu_torch.parallel.distributed import RankGrid
    from fpmatch_tpu_torch.parallel.edge_partition import plan_batch_rows

    tcfg = to_torch_config(tiny_jax_config())
    net = NGMNet(tcfg)
    batch = t_synth(tcfg, 1, n_range=(6, 10), image_hw=(32, 48), seed=1)
    plan = plan_batch_rows(tcfg.shapes.n_max, batch.src[:, 0],
                           batch.dst[:, 0], 2)
    with pytest.raises(ValueError, match="no rank grid"):
        net(batch._replace(row_plan=plan).to("cpu"))
    hcfg = to_torch_config(tiny_jax_config(hyperedge=True))
    hbatch = t_synth(hcfg, 1, n_range=(6, 10), image_hw=(32, 48), seed=1)
    # refused before any collective: a grid needs no process group here
    grid = RankGrid(data=1, edge=2, d=0, e=0, data_group=None,
                    edge_group=None)
    with pytest.raises(NotImplementedError,
                       match="hyperedge \\+ edge sharding not combined"):
        NGMNet(hcfg, grid=grid)(hbatch._replace(row_plan=plan).to("cpu"))
    assert not net.training
    net.train()                         # train mode works (training ported)
    assert net.training and net.backbone.training
    net.eval()
    assert not net.training


def test_entry_points_refuse_cuda_without_a_gpu():
    """`cuda` is the default device; without a GPU it is an error, never a
    silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tcfg = to_torch_config(tiny_jax_config())
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(tcfg)
    assert next(build_model(tcfg, device="cpu").parameters()
                ).device.type == "cpu"


def test_seeded_init_is_reproducible_and_finite():
    tcfg = to_torch_config(tiny_jax_config())
    a = build_model(tcfg, device="cpu", seed=3).state_dict()
    b = build_model(tcfg, device="cpu", seed=3).state_dict()
    c = build_model(tcfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    batch = t_synth(tcfg, 2, n_range=(6, 12), image_hw=(32, 48), seed=1)
    out = build_model(tcfg, device="cpu", seed=3)(batch.to("cpu"))
    assert all(torch.isfinite(v).all() for v in out.values())


def test_converter_rejects_a_tree_that_does_not_fit():
    jcfg = tiny_jax_config()
    v = shared_init(jcfg)
    tcfg = to_torch_config(jcfg)
    sd = from_flax_variables(v, tcfg)
    assert set(sd) == set(NGMNet(tcfg).state_dict())
    # Dense kernels are transposed, conv kernels HWIO -> OIHW
    np.testing.assert_array_equal(
        t2n(sd["classifier.weight"]), v["params"]["classifier"]["kernel"].T)
    k = v["params"]["backbone"]["conv1"]["kernel"]
    np.testing.assert_array_equal(t2n(sd["backbone.conv1.weight"]),
                                  k.transpose(3, 2, 0, 1))
    del v["params"]["afau"]["row_block"]["Wq"]
    with pytest.raises(ValueError, match="missing"):
        from_flax_variables(v, tcfg)
    wide = to_torch_config(tiny_jax_config(univ=20))
    with pytest.raises(ValueError, match="shape-mismatch|missing"):
        from_flax_variables(v, wide)
