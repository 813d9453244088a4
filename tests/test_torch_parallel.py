"""The port's `parallel/` against the JAX package's on the CPU.

  * planners: `plan_row_shards` / `plan_batch_rows` equal JAX's arrays bit
    for bit (p = 2 / 4 / 8, both orientations, Delaunay graphs at n = 16-64,
    a random graph, a batch with padded edge slots), `halo_fraction` too;
  * the per-rank aggregate with the exchange an index copy
    (`emulated_row_sharded_aggregate`) against the unsharded
    `ops.assoc.assoc_matvec(..., transpose=True)`, forward and the gradients
    of X, Kp and Ke, within 1e-5 of each result's largest value; and
    against JAX's host-loop `edge_partition_reference`;
  * the real collectives: one world of 4 gloo processes, spawned once for
    the module (test_torch_mesh_worker.World), runs meshes 4x1, 1x4 and 2x2:
    the aggregate against the one-process result (1e-5), the tiny model's
    forward with a row plan against the port's and JAX's one-device forward
    of the same weights (test_parallel's rtol 2e-2 / atol 2e-3, perm_mat
    flips <= 0.5 %), and one stage-3 train step against the port's
    one-device step on the global batch (loss to rtol 2e-3, every
    partition's gradient at cosine >= 0.9999, BatchNorm statistics to 1e-5,
    the weights of an edge group identical after the step). The references
    are computed here, while the ranks run.

The models run at sk_tau = 0.05 with damped AFA-U mixing weights, as in
test_torch_train (see test_torch_ngm's docstring: the config's 0.01 turns
float32 rounding noise into percents).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.data.synthetic import synthetic_pair_batch as j_synth
from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu.parallel import edge_partition as jep
from fpmatch_tpu_torch.convert import from_flax_variables
from fpmatch_tpu_torch.core.config import default_stages
from fpmatch_tpu_torch.models import ngm as t_ngm
from fpmatch_tpu_torch.models.ngm import build_model
from fpmatch_tpu_torch.ops.assoc import assoc_matvec
from fpmatch_tpu_torch.parallel import edge_partition as tep
from fpmatch_tpu_torch.train import state as t_state
from fpmatch_tpu_torch.train import step as t_step
from test_torch_mesh_worker import MESHES, World, mesh_checks
from test_torch_train import NOISE_BOUND
from test_torch_utils import (damp_afau_mixing, randomize_batch_stats,
                              shared_init, t2n, tiny_jax_config,
                              to_torch_config)

OUT_KEYS = ("ds_mat", "perm_mat", "cls_prob", "k_prob", "raw_scores")


def _delaunay(rng, n):
    pts = rng.uniform(size=(n, 2)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0])]       # spatially coherent row order
    _, s, d = build_edges(pts, stg="tri")
    return s.astype(np.int32), d.astype(np.int32)


def _random_graph(rng, n, density=0.3):
    A = rng.uniform(size=(n, n)) < density
    np.fill_diagonal(A, False)
    s, d = np.nonzero(A | A.T)
    return s.astype(np.int32), d.astype(np.int32)


def _padded(rng, B, n_max, e_max, n_range=(10, 16)):
    """(B, e_max) edge lists of Delaunay graphs, padded slots on node 0,
    and their masks."""
    src = np.zeros((B, e_max), np.int32)
    dst = np.zeros((B, e_max), np.int32)
    mask = np.zeros((B, e_max), bool)
    for b in range(B):
        s, d = _delaunay(rng, int(rng.integers(*n_range)))
        src[b, :len(s)], dst[b, :len(d)], mask[b, :len(s)] = s, d, True
    return src, dst, mask


def _same_plan(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, (np.ndarray, jax.Array)):
            b = np.asarray(b)
            assert np.asarray(a).dtype == b.dtype, f
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
        else:
            assert a == b, f


# --------------------------------------------------------------- planners
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_plan_row_shards_equals_jax(p, transpose):
    rng = np.random.default_rng(p)
    graphs = [(n, *_delaunay(rng, n)) for n in (16, 40, 64)]
    graphs.append((24, *_random_graph(rng, 24)))
    for n, s, d in graphs:
        got = tep.plan_row_shards(n, s, d, p, transpose=transpose)
        want = jep.plan_row_shards(n, s, d, p, transpose=transpose)
        _same_plan(got, want)
        assert tep.halo_fraction(got) == jep.halo_fraction(want)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_plan_batch_rows_equals_jax(p, transpose):
    rng = np.random.default_rng(10 + p)
    src, dst, _ = _padded(rng, 3, 64, 384, n_range=(40, 64))
    got = tep.plan_batch_rows(64, src, dst, p, transpose=transpose)
    want = jep.plan_batch_rows(64, src, dst, p, transpose=transpose)
    _same_plan(got, want)
    assert got.transpose == transpose and got.n_shards == p
    moved = got.to("cpu")
    assert all(torch.is_tensor(a) for a in moved)
    np.testing.assert_array_equal(t2n(moved.halo_gather), got.halo_gather)


def test_plan_of_the_wrong_orientation_raises():
    rng = np.random.default_rng(0)
    src, dst, _ = _padded(rng, 2, 16, 96)
    plan = tep.plan_batch_rows(16, src, dst, 2, transpose=False).to("cpu")
    X = torch.zeros((2, 16, 16, 1))
    with pytest.raises(ValueError, match="transpose"):
        tep.emulated_row_sharded_aggregate(
            X, torch.zeros(2, 16, 16), torch.zeros(2, 96, 8), plan,
            torch.zeros(2, 8, dtype=torch.int32),
            torch.zeros(2, 8, dtype=torch.int32))


# ------------------------------------------------------- the aggregate
def _agg_inputs(seed, B, N, C, e1=None):
    """Delaunay graph 1 of N - 4..N nodes, graph 2 of N/2..N/2+3 (both
    with padded slots), Ke zero on padded slots."""
    rng = np.random.default_rng(seed)
    e1 = e1 or 6 * N
    src1, dst1, m1 = _padded(rng, B, N, e1, n_range=(N - 4, N + 1))
    src2, dst2, m2 = _padded(rng, B, N, 3 * N + 12,
                             n_range=(N // 2, N // 2 + 4))
    e2 = src2.shape[1]
    Ke = rng.normal(size=(B, e1, e2)).astype(np.float32)
    Ke *= (m1[:, :, None] & m2[:, None, :])           # zero on padded slots
    return dict(X=rng.normal(size=(B, N, N, C)).astype(np.float32),
                Kp=rng.normal(size=(B, N, N)).astype(np.float32), Ke=Ke,
                src1=src1, dst1=dst1, src2=src2, dst2=dst2, m1=m1, m2=m2,
                W=rng.normal(size=(B, N, N, C)).astype(np.float32))


def _unsharded(a):
    """Y = K^T vec X (plain ops) and the gradients of sum(Y * W); dKe on
    the real edge pairs (the kernels' contract gives padded slots 0)."""
    X, Kp, Ke = (torch.tensor(a[k], requires_grad=True)
                 for k in ("X", "Kp", "Ke"))
    t = torch.as_tensor
    Y = assoc_matvec(X, Kp, Ke, t(a["src1"]), t(a["dst1"]), t(a["src2"]),
                     t(a["dst2"]), transpose=True)
    (Y * t(a["W"])).sum().backward()
    real = a["m1"][:, :, None] & a["m2"][:, None, :]
    return {"Y": t2n(Y), "dX": t2n(X.grad), "dKp": t2n(Kp.grad),
            "dKe": t2n(Ke.grad) * real}


def _close(got, want, tol=1e-5, what=""):
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * float(np.abs(w).max()), (what, k, err)


@pytest.mark.parametrize("N,C", [(16, 1), (16, 17), (48, 1), (48, 17)])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_emulated_aggregate_matches_unsharded(p, N, C):
    a = _agg_inputs(p * 100 + N + C, 2, N, C)
    X, Kp, Ke = (torch.tensor(a[k], requires_grad=True)
                 for k in ("X", "Kp", "Ke"))
    t = torch.as_tensor
    plan = tep.plan_batch_rows(N, a["src1"], a["dst1"], p).to("cpu")
    Y = tep.emulated_row_sharded_aggregate(
        X, Kp, Ke, plan, t(a["src2"]), t(a["dst2"]), e1_mask=t(a["m1"]),
        e2_mask=t(a["m2"]))
    (Y * t(a["W"])).sum().backward()
    got = {"Y": t2n(Y), "dX": t2n(X.grad), "dKp": t2n(Kp.grad),
           "dKe": t2n(Ke.grad)}
    _close(got, _unsharded(a), what=(p, N, C))


def test_emulated_aggregate_matches_jax_reference():
    """The sharded sum against JAX's host-loop reference of the same
    inputs (per pair; both orientations of the reference's E1 split)."""
    a = _agg_inputs(7, 2, 16, 5)
    t = torch.as_tensor
    for p in (2, 4):
        plan = tep.plan_batch_rows(16, a["src1"], a["dst1"], p).to("cpu")
        got = t2n(tep.emulated_row_sharded_aggregate(
            t(a["X"]), t(a["Kp"]), t(a["Ke"]), plan, t(a["src2"]),
            t(a["dst2"]), e1_mask=t(a["m1"]), e2_mask=t(a["m2"])))
        mine = t2n(tep.edge_partition_reference(
            t(a["X"]), t(a["Kp"]), t(a["Ke"]), t(a["src1"]), t(a["dst1"]),
            t(a["src2"]), t(a["dst2"]), p, transpose=True))
        for b in range(2):
            want = np.asarray(jep.edge_partition_reference(
                *(jnp.asarray(a[k][b]) for k in ("X", "Kp", "Ke", "src1",
                                                 "dst1", "src2", "dst2")),
                p, transpose=True))
            scale = float(np.abs(want).max())
            assert np.abs(got[b] - want).max() <= 1e-5 * scale
            assert np.abs(mine[b] - want).max() <= 1e-5 * scale


# ------------------------------------------------ the 4-process world
@pytest.fixture(scope="module")
def world():
    """Start the ranks, make their payload, then compute the references
    here while they run; returns (per-mesh results, references)."""
    ranks = World(mesh_checks, 4)
    jcfg = tiny_jax_config(n_max=16, sk_tau=0.05)
    batch = j_synth(jcfg, 4, n_range=(10, 14), image_hw=(32, 48), seed=3)
    batch = jax.tree_util.tree_map(np.asarray, batch)
    v = damp_afau_mixing(randomize_batch_stats(shared_init(jcfg)))
    tcfg = to_torch_config(jcfg)
    sd = {k: t2n(x) for k, x in from_flax_variables(v, tcfg).items()}
    agg = _agg_inputs(5, 4, 16, 5)
    op = _agg_inputs(6, 1, 16, 3)
    tb = _torch_batch(batch)

    def net():
        return build_model(tcfg, device="cpu",
                           state_dict={k: torch.as_tensor(x)
                                       for k, x in sd.items()})

    # the one-device train step first: the ranks replay its greedy picks
    ref = {"agg": _unsharded(agg)}
    model, picks = net(), []
    real = t_ngm.greedy_perm_batch
    t_ngm.greedy_perm_batch = lambda *a: picks.append(real(*a)) or picks[-1]
    try:
        stage = default_stages()[2]
        state = t_state.create_state(model, stage)
        _, m = t_step.make_train_step(model, stage)(state, tb)
    finally:
        t_ngm.greedy_perm_batch = real
    ref["metrics"] = {k: float(x) for k, x in m.items()}
    ref["grads"] = {n: t2n(q.grad) for n, q in model.named_parameters()
                    if q.grad is not None}
    ref["stats"] = {n: t2n(b) for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
    bcfg = dataclasses.replace(
        tcfg, backbone=dataclasses.replace(tcfg.backbone, dtype="bfloat16"),
        ngm=dataclasses.replace(tcfg.ngm, compute_dtype="bfloat16",
                                sk_tau=0.5))
    payload = dict(cfg=tcfg, state_dict=sd, batch=tuple(batch), agg=agg,
                   op=op, out_keys=OUT_KEYS, picks=t2n(picks[0]),
                   bf16_cfg=bcfg)
    ranks.send(payload)

    ref["fwd"] = {k: t2n(x) for k, x in net()(tb).items() if k in OUT_KEYS}
    ref["bf16"] = {k: t2n(x.float()) for k, x in build_model(
        bcfg, device="cpu", state_dict={k: torch.as_tensor(x) for k, x in
                                        sd.items()})(tb).items()
        if k in OUT_KEYS}
    jout = jax.jit(functools.partial(JNet(jcfg).apply, train=False))(
        v, batch)
    ref["jax_fwd"] = {k: np.asarray(jout[k]) for k in OUT_KEYS}
    t = torch.as_tensor
    ref["op"] = t2n(assoc_matvec(*(t(op[k]) for k in (
        "X", "Kp", "Ke", "src1", "dst1", "src2", "dst2")), transpose=True))
    results = ranks.collect(timeout=120)
    return {mesh: [r[mesh] for r in results] for mesh in MESHES}, ref


def _torch_batch(batch):
    from fpmatch_tpu_torch.models.ngm import PairBatch

    return PairBatch(*(None if a is None else np.asarray(a)
                       for a in batch)).to("cpu")


def _by_data(ranks, D, get):
    """`get(rank result)` of the ranks with e == 0 (one per data slice),
    concatenated in d order."""
    firsts = sorted((r for r in ranks if r["e"] == 0), key=lambda r: r["d"])
    assert len(firsts) == D
    return np.concatenate([get(r) for r in firsts])


def _edge_groups_agree(ranks, part):
    for r in ranks:
        lead = next(q for q in ranks if q["d"] == r["d"] and q["e"] == 0)
        for k, v in r[part].items():
            if isinstance(v, dict):
                for n, x in v.items():
                    np.testing.assert_array_equal(x, lead[part][k][n],
                                                  err_msg=f"{k}.{n}")
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, lead[part][k], err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gloo_aggregate_matches_one_process(world, mesh):
    ranks, ref = world[0][mesh], world[1]
    got = {k: _by_data(ranks, mesh[0], lambda r: r["agg"][k])
           for k in ref["agg"]}
    _close(got, ref["agg"], what=mesh)
    _edge_groups_agree(ranks, "agg")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gloo_model_forward_matches_port_and_jax(world, mesh):
    ranks, ref = world[0][mesh], world[1]
    got = {k: _by_data(ranks, mesh[0], lambda r: r["model"]["fwd"][k])
           for k in OUT_KEYS}
    for name in ("fwd", "jax_fwd"):
        want = ref[name]
        for k in ("ds_mat", "cls_prob", "k_prob", "raw_scores"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-2,
                                       atol=2e-3, err_msg=f"{name} {k}")
        flips = np.abs(got["perm_mat"] - want["perm_mat"]).sum()
        assert flips <= 0.005 * got["perm_mat"].size, (name, flips)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gloo_train_step_matches_one_device(world, mesh):
    ranks, ref = world[0][mesh], world[1]
    for r in ranks:
        m = r["model"]["metrics"]
        for k in ("loss", "total_loss"):
            np.testing.assert_allclose(m[k], ref["metrics"][k], rtol=2e-3,
                                       err_msg=k)
        got_g = r["model"]["grads"]
        assert set(got_g) == set(ref["grads"])
        for part in t_state.PARTITIONS:
            names = [n for n in ref["grads"]
                     if t_state.partition_of(n.split(".")[0]) == part
                     and not n.startswith(NOISE_BOUND)]
            if not names:
                continue
            a = np.concatenate([got_g[n].ravel() for n in names])
            b = np.concatenate([ref["grads"][n].ravel() for n in names])
            cos = float(a @ b) / float(np.linalg.norm(a) * np.linalg.norm(b))
            assert cos >= 0.9999, (mesh, part, cos)
        for n, s in r["model"]["stats"].items():
            np.testing.assert_allclose(s, ref["stats"][n], rtol=1e-5,
                                       atol=1e-5, err_msg=n)
    _edge_groups_agree(ranks, "model")


def test_gloo_op_level_forms(world):
    """v1 (E1 slices + all-reduce) and v2 (one pair's rows, one halo
    exchange) over a 1 x 4 edge group against the unsharded product."""
    ranks = sorted(world[0][(1, 4)], key=lambda r: r["e"])
    ref = world[1]
    want = ref["op"]
    scale = float(np.abs(want).max())
    for r in ranks:
        assert np.abs(r["op"]["v1"] - want).max() <= 1e-5 * scale
    v2 = np.concatenate([r["op"]["v2"] for r in ranks])[:want.shape[1]]
    assert np.abs(v2 - want[0]).max() <= 1e-5 * scale


def test_gloo_bf16_forward_matches_the_ports_bf16(world):
    """--bf16 under a 2 x 2 mesh against the port's one-device bf16 run
    (sk_tau 0.5, as test_torch_bf16's model tests), at test_torch_bf16's
    model bounds: 1e-4, the AFA-U output 1e-3, perm_mat up to the flips the
    f32 tests allow; every output finite."""
    ranks, ref = world[0][(2, 2)], world[1]
    got = {k: _by_data(ranks, 2, lambda r: r["bf16"][k]) for k in OUT_KEYS}
    _edge_groups_agree(ranks, "bf16")
    for k in OUT_KEYS:
        assert np.isfinite(got[k]).all(), k
    for k in ("ds_mat", "cls_prob", "k_prob", "raw_scores"):
        t = 1e-3 if k == "k_prob" else 1e-4
        np.testing.assert_allclose(got[k], ref["bf16"][k], rtol=t, atol=t,
                                   err_msg=k)
    flips = np.abs(got["perm_mat"] - ref["bf16"]["perm_mat"]).sum()
    assert flips <= 0.005 * got["perm_mat"].size, flips
