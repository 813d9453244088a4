"""Rank processes of the multi-process CPU tests (test_torch_parallel,
test_torch_cli_mesh). Spawned ranks import this module, so it imports only
torch, numpy and the port: no JAX (and not the JAX package's test
settings), which the parents compute their references with. It holds no
tests.

`World(target, world)` starts `world` processes joined in one gloo group,
which wait for `send(payload)` (so their start-up overlaps the caller's
work) and run `target(rank, world, payload)`; `collect()` returns the
ranks' results. A rank that raises, or a world that does not finish within
the timeout, fails the caller and ends every rank.
"""
import dataclasses
import datetime
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fpmatch_tpu_torch.core import config as tc


def tiny_widths(cfg: tc.Config) -> tc.Config:
    """A port Config at test_torch_utils.tiny_jax_config's widths (micro
    ResNet, 32-wide graph features, few Sinkhorn iterations); its shapes,
    data settings, dtypes, sk_tau and model options kept."""
    return dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(cfg.backbone, stem_channels=8,
                                     stage_channels=(8, 8, 16, 16),
                                     blocks_per_stage=1),
        ngm=dataclasses.replace(cfg.ngm, node_feature_dim=32,
                                global_state_dim=32, gnn_feat=(8, 8, 8),
                                sk_iter=4, sk_layer_iter=4,
                                topk_extra_iter=2, afa_reg_hidden=4))


def tiny_build_model(cfg, *a, **k):
    """`models.ngm.build_model` at tiny widths (a picklable model_factory
    for cli.train)."""
    from fpmatch_tpu_torch.models.ngm import build_model

    return build_model(tiny_widths(cfg), *a, **k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, target, inbox, results):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=90))
        out = target(rank, world, inbox.get(timeout=120))
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """`world` spawned ranks running `target(rank, world, payload)` in one
    gloo group once `send(payload)` is called; `collect()` waits for their
    results."""

    def __init__(self, target, world: int):
        ctx = mp.get_context("spawn")
        self.world = world
        self.inbox = ctx.Queue()
        self.results = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, world, port, target, self.inbox,
                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def send(self, payload) -> None:
        for _ in range(self.world):
            self.inbox.put(payload)

    def collect(self, timeout: float = 120.0):
        """The ranks' results in rank order; a rank that raised, or a world
        that does not finish in `timeout` seconds, raises here, and every
        rank is ended either way."""
        got = {}
        end = time.monotonic() + timeout
        try:
            while len(got) < self.world:
                try:
                    rank, err, out = self.results.get(
                        timeout=max(end - time.monotonic(), 0.1))
                except queue.Empty:
                    raise AssertionError(
                        f"the {self.world} ranks did not finish in "
                        f"{timeout} s ({sorted(got)} did)") from None
                if err is not None:
                    raise AssertionError(f"rank {rank} failed:\n{err}")
                got[rank] = out
        finally:
            for p in self.procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
        return [got[r] for r in range(self.world)]


# ------------------------------------------------- test_torch_parallel
MESHES = ((4, 1), (1, 4), (2, 2))


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


def _batch(fields):
    from fpmatch_tpu_torch.models.ngm import PairBatch

    return PairBatch(*(None if a is None else np.asarray(a) for a in fields))


def aggregate_case(grid, p):
    """row_sharded_aggregate of this rank's data slice of p["agg"]; the
    result and the gradients of sum(Y * W)."""
    from fpmatch_tpu_torch.parallel.edge_partition import (
        plan_batch_rows, row_sharded_aggregate)

    a = p["agg"]
    B = a["X"].shape[0]
    sl = slice(grid.d * B // grid.data, (grid.d + 1) * B // grid.data)
    X, Kp, Ke = (_t(a[k][sl]).requires_grad_() for k in ("X", "Kp", "Ke"))
    plan = plan_batch_rows(X.shape[1], a["src1"][sl], a["dst1"][sl],
                           grid.edge).to("cpu")
    Y = row_sharded_aggregate(X, Kp, Ke, plan, _t(a["src2"][sl]),
                              _t(a["dst2"][sl]), grid,
                              e1_mask=_t(a["m1"][sl]),
                              e2_mask=_t(a["m2"][sl]))
    (Y * _t(a["W"][sl])).sum().backward()
    return {k: t.detach().numpy() for k, t in
            (("Y", Y), ("dX", X.grad), ("dKp", Kp.grad), ("dKe", Ke.grad))}


def _model(p, grid, cfg=None):
    from fpmatch_tpu_torch.models.ngm import build_model

    sd = {k: torch.as_tensor(v) for k, v in p["state_dict"].items()}
    return build_model(cfg or p["cfg"], device="cpu", state_dict=sd,
                       grid=grid)


def _rank_batch(p, grid):
    from fpmatch_tpu_torch.parallel.edge_partition import plan_batch_rows
    from fpmatch_tpu_torch.parallel.mesh import shard_batch

    b = shard_batch(_batch(p["batch"]), grid)
    plan = plan_batch_rows(p["cfg"].shapes.n_max, b.src[:, 0], b.dst[:, 0],
                           grid.edge)
    return b._replace(row_plan=plan).to("cpu")


def model_case(grid, p):
    """This rank's forward outputs, then one stage-3 train step: its
    metrics, every parameter's gradient and new value, the BatchNorm
    statistics."""
    from fpmatch_tpu_torch.core.config import default_stages
    from fpmatch_tpu_torch.train import state as t_state
    from fpmatch_tpu_torch.train import step as t_step

    from fpmatch_tpu_torch.models import ngm as t_ngm
    from fpmatch_tpu_torch.parallel.mesh import rank_rows_of

    batch = _rank_batch(p, grid)
    net = _model(p, grid)
    fwd = {k: v.numpy() for k, v in net(batch).items()
           if k in p["out_keys"]}
    net = _model(p, grid)
    stage = default_stages()[2]
    state = t_state.create_state(net, stage)
    # the greedy fill ranks a near-uniform map, where ties at the 1e-6
    # level decide a pick: keep as many matches as the one-device step and
    # take its picks (as test_torch_train does with the JAX step's)
    picks = torch.as_tensor(p["picks"][rank_rows_of(len(p["picks"]),
                                                     grid)])
    real = t_ngm.greedy_perm_batch

    def same_ties(rank, ks, n1, n2):
        got = real(rank, ks, n1, n2)
        assert torch.equal(got.sum((1, 2)), picks.sum((1, 2)))
        return picks

    t_ngm.greedy_perm_batch = same_ties
    try:
        _, metrics = t_step.make_train_step(net, stage, grid)(state, batch)
    finally:
        t_ngm.greedy_perm_batch = real
    return {"fwd": fwd,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: q.grad.numpy().copy()
                      for n, q in net.named_parameters()
                      if q.grad is not None},
            "params": {n: q.detach().numpy().copy()
                       for n, q in net.named_parameters()},
            "stats": {n: b.numpy().copy() for n, b in net.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def bf16_case(grid, p):
    """This rank's forward outputs of the bf16 model (p["bf16_cfg"])."""
    net = _model(p, grid, p["bf16_cfg"])
    return {k: v.float().numpy() for k, v in net(_rank_batch(p, grid)).items()
            if k in p["out_keys"]}


def op_case(grid, p):
    """The op-level forms over the whole world as one edge group (1 x 4):
    v1 edge_sharded_matvec and v2 row_sharded_matvec of one pair."""
    from fpmatch_tpu_torch.parallel import edge_partition as ep

    o = p["op"]
    n = grid.edge
    Ke, s1, d1 = ep.shard_pair_for_edges(_t(o["Ke"]), _t(o["src1"]),
                                         _t(o["dst1"]), n, grid.e)
    v1 = ep.edge_sharded_matvec(_t(o["X"]), _t(o["Kp"]), Ke, s1, d1,
                                _t(o["src2"]), _t(o["dst2"]),
                                grid.edge_group, transpose=True)
    plan = ep.plan_row_shards(o["X"].shape[1], o["src1"][0], o["dst1"][0], n,
                              transpose=True)
    Xp, Kpp, KeL, KeH = ep.shard_rows(plan, o["X"][0], o["Kp"][0],
                                      o["Ke"][0])
    v2 = ep.row_sharded_matvec(plan, Xp[grid.e], Kpp[grid.e], KeL[grid.e],
                               KeH[grid.e], _t(o["src2"][0]),
                               _t(o["dst2"][0]), grid.edge_group)
    return {"v1": v1.numpy(), "v2": v2.numpy()}


def mesh_checks(rank, world, p):
    """Every check of test_torch_parallel's world, on each mesh of
    MESHES."""
    from fpmatch_tpu_torch.parallel.distributed import make_hybrid_mesh

    out = {}
    for D, E in MESHES:
        grid = make_hybrid_mesh(D, E)
        res = {"d": grid.d, "e": grid.e,
               "agg": aggregate_case(grid, p),
               "model": model_case(grid, p)}
        if (D, E) == (1, 4):
            res["op"] = op_case(grid, p)
        if (D, E) == (2, 2):
            res["bf16"] = bf16_case(grid, p)
        out[(D, E)] = res
    return out
