"""The row-sharded association matvec against one device, at fixed total
work: what the halo exchange moves and whether it overlaps the local
contraction.

    python -m fpmatch_tpu_torch.scripts.bench_edge_partition [--device cuda]
        [--reps 7]

One pair, n1 = n2 = 512 points uniform on [0, 400] x [0, 300] (seed 0),
graph 1 sorted by x (the spatially coherent row order that keeps the halo a
thin boundary), Delaunay edges, random X (n, n, C), Kp, Ke; K^T vec X
(`transpose=True`, the model's orientation), C = 16 (`run` takes other
sizes from Python callers).

  * one device: `ops.assoc.assoc_matvec_auto` (K3 on a CUDA tensor from
    E1 E2 >= 1 M association edges; n = 512 has some 9 M);
  * p = 2, 4, 8 row shards (`parallel.edge_partition`): over p real ranks,
    one card each (`row_sharded_matvec`, one halo all_to_all over NCCL),
    where p cards are visible; otherwise the p ranks emulated in this
    process (`emulated_row_sharded_aggregate`: the exchange an index copy
    of the stacked packs, the ranks one after another). `mode` says which
    ran. Per p: the median ms of the sharded call and of each rank's part,
    the halo fraction against full replication, the halo rows and bytes
    per layer, the error against the one-device result (relative to its
    range), and the overlap proxy: the full call against the same call
    with a zero halo (the halo edges' Ke rows zeroed: the same work) plus
    the exchange alone; full < local + exchange means the
    exchange overlaps the local contraction.
    In the emulated mode nothing runs concurrently: there the proxy can
    only read the noise of the two sides.

Times: the host clock around calls that end in `torch.cuda.synchronize()`
(after one warm-up call), median of `--reps`. Each timed call is followed
by ten calls under torch.profiler (`launches`: the wrappers' K1 / K2 / K3 /
K6 counts beside the profiler's). On `--device cpu` the times are the
CPU's and the device numbers null. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from .. import resolve_device
from ..core.build_graphs import build_edges
from ..ops.assoc import assoc_matvec_auto
from ..parallel import distributed as pdist
from ..parallel import edge_partition as ep
from ..utils.profiling import synchronize, time_fn
from . import _measure

SEED = 0
SHARDS = (2, 4, 8)
# a real-rank case's limit (its collectives time out after
# `parallel.distributed.DEFAULT_TIMEOUT_S`)
RANKS_TIMEOUT_S = 600


def make_inputs(n: int, c: int, seed: int = SEED):
    """Host arrays of the pair: X (n, n, c), Kp (n, n), Ke (E1, E2), the
    edge lists (graph 1 sorted by x)."""
    rng = np.random.default_rng(seed)
    pts1 = rng.uniform(size=(n, 2)).astype(np.float32) * [400, 300]
    pts2 = rng.uniform(size=(n, 2)).astype(np.float32) * [400, 300]
    pts1 = pts1[np.argsort(pts1[:, 0])]
    _, s1, d1 = build_edges(pts1.astype(np.float32), stg="tri")
    _, s2, d2 = build_edges(pts2.astype(np.float32), stg="tri")
    X = rng.normal(size=(n, n, c)).astype(np.float32)
    Kp = rng.normal(size=(n, n)).astype(np.float32)
    Ke = rng.normal(size=(len(s1), len(s2))).astype(np.float32)
    return X, Kp, Ke, s1, d1, s2, d2


def median_ms(fn: Callable, device, reps: int) -> float:
    return time_fn(fn, iters=reps, warmup=1, device=device) * 1e3


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.abs().max()), 1e-30)


def launches(fn: Callable, device) -> Dict:
    """The launches of `_measure.LAUNCH_CHECK_CALLS` calls of `fn`, by the
    wrappers and by torch.profiler (with its count of device events)."""
    row = _measure.profiled(fn, device, _measure.LAUNCH_CHECK_CALLS)
    return {"calls": row["profiled_steps"],
            "wrappers": row["wrapper_launches"],
            "profiler": row["profiler_launches"],
            "device_events": row["launches"]}


def emulated_case(p: int, t, device, reps: int) -> Dict:
    """p ranks in this process. `t`: the batched device tensors (B = 1)."""
    X, Kp, Ke, s1, d1, s2, d2 = t
    n = X.shape[1]
    hplan = ep.plan_batch_rows(n, s1.cpu().numpy(), d1.cpu().numpy(), p,
                               transpose=True)
    plan = hplan.to(device)
    # every graph-1 edge is one rank's local or halo edge: zeroing the Ke
    # rows of the halo edges leaves the same work with a zero halo
    halo = np.unique(hplan.halo_ke_row)
    Ke0 = Ke.clone()
    Ke0[:, torch.as_tensor(halo[halo < Ke.shape[1]], device=device)] = 0
    rank_ms = {q: [] for q in range(p)}

    def on_rank(q, fn):
        synchronize(device)
        t0 = time.perf_counter()
        y = fn()
        synchronize(device)
        rank_ms[q].append((time.perf_counter() - t0) * 1e3)
        return y

    def call(ke=Ke, on=None):
        return ep.emulated_row_sharded_aggregate(X, Kp, ke, plan, s2, d2,
                                                 transpose=True, on_rank=on)

    def exchange_only():
        R = n // p
        ranks = [ep.rank_rows(plan, q) for q in range(p)]
        packs = torch.stack([ep.pack_halo(X[:, q * R:(q + 1) * R], ranks[q])
                             for q in range(p)])
        return packs.transpose(0, 1).contiguous()

    with torch.no_grad():
        y = call()
        full = median_ms(call, device, reps)
        median_ms(lambda: call(on=on_rank), device, reps)
        row = {"mode": "emulated", "sharded_ms": full,
               "rank_ms": [float(np.median(rank_ms[q])) for q in range(p)],
               "overlap_proxy": {
                   "t_full_ms": full,
                   "t_exchange_only_ms": median_ms(exchange_only, device,
                                                   reps),
                   "t_local_plus_zero_halo_ms": median_ms(
                       lambda: call(Ke0), device, reps)},
               "launches": launches(call, device)}
    row["halo_fraction_vs_replication"] = ep.halo_fraction(hplan)
    row["halo_rows_per_layer"] = int(hplan.send_mask.sum())
    return row, y


def _rank_main(rank: int, p: int, init_method: str, device_type: str,
               n: int, c: int, reps: int, out_dir: str) -> None:
    """One real rank of `ranks_case` (spawned): the pair made from the
    seed, this rank's rows, the row-sharded matvec timed with the
    exchange alone and with a zero halo; rank 0 writes its row and every
    rank's rows of the result into `out_dir`."""
    import torch.distributed as dist

    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    pdist.initialize(device, init_method, p, rank)
    try:
        X, Kp, Ke, s1, d1, s2, d2 = make_inputs(n, c)
        plan = ep.plan_row_shards(n, s1, d1, p, transpose=True)
        Xp, Kpp, KeL, KeH = ep.shard_rows(plan, X, Kp, Ke, device=device)
        s2t = torch.as_tensor(s2, device=device)
        d2t = torch.as_tensor(d2, device=device)
        q = rank
        KeH0 = torch.zeros_like(KeH[q])

        def call(keh=KeH[q]):
            return ep.row_sharded_matvec(plan, Xp[q], Kpp[q], KeL[q], keh,
                                         s2t, d2t, None)

        def exchange_only():
            rows = ep.RankRows(*(torch.as_tensor(a[q], device=device)[None]
                                 for a in (plan.send_idx, plan.send_mask,
                                           plan.loc_gather, plan.loc_scatter,
                                           plan.loc_ke_row, plan.halo_gather,
                                           plan.halo_scatter,
                                           plan.halo_ke_row)))
            pack = ep.pack_halo(Xp[q][None], rows).contiguous()
            recv = torch.empty_like(pack)
            dist.all_to_all_single(recv, pack)
            return recv

        def timed(fn):
            dist.barrier()
            return median_ms(fn, device, reps)

        with torch.no_grad():
            y = call()
            row = {"mode": "ranks", "sharded_ms": timed(call),
                   "overlap_proxy": {
                       "t_exchange_only_ms": timed(exchange_only),
                       "t_local_plus_zero_halo_ms": timed(
                           lambda: call(KeH0))},
                   "launches": launches(call, device)}
            row["overlap_proxy"]["t_full_ms"] = row["sharded_ms"]
            ms = torch.tensor([row["sharded_ms"]], device=device)
            all_ms = [torch.zeros_like(ms) for _ in range(p)]
            dist.all_gather(all_ms, ms)
            parts = [torch.zeros_like(y) for _ in range(p)]
            dist.all_gather(parts, y.contiguous())
        if rank == 0:
            row["rank_ms"] = [float(m) for m in all_ms]
            row["halo_fraction_vs_replication"] = ep.halo_fraction(plan)
            row["halo_rows_per_layer"] = int(plan.send_mask.sum())
            np.save(os.path.join(out_dir, "y.npy"),
                    torch.cat(parts)[:n].cpu().numpy())
            with open(os.path.join(out_dir, "row.json"), "w") as f:
                json.dump(row, f)
    finally:
        dist.destroy_process_group()


def ranks_case(p: int, device_type: str, n: int, c: int, reps: int):
    """p real ranks, spawned, joined over a free local port (NCCL with one
    card each on `cuda`, gloo on the CPU). Returns rank 0's row and the
    gathered result rows (numpy). Rank 0 writes them to a temporary
    directory: through a pipe, n * n * c floats would fill its buffer
    before the parent reads. Ranks still running after `RANKS_TIMEOUT_S`
    are killed and the call raises."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="edge_partition_") as tmp:
        ranks = mp.start_processes(
            _rank_main, args=(p, f"tcp://127.0.0.1:{port}", device_type, n,
                              c, reps, tmp),
            nprocs=p, join=False, start_method="spawn")
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while not ranks.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ranks.processes:
                    proc.kill()
                raise TimeoutError(f"{p} ranks ran over {RANKS_TIMEOUT_S} s")
        with open(os.path.join(tmp, "row.json")) as f:
            row = json.load(f)
        return row, np.load(os.path.join(tmp, "y.npy"))


def run(device="cuda", n: int = 512, c: int = 16, reps: int = 7) -> Dict:
    if n % max(SHARDS):
        raise ValueError(f"n = {n} must be divisible by {max(SHARDS)}")
    device = resolve_device(device)
    X, Kp, Ke, s1, d1, s2, d2 = make_inputs(n, c)
    e1, e2 = len(s1), len(s2)
    nnz = e1 * e2 + n * n
    t = tuple(torch.as_tensor(a, device=device)[None]
              for a in (X, Kp, Ke, s1, d1, s2, d2))
    Xt, Kpt, Ket, s1t, d1t, s2t, d2t = t

    def single():
        return assoc_matvec_auto(Xt, Kpt, Ket, s1t, d1t, s2t, d2t,
                                 transpose=True)

    with torch.no_grad():
        want = single()
        single_ms = median_ms(single, device, reps)
        out = {"n": n, "c": c, "e1": e1, "e2": e2, "assoc_edges": nnz,
               "device": device.type, "card": _measure.card(device),
               "single_device_ms": single_ms,
               "single_device_edges_per_s": nnz / single_ms * 1e3,
               "single_device_launches": launches(single, device)}
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    for p in SHARDS:
        if cards >= p:
            row, y = ranks_case(p, "cuda", n, c, reps)
            y = torch.as_tensor(y, device=device)
        else:
            row, y = emulated_case(p, t, device, reps)
            y = y[0]
        row["edges_per_s"] = nnz / row["sharded_ms"] * 1e3
        row["halo_bytes_per_layer"] = row["halo_rows_per_layer"] * n * c * 4
        row["efficiency_vs_1dev"] = single_ms / row["sharded_ms"]
        row["max_rel_err_vs_single"] = relerr(y, want[0])
        o = row["overlap_proxy"]
        o["overlap_evidence"] = bool(
            o["t_full_ms"] < o["t_local_plus_zero_halo_ms"]
            + o["t_exchange_only_ms"])
        out[f"p{p}"] = row
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=7)
    return ap


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    out = run(args.device, reps=args.reps)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
