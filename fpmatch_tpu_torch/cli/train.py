"""Training CLI: the 6-stage curriculum (`train.loop.run_curriculum`) on one
device, the counterpart of the JAX package's `cli/train.py`.

Same flags, plus `--device` (default `cuda`; `cuda` without a GPU is an
error, never a silent CPU run). On a CUDA device the association matvec of
the three GNN layers runs through the CUDA kernels (K2 / K3) forward and
backward, and its edge / diagonal gradient through `kernels.assoc_grad` (K6);
in the k-only and cls-only stages 2, 4 and 6 no backward reaches them.
`--smoke` generates a tiny synthetic dataset and runs one epoch of stages 1
and 6 (n_max 32, e_max 192, batches of 4), as the JAX CLI's does.

`--bf16` is the JAX CLI's mixed precision (bf16 backbone convolutions and
graph-side hot path, f32 parameters, optimizer state and losses; the
backward of the association matvec on bf16 features runs through K2 / K3
and K6 too). `--hyperedge` trains the third-order triangle term (batches
carry each view's Delaunay triangles) and `--cls-k-features` the
classifier's k statistics. The JAX CLI's `warn_if_degraded_dispatch`
probes the TPU runtime and has no counterpart here.

`--mesh DxE` (or `--n-devices N`, i.e. `--mesh Nx1`) trains on D x E ranks,
one process each (`parallel/`): D data ranks each take a slice of every
batch, and the E edge ranks of a data slice row-shard the three
association-GNN layers (one halo all_to_all per layer). NCCL on `cuda` (one
card per rank), gloo on `--device cpu`. The refusals are the JAX CLI's: a
batch size not divisible by D, `--n-max` not divisible by E, more ranks
than cards on `cuda`; `1x1` / `--n-devices 1` is the one-device run. One
command starts the ranks itself (spawned processes on this host, joined
over a free local port) or, started by torchrun (WORLD_SIZE = D E), joins
them. Under a mesh the loaders use thread workers (no worker processes
inside the rank processes), every rank loads only its slice's pairs, rank 0
alone logs, writes the checkpoints (a one-device model's state_dict) and
runs the test evaluation, and the other ranks wait at a barrier.

Usage:
  python -m fpmatch_tpu_torch.cli.train --data-root dataset/Synthetic \\
      --stages 1,2,3,4,5,6 --epochs 10
  python -m fpmatch_tpu_torch.cli.train --mesh 2x2 ...   # 4 cards
  torchrun --nproc-per-node 4 -m fpmatch_tpu_torch.cli.train --mesh 2x2 ...
  python -m fpmatch_tpu_torch.cli.train --smoke          # on the GPU
  python -m fpmatch_tpu_torch.cli.train --smoke --device cpu --thread-workers
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

import numpy as np


def build_loaders(cfg, data_root: str, dataset_name: str, device, length=None,
                  test_length=None, grid=None):
    """train: augmented, shuffled; val: deterministic and cached (it is
    re-iterated every epoch); test: a seeded subsample for the periodic
    in-training evaluation. Batches arrive on `device` (prefetched on a
    side stream on a CUDA device). Under a rank grid the train and val
    loaders yield this rank's slice of each batch, with the row plan of
    the grid's edge axis when it has more than one rank, and only rank 0
    gets a test loader (whole batches, no plan)."""
    from ..data.benchmark import make_benchmark
    from ..data.pipeline import DataLoader, PairDataset

    shard = hook = None
    if grid is not None:
        shard = (grid.d, grid.data)
        if grid.edge > 1:
            from ..parallel.edge_partition import plan_batch_rows

            def hook(b, _p=grid.edge, _n=cfg.shapes.n_max):
                return b._replace(row_plan=plan_batch_rows(
                    _n, b.src[:, 0], b.dst[:, 0], _p, transpose=True))

    loaders = {}
    for sets in ("train", "val", "test"):
        if sets == "test" and grid is not None and grid.rank != 0:
            loaders[sets] = None
            continue
        bench = make_benchmark(dataset_name, sets, root=data_root,
                               task="classify")
        pd = PairDataset(bench, cfg, length=length)
        if sets == "test" and test_length and len(pd.pairs) > test_length:
            keep = np.random.default_rng(0).choice(
                len(pd.pairs), size=test_length, replace=False)
            pd.pairs = [pd.pairs[i] for i in sorted(keep)]
        part = sets != "test"
        loaders[sets] = DataLoader(pd, cfg, shuffle=(sets == "train"),
                                   drop_last=True, cache=(sets != "train"),
                                   device=device, device_prefetch=True,
                                   shard=shard if part else None,
                                   host_batch_hook=hook if part else None)
    return loaders


def parse_mesh_spec(mesh_arg: str, n_devices: int):
    """'dp' -> (n_devices, 1) with 0/1 = one device and -1 = every visible
    card; 'DxE' -> (D, E) data x edge."""
    if "x" in mesh_arg:
        d_data, d_edge = (int(v) for v in mesh_arg.lower().split("x"))
        return d_data, d_edge
    if mesh_arg != "dp":
        raise ValueError(f"--mesh must be 'dp' or 'DxE', got {mesh_arg!r}")
    if n_devices < 0:
        import torch

        return max(torch.cuda.device_count(), 1), 1
    return max(n_devices, 1), 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the NGM matcher")
    ap.add_argument("--data-root", default="dataset/Synthetic")
    ap.add_argument("--dataset", default="Synthetic",
                    choices=["Synthetic", "L3SFV2Augmented", "PolyUDBII",
                             "PolyUDBI", "L3SF"])
    ap.add_argument("--stages", default="1,2,3,4,5,6",
                    help="comma-separated stage numbers to run")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override epochs per stage")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--length", type=int, default=None,
                    help="cap training pairs per epoch")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--log-dir", default=None,
                    help="write per-epoch metrics to <dir>/metrics.jsonl "
                         "(+ TensorBoard event files where available)")
    ap.add_argument("--init-from", default=None,
                    help="dir:name of a checkpoint to warm-start weights "
                         "from (e.g. checkpoints/run1:stage6_last)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--e-max", type=int, default=384)
    ap.add_argument("--univ", type=int, default=600)
    ap.add_argument("--node-taps", default="layer3",
                    help="comma-separated backbone node taps, e.g. "
                         "layer2,layer3 for stride-8+16 features")
    ap.add_argument("--passes", type=int, default=3,
                    help="loader passes per epoch")
    ap.add_argument("--numbered-checkpoints", action="store_true",
                    help="also save a numbered per-epoch snapshot")
    ap.add_argument("--smoke", action="store_true",
                    help="generate a tiny synthetic dataset and run 1 epoch "
                         "of stages 1+6 end-to-end")
    ap.add_argument("--test-length", type=int, default=1024,
                    help="seeded test-pair subsample for the periodic "
                         "in-training eval (full protocol: cli/evaluate.py)")
    ap.add_argument("--thread-workers", action="store_true",
                    help="use thread workers instead of worker processes")
    ap.add_argument("--n-devices", type=int, default=0,
                    help="train data-parallel over this many ranks (0/1 = "
                         "one device, the default; -1 = every visible "
                         "card). Equivalent to --mesh Nx1")
    ap.add_argument("--mesh", default="dp",
                    help="mesh spec: 'dp' (data ranks of --n-devices) or "
                         "'DxE' for data x edge ranks, e.g. 2x4: the 3 "
                         "assoc-GNN layers row-shard over the E edge ranks "
                         "(requires n-max divisible by E)")
    ap.add_argument("--cls-k-features", action="store_true",
                    help="feed the k statistics (k, matched fraction, "
                         "mean matched score) to the match classifier")
    ap.add_argument("--hyperedge", action="store_true",
                    help="enable the third-order (triangle hyperedge) "
                         "association term")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute in the backbone and the graph-side "
                         "hot path (params stay f32: f32 checkpoints load "
                         "unchanged)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to run on "
                         "the CPU)")
    return ap


def configure(args, log):
    """The model Config and the curriculum's stages from the flags (with
    `--smoke`, after writing its dataset and pointing `args` at it)."""
    from ..core.config import Config, ShapeConfig, default_stages
    from . import TAP_CHANNELS

    cfg = Config(shapes=ShapeConfig(n_max=args.n_max, e_max=args.e_max,
                                    univ_size=args.univ))
    taps = tuple(args.node_taps.split(","))
    if taps != ("layer3",):
        feat = sum(TAP_CHANNELS[t] for t in taps) + 512
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, node_taps=taps),
            ngm=dataclasses.replace(cfg.ngm, node_feature_dim=feat))
    if args.cls_k_features:
        cfg = dataclasses.replace(
            cfg, ngm=dataclasses.replace(cfg.ngm, cls_k_features=True))
    if args.hyperedge:
        cfg = dataclasses.replace(
            cfg, ngm=dataclasses.replace(cfg.ngm, hyperedge=True))
    if args.bf16:
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"),
            ngm=dataclasses.replace(cfg.ngm, compute_dtype="bfloat16"))
    if args.batch_size:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          batch_size=args.batch_size))
    # fingerprint scans are grayscale: ship luma only
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, image_channels=1,
            worker_processes=not args.thread_workers))

    if args.smoke:
        import tempfile

        from ..data.generator import generate_synthetic_dataset
        root = tempfile.mkdtemp(prefix="fpm_smoke_") + "/Synthetic"
        generate_synthetic_dataset(root, fingers_per_split=(6, 3, 2),
                                   n_pores=60, seed=0, size=(320, 280))
        args.data_root = root
        if args.checkpoint_dir == "checkpoints":  # default: keep smoke out
            args.checkpoint_dir = root + "-ckpt"
        args.length = 8
        args.epochs = 1
        args.passes = 1
        args.stages = "1,6"
        cfg = dataclasses.replace(
            cfg, shapes=ShapeConfig(n_max=32, e_max=192, t_max=96,
                                    univ_size=64),
            data=dataclasses.replace(cfg.data, batch_size=4, num_workers=2))
        log(f"smoke dataset at {root}")

    stages = []
    for num in (int(s) for s in args.stages.split(",")):
        st = default_stages()[num - 1]
        if args.epochs:
            st = dataclasses.replace(st, num_epochs=args.epochs)
        stages.append(st)
    return cfg, stages


def _log():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s", stream=sys.stdout)
    return logging.getLogger("fpmatch_tpu_torch.cli").info


def main(argv=None, on_stage_end=None, model_factory=None):
    """Run the curriculum from the flags; returns the final test report
    (rank 0's under a mesh; None on the other ranks under torchrun).

    Python callers only: `on_stage_end(stage, history)` is called after
    each stage (on rank 0); `model_factory` replaces
    `models.ngm.build_model` (same arguments; under a spawned mesh it must
    be picklable). A collective of a mesh run that waits longer than
    `parallel.distributed.DEFAULT_TIMEOUT_S` fails its rank, and a rank
    that fails ends the others."""
    args = build_parser().parse_args(argv)

    from .. import resolve_device

    d_data, d_edge = parse_mesh_spec(args.mesh, args.n_devices)
    world = d_data * d_edge
    if world > 1 and args.device.startswith("cuda"):
        import torch

        avail = torch.cuda.device_count()
        if world > avail:
            raise SystemExit(f"--mesh {d_data}x{d_edge} needs {world} "
                             f"devices, only {avail} visible")
    device = resolve_device(args.device)    # fail before any work without a GPU

    log = _log()
    cfg, stages = configure(args, log)
    if world == 1:
        return _train(args, cfg, stages, device, None, log, on_stage_end,
                      model_factory)

    if cfg.data.batch_size % d_data:
        raise SystemExit(f"batch size {cfg.data.batch_size} not divisible "
                         f"by data axis {d_data}")
    if d_edge > 1 and cfg.shapes.n_max % d_edge:
        raise SystemExit(f"--n-max {cfg.shapes.n_max} not divisible by "
                         f"edge axis {d_edge}")
    # worker processes inside the rank processes would multiply the
    # interpreters on the host: the ranks load with threads
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, worker_processes=False))
    job = (args, cfg, stages, d_data, d_edge, on_stage_end, model_factory)
    launched = int(os.environ.get("WORLD_SIZE", "1"))
    if launched > 1:                                    # under torchrun
        if launched != world:
            raise SystemExit(f"--mesh {d_data}x{d_edge} needs {world} "
                             f"ranks, torchrun started {launched}")
        return _rank(int(os.environ["RANK"]), None, None, job)

    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    results = mp.get_context("spawn").SimpleQueue()
    log(f"mesh: data={d_data} x edge={d_edge}: spawning {world} ranks")
    mp.spawn(_rank, args=(f"tcp://127.0.0.1:{port}", results, job),
             nprocs=world, join=True)
    return results.get()


def _rank(rank: int, init_method, results, job):
    """One rank of a mesh run: join the process group, train, return (or
    put in `results`) rank 0's report."""
    import torch
    import torch.distributed as dist

    from ..parallel.distributed import initialize, local_rank, \
        make_hybrid_mesh

    args, cfg, stages, d_data, d_edge, on_stage_end, model_factory = job
    device = torch.device(args.device)
    if device.type == "cuda":
        lr = rank if init_method is not None else local_rank()
        device = torch.device("cuda", lr)
        torch.cuda.set_device(device)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // (d_data * d_edge)))
    initialize(device, init_method, d_data * d_edge, rank)
    try:
        grid = make_hybrid_mesh(d_data, d_edge)
        log = _log() if rank == 0 else (lambda *a: None)
        log(f"mesh: data={d_data} x edge={d_edge}, rank {rank} on {device}")
        report = _train(args, cfg, stages, device, grid, log,
                        on_stage_end if rank == 0 else None, model_factory)
    finally:
        dist.destroy_process_group()
    if results is not None and rank == 0:
        results.put(report)
    return report


def _train(args, cfg, stages, device, grid, log, on_stage_end,
           model_factory):
    """Build the loaders and the model, run the curriculum and the final
    test evaluation (rank 0 alone under a grid)."""
    from ..models import ngm
    from ..train.loop import evaluate_verification, run_curriculum

    loaders = build_loaders(cfg, args.data_root, args.dataset, device,
                            length=args.length, test_length=args.test_length,
                            grid=grid)
    log("initializing model…")
    build = model_factory or ngm.build_model
    model = build(cfg, device=device, seed=args.seed,
                  **({} if grid is None else {"grid": grid}))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model ready: {n_params / 1e6:.1f}M params on {device}")
    if args.init_from:
        from ..train.checkpoints import restore_params, warm_start
        ckpt_dir, _, name = args.init_from.partition(":")
        sd, kept = warm_start(model.state_dict(),
                              restore_params(ckpt_dir, name or "stage6_last"))
        model.load_state_dict(sd)
        log(f"warm-started from {args.init_from}: {kept}/{len(sd)} tensors "
            f"restored (shape-mismatched tensors keep their fresh init)")
    if grid is not None:
        from ..parallel.mesh import replicate_state
        replicate_state(model)

    metrics_logger = None
    if args.log_dir and (grid is None or grid.rank == 0):
        from ..utils.logging import MetricsLogger
        metrics_logger = MetricsLogger(args.log_dir)
        log(f"metrics -> {args.log_dir}/metrics.jsonl")
    report = None
    try:
        run_curriculum(model, stages, loaders["train"], loaders["val"],
                       test_loader=loaders["test"],
                       checkpoint_dir=args.checkpoint_dir,
                       passes_per_epoch=args.passes, log_fn=log,
                       metrics_logger=metrics_logger,
                       numbered_checkpoints=args.numbered_checkpoints,
                       on_stage_end=on_stage_end, grid=grid)
        if loaders["test"] is not None:
            report = evaluate_verification(model, stages[-1],
                                           loaders["test"])
        if grid is not None:
            import torch.distributed as dist
            dist.barrier()
    finally:
        if metrics_logger is not None:
            metrics_logger.close()
        for loader in loaders.values():
            if loader is not None:
                loader.close()
    if report is not None:
        log(f"final test report: "
            f"{ {k: round(v, 4) for k, v in report.items()} }")
    return report


if __name__ == "__main__":
    main()
