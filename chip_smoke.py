#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, evaluation and training paths on
one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc
    python3 chip_smoke.py --profile  # + torch.profiler tables of one request,
                                     #   one evaluate batch and one train step
    python3 chip_smoke.py --parent DIR
        # + K2 and K6 timed beside an unpacked checkout of another commit
        #   (scripts/time_assoc_grad.py on both trees in turns): `ms_parent`
        #   beside `ms_this_tree`, the medians of the same turns
    python3 chip_smoke.py --only-sinkhorn
        # phases 1, 2 and 35 only, and the Sinkhorn kernels' JSON line

Phases (each prints its own lines; any failure exits non-zero):

  1. device   card name + power limit, torch / CUDA / nvcc versions
  2. build    every kernel source under fpmatch_tpu_torch/kernels/csrc/,
              then kernels.inoculate: x + 1 launched in every library (first
              and second launch timed, checked bit for bit); the kernel,
              the plain x + 1 and the library torch.add(x, 1) timed by CUDA
              events
  3. kernels  assoc_univ_v3 (CUDA) against its plain PyTorch version and
              against the plain ops of ops.assoc (no plan) on the card, at
              the serving shapes and at shapes that take the launcher's
              other paths (C=32, C=33, a 700-column row); bf16 X to 1e-5 of
              the range too, a limit that refuses all-f32 Ke;
              assoc_bucket and assoc_large (CUDA) against theirs at B=8 /
              N=64 / E=384 and B=2 / N=256 / E=1536 (C=1 / 17, both
              orientations), B=1 / N=600 / E=3840, C=33 (two channel
              slices), C=16 (padded staged nodes), multi-edge lists without
              masks and a 1 x 4 x 4096 x 17 row, so every path of
              assoc_large's launcher (bf16 X the same way, refusing f32
              products; assoc_large's timed rows carry assoc_bucket's time
              on the same inputs and its own per block_c); assoc_univ
              (CUDA, one launch per call) against its
              plain version and against assoc_univ_v3 on n=600 Delaunay
              pairs at r1=32, r2=128 (C=16; C=1 / 17, both orientations; f32
              "highest" / "default" and bf16 X), a spill-heavy random graph
              and a degree-80 star (both kernels); two launches
              bit-identical; times by CUDA events (assoc_univ_v3 also by
              torch.profiler), each timed case also timing the library call
              for the same function (torch.sparse.mm of K built as one CSR
              matrix; its bf16 call tried) and the bound with X read in
              bf16
  4. serve    UNIV route (n_max=600, e_max=3840, univ=600) at full model
              width, a few requests through cli.match.match_arrays
  5. parity   one UNIV request against the port's own CPU run (plain kernel
              version), TF32 off
  6. serve    bucket route (n_max=64, e_max=384), 3 requests
  7. evaluate a synthetic test split written to a temporary directory, then
              cli.evaluate.evaluate_loader at full width over batches of 8
              (n_max=64, e_max=384) through the prefetching loader
  8. parity   the prefetched batches against unprefetched ones (bit for
              bit), one evaluate batch against the port's own CPU run
  9. evaluate the same function over batches of 2 at n_max=256, e_max=1536,
              where the aggregations go through assoc_large
 10. tune     scripts.tune_univ's sweep, in this process: inoculate, then all
              12 (block size, precision) rows of assoc_univ at n=600, C=16,
              each held against the plain version and checked bit-identical
              over two calls, no assoc_bucket / assoc_large launched; its
              times are K4's in the kernels line
 11. detect   the trained pore detector (net17nomax) on two generator
              impressions and the eight PolyU fixture images: with TF32 off
              the card's coordinates equal the port's CPU run and the map is
              within 1e-5; the detections TF32 changes (moved by one
              pixel, gained, lost); forward ms (CUDA
              events), host NMS ms, candidates; Lemes / compact DPF host
              seconds; the fixture F-score
 12. serve    bare images (no keypoint files) through cli.match's read_pair
              + match_arrays: 2 UNIV requests with the DPF detector, 2
              bucket requests with the CNN, wall time split into detection
              and matching; then cli.match.main itself on one pair
 13. hungarian --discretize hungarian: 2 UNIV and 2 bucket requests (both
              passes on the route: 6 launches per request), each match a
              cell of the LAPJV mask, the parts timed (first pass, host
              LAPJV, masked second pass); one request of each route
              against the CPU
 14. evaluate evaluate_loader with discretize="hungarian" over the 70-pair
              split, one batch against the CPU run
 15. backward assoc_grad (K6, the edge / diagonal gradient) against its plain
              version at B=8 / N=64 / E=384, C=1 / 17, both orientations,
              and B=2 / N=256 / E=1536 (bit-identical over two launches);
              dX through K2 / K3 with the roles swapped against the plain
              transposed product; the ops.assoc Function's gradients against
              torch.autograd of the plain forward (all within 1e-5 of the
              range); K6 at C=33 (two passes) and C=64 at N=256 (global
              memory) too, so every path of its launcher runs; K6 and the
              dX launch timed beside their plain versions, bounds and
              library calls
 16. train    one train step of stage 1 and then of stage 2 at full width,
              B=2, on the card and on the port's CPU path, TF32 off: loss
              terms, every gradient, BatchNorm statistics, frozen tensors
              bit for bit (limits in `phase_train_parity`); for stage 1 the
              gradient at the backbone's taps and at each of its layers,
              card against CPU, and the same step with cuDNN's
              deterministic algorithms (reported)
 17. train    python -m fpmatch_tpu_torch.cli.train's `main` at full width
              (n_max 64, e_max 384, B=8) through stages 1-6 on a synthetic
              split written here, 4 steps a stage; per stage step ms,
              pairs/s, losses, K2 forward / backward and K6 launches (K6 and
              the K2 backward in stages 1, 3, 5 only); the checkpoints load
              back; then `--smoke` once
 18. bf16 bwd K6 on bf16 X and the K2 / K3 dX launch on bf16(dY) against
              their plain versions at B=8 / N=64 / E=384 (C=1 / 17, both
              orientations) and B=2 / N=256 (one bf16 ulp of each rounded
              entry, 1e-5 of the range for the f32 sums; bit-identical over
              two launches), the Function on the card against its CPU run;
              times, bounds with bf16 bytes for X, the library call
              (torch.sparse.sampled_addmm over K's CSR pattern, as in
              phase 15; its bf16 call tried); K6 bf16 at C=33 and, from
              global memory, C=100 at N=256
 19. serve    --bf16: phase 4's and 6's requests (K1 / K2 on bf16
              features), wall ms beside the f32 ones, one request of each
              route against the CPU in bf16, cli.match.main --bf16 once
 20. evaluate --bf16 over phase 7's split (K2) and phase 9's (K3), pairs/s
              beside the f32 runs (thread workers)
 21. train    one --bf16 train step of stage 1 against the CPU (loss terms,
              per-partition gradient cosines, finite gradients; beside
              it the f32 step of the same weights and picks as a yardstick:
              the card's cosine to it not more than 0.02 below the CPU's,
              per partition; and the same bf16 step with the plain
              versions of K2 / K3 / K6, reported), then
              cli.train --bf16 through stages 1 and 2, 4 steps each, beside
              phase 17's f32 stages; every K1 / K2 / K3 / K6 launch of
              phases 19-21 on bf16 X
 22. serve    --hyperedge --cls-k-features at full width on the bucket
              route (n_max 64, t_max 384): 3 requests (K2 three times each),
              one against the CPU (TF32 off, phase 5's limits), the UNIV
              route refused ("hyperedge + univ kernel", as the reference),
              cli.match.main --viz once (a 240x640 PNG)
 23. evaluate the same options over augmented test pairs (cli.evaluate
              --augment): phase 7's split at B=8 / n_max 64 (K2) and phase
              9's at B=2 / n_max 256 (K3); pairs/s
 24. train    one stage-1 step with both options at B=8, full width, card
              against CPU (phase 16's limits); the step's peak memory; the
              triangle term alone (CUDA events, peak memory) and its share
              of a profiled step (torch.profiler)
 25. backbone VGG16, VGG16-bn and precomputed features ("none"): a forward
              each at B=8 / n_max 64 (K2) against the CPU, then timed
 26. overfit  cli.overfit at its defaults (100 steps, TF32 off), loss and
              accuracy every tenth step, the first step against the CPU's
              In 22-26 one more call of each path runs under torch.profiler,
              whose count of K1 / K2 / K3 / K6 launches must equal the
              wrappers'.
 27. mesh     the edge-sharded path (parallel/) on one card: an NCCL process
              group of world size 1 in this process, cli.train's full-width
              model (B=8, n_max 64, f32, TF32 off, sk_tau 0.05) forward with
              a p = 1 row plan through the real halo exchange (K2 twice a
              layer: local and halo edges) and one stage-3 train step
              through the data-group gradient path, against the same
              weights without a grid (outputs rtol 2e-2 / atol 2e-3,
              perm_mat flips <= 0.5 %, gradient cosine >= 0.9999 per
              partition); then p = 2, 4, 8 ranks emulated in this process
              (the exchange an index copy) at B=8 / N=64 / E=384 (K2, K6)
              and B=2 / N=256 / E=1536 (K3, K6), C=17, both orientations,
              forward and backward against the unsharded kernels and the
              plain version (1e-5 of the range), each rank's launches and
              ms of one layer beside the unsharded call and the plan's
              halo_fraction; cli.train --mesh 1x2 / 2x1 where two cards are
              visible (else a line saying why not)
 28. poredet  the pore detector trained on the card: one Adam step of
              net17nomax against the CPU (TF32 off; loss, batch statistics,
              gradient cosines, the card's Adam on the CPU's gradients;
              limits in `poredet_step_parity`), then
              scripts.train_poredet's main with RESULTS.md's protocol (24 /
              6 / 6 impressions, 30 epochs, TF32 off): patches, ms a step,
              each epoch's loss and validation F, the grid's pick, TEST I /
              II F, TDR, FDR beside the repo's trained detector and DPF;
              fails below TEST_II F 0.65; the written .npz reloaded detects
              as the trained model
 29. qap      a planted QAP (ops.qap, 20 iterations, tau 0.05) at n = 64 /
              384 edge slots (K2) and n = 256 / 1536 (K3) against the port's
              CPU run (1e-4, the same greedy result, recovery >= 0.9,
              launches = iterations by the wrappers and torch.profiler);
              assoc_matvec_fused against K3; Gconv, ChannelIndependentConv,
              DenseAssocGNNLayer and BilinearAffinity against the CPU (1e-5
              of the range); cli.verify_setup (exit 0)
 30. profile  scripts.profile_train_step at its defaults (Config() at full
              width, B=8, n_max 64, stage 3: K2 forward, K2 dX, K6): eval
              forward, train forward, forward + backward, the optimizer
              alone, the full step and the step under six ablations
              (`scripts.profile_train_step.ablations`); per variant
              median host ms of 10 steps, pairs/s, and over 3 profiled
              steps busy ms, idle share, launches; the profiler's K1 / K2 /
              K3 / K6 launches equal to the wrappers'
 31. halo     scripts.bench_edge_partition (n = 512, C = 16): one device
              (K3) and p = 2 / 4 / 8 ranks (emulated on one card) within
              1e-5 of its range; halo rows, bytes, fraction, overlap proxy
 32. scaling  scripts.bench_cli_mesh_scaling: cli.train --n-devices 1 in a
              child process (2 / 4 where as many cards are visible)
 33. reports  cli.evaluate's scores.csv on phase 17's checkpoint over a
              split with sibling fingers, scripts.hard_impostor_report on
              it; scripts.matching_recall_report (K2; launches against the
              profiler's), its first batch card against CPU (TF32 off)
 34. caps     K1's slot-cap sweep (scripts/time_univ_v3.py, caps 8 / 16 /
              24, n = 600, C = 16, bf16 X) against the plain version
 35. sinkhorn the masked Sinkhorn's kernels (kernels.sinkhorn: forward, and
              backward through autograd) against the plain ops
              (ops.sinkhorn.sinkhorn_batch_plain) at B = 512, S = 64, 40-64
              valid rows and columns, tau 0.01, 20 and 10 sweeps: errors,
              CUDA-event medians of 20 calls behind an L2 flush, the
              kernels alone by torch.profiler, the byte bound; then the
              three benchmark cells' configurations (perfbench's
              resnet18.eval-n64, vgg16bn.eval-n64, resnet18.train-s3, one
              batch each at the cell's batch size): every Sinkhorn call
              there must take the kernels (engagement 100 %: forward
              launches over forward launches plus plain calls)

Phase 15 also times K6's library call, torch.sparse.sampled_addmm of dY and
X over K's nonzero pattern (cuSPARSE's SDDMM: dKe and dKp at once).

Weights are initialised from a seed (the detector's are the trained ones of
results/poredet/net17nomax.npz), images and keypoints are made from a seed;
nothing else is read from disk but the package itself, the PolyU fixture
images under tests/fixtures and what the script wrote. The lines before the
last carry the per-kernel JSON, the bare-image / Hungarian JSON and the
card; the last line is {"ok": true, "device": {...}}.
"""
import contextlib
import copy
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False — this script "
          "needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

from fpmatch_tpu_torch import native
from fpmatch_tpu_torch.cli import evaluate as cli_evaluate
from fpmatch_tpu_torch.cli import verify_setup as cli_verify
from fpmatch_tpu_torch.cli import train as cli_train
from fpmatch_tpu_torch.cli import match as cli_match
from fpmatch_tpu_torch.cli import model_config_from_args
from fpmatch_tpu_torch.cli.match import (build_parser, build_request,
                                         make_detector, match_arrays,
                                         read_pair)
from fpmatch_tpu_torch.core.config import default_stages
from fpmatch_tpu_torch.core.build_graphs import build_edges
from fpmatch_tpu_torch.data.benchmark import make_benchmark
from fpmatch_tpu_torch.data.generator import (generate_synthetic_dataset,
                                              render_impression)
from fpmatch_tpu_torch.data.pipeline import (DataLoader, PairDataset,
                                             collate)
from fpmatch_tpu_torch.kernels import _build
from fpmatch_tpu_torch.kernels import assoc_bucket as k23
from fpmatch_tpu_torch.kernels import assoc_grad as k6
from fpmatch_tpu_torch.kernels import assoc_univ as k4
from fpmatch_tpu_torch.kernels import assoc_univ_v3 as k1
from fpmatch_tpu_torch.kernels import inoculate as k5
from fpmatch_tpu_torch.kernels import sinkhorn as k_sk
from fpmatch_tpu_torch.data.synthetic import synthetic_pair_batch
from fpmatch_tpu_torch.models import backbone as t_backbone
from fpmatch_tpu_torch.models import ngm as t_ngm
from fpmatch_tpu_torch.models import gcn as t_gcn
from fpmatch_tpu_torch.models import layers as t_layers
from fpmatch_tpu_torch.models.ngm import build_model
from fpmatch_tpu_torch.ops import assoc as ops_assoc
from fpmatch_tpu_torch.ops.assoc import (CHUNKED_NNZ_THRESHOLD, assoc_dense,
                                         assoc_matvec, assoc_matvec_chunked,
                                         assoc_matvec_fused)
from fpmatch_tpu_torch.ops.hungarian import hungarian_host
from fpmatch_tpu_torch.ops import sinkhorn as ops_sk
from fpmatch_tpu_torch.ops.qap import qap_objective, qap_power_sinkhorn
from fpmatch_tpu_torch.ops.soft_topk import greedy_perm
from fpmatch_tpu_torch.poredet import architectures as pd_arch
from fpmatch_tpu_torch.poredet import train as pd_train
from fpmatch_tpu_torch.poredet.dpf import detect_pores_dpf, detect_pores_lemes
from fpmatch_tpu_torch.poredet.inference import (candidates,
                                                 detect_pores_in_image)
from fpmatch_tpu_torch.poredet.train import load_detector, validate_full_images
from fpmatch_tpu_torch.scripts import (bench_cli_mesh_scaling,
                                       bench_edge_partition,
                                       hard_impostor_report,
                                       matching_recall_report,
                                       time_univ_v3, train_poredet,
                                       tune_univ)
from fpmatch_tpu_torch.scripts import _measure
from fpmatch_tpu_torch.scripts import profile_train_step as step_profiler
from fpmatch_tpu_torch.train.checkpoints import restore_params
from fpmatch_tpu_torch.train.state import create_state, partition_of
from fpmatch_tpu_torch.train.step import (make_eval_step,
                                          make_eval_step_masked,
                                          make_train_step)
from fpmatch_tpu_torch.utils.profiling import F32_FLOPS as PEAK_F32_FLOPS
from fpmatch_tpu_torch.utils.profiling import HBM_BYTES_PER_S as PEAK_BYTES_S

SEED = 0
DEV = torch.device("cuda")
ROOT = Path(__file__).resolve().parent
DETECTOR = ROOT / "results" / "poredet" / "net17nomax.npz"
FIXTURE = ROOT / "tests" / "fixtures" / "PolyU-mini" / "DBII" / "test"
# the peaks of `bound` (one H100 SXM, dense: HBM bytes/s, f32 FLOP/s
# outside the tensor cores) are utils.profiling's, which assoc_roofline reads
T0 = time.time()


def say(*a):
    print(*a, flush=True)


def fail(msg):
    say(f"FAIL: {msg}")
    sys.exit(1)


COUNTS = (k1.LAUNCHES, k23.LAUNCHES, k4.LAUNCHES, k5.LAUNCHES, k6.LAUNCHES,
          k_sk.LAUNCHES, ops_sk.PLAIN_CALLS)
# what each phase's launch checks read: the association kernels' and K5's
# counts; the Sinkhorn's (its kernels' launches and the plain calls) are
# phase 35's
ASSOC_COUNTS = COUNTS[:5]
SINKHORN_COUNTS = COUNTS[5:]


def reset_counts():
    """Every kernel's launch count to 0 (done just before a path is driven)."""
    for counts in COUNTS:
        for k in counts:
            counts[k] = 0


def read_counts(counts=ASSOC_COUNTS):
    return {k: v for c in counts for k, v in c.items()}


def restore_counts(saved):
    """Launches made to compare or to profile do not count (the counts that
    `saved` holds)."""
    for counts in COUNTS:
        for k in counts:
            if k in saved:
                counts[k] = saved[k]


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


# ------------------------------------------------------------------ 1 device
def phase_device():
    card = _measure.card().splitlines()[0]
    nvcc = sh([_build.find_nvcc(), "--version"]).splitlines()[-2:]
    say(f"[1 device] {card}")
    say(f"[1 device] python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} cudnn "
        f"{torch.backends.cudnn.version()} | nvcc: {' '.join(nvcc)}")
    say(f"[1 device] defaults: cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    return card


# ------------------------------------------------------------------- 2 build
def phase_build():
    """Build every source, then `inoculate` twice: the first and the second
    launch of x + 1 in each library (each checked bit for bit against the
    plain version inside `inoculate`). Returns K5's row."""
    t = time.time()
    libs = _build.build(verbose=True)
    for name in libs:
        _build.load(name)
    say(f"[2 build] {len(libs)} source(s) {sorted(libs)} built with nvcc "
        f"for sm_90a and loaded in {time.time() - t:.1f} s")
    first = k5.inoculate()
    second = k5.inoculate()
    if sorted(first) != sorted(libs):
        fail(f"inoculate reached {sorted(first)}, not every library")
    for name in sorted(libs):
        say(f"[2 build] inoculate {name}: y == x + 1 exactly; first launch "
            f"{first[name] * 1e3:.3f} ms, second {second[name] * 1e3:.3f} ms "
            f"(host clock, synchronised)")
    # one launch of the (8, 128) tile by CUDA events: 4 KB in, 4 KB out.
    # Each call allocates its output; all three are timed behind an L2
    # flush, which keeps the host's launch path (ctypes, allocation) out of
    # the readings
    x = torch.randn(k5.SHAPE, device=DEV)
    lib = _build.load("assoc_univ")
    y = k5.launch(lib, x)
    y_lib = torch.add(x, 1.0)
    torch.cuda.synchronize()
    err = float((y - k5.inoculate_plain(x)).abs().max())
    if not torch.equal(y_lib, y):
        fail("torch.add(x, 1) differs from the inoculate kernel")
    nbytes = 2 * 4 * x.numel()
    flush = tune_univ.l2_flush(DEV)
    row = {"shape": list(k5.SHAPE), "err_vs_plain": err,
           "max_abs_err": err,
           "ms": time_ms(lambda: k5.launch(lib, x), reps=50, flush=flush),
           "plain_ms": time_ms(lambda: k5.inoculate_plain(x), reps=50,
                               flush=flush),
           "library_ms": time_ms(lambda: torch.add(x, 1.0), reps=50,
                                 flush=flush),
           "first_ms": {k: v * 1e3 for k, v in first.items()},
           "second_ms": {k: v * 1e3 for k, v in second.items()},
           "bytes": nbytes, **bound(nbytes, x.numel())}
    if err != 0.0:
        fail("inoculate is not exactly x + 1")
    say("[2 build] " + json.dumps(row))
    return row


# ----------------------------------------------------------------- 3 kernels
def delaunay(rng, n):
    P = rng.uniform([8, 8], [312, 232], size=(n, 2)).astype(np.float32)
    _, s, d = build_edges(P)
    return P, s, d


def relerr(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def values_off(y, want):
    """Values of y further than 1e-5 of want's range from it: a count that is
    printed. With bf16 X, K1, K2 and K3 round each term as their plain
    versions do and only the order of the f32 sums differs, so they are held
    to 1e-5 of the range (`relerr`) as in f32; a result that rounds
    elsewhere puts most values past it."""
    return int(((y - want).abs() > 1e-5 * float(want.abs().max())).sum())


def time_ms(fn, reps=20, flush=None):
    """Median CUDA-event time of one call: tune_univ's helper on the card
    (`flush`, a big tensor, is overwritten before each call)."""
    return tune_univ.time_ms(fn, DEV, reps, flush)


def sparse_library(X, Kp, Ke, out1, in1, out2, in2, n_e):
    """The library call for the association matvec: K (or K^T, by the roles
    given) as one CSR matrix of (B·N1·N2)², block diagonal over the batch,
    with Ke[b, e1, e2] at (out1·N2 + out2, in1·N2 + in2) for the real edges
    (n_e[b] = real E1, E2 of sample b) and Kp on the diagonal, times vec X by
    `torch.sparse.mm`. K is built here once; the returned callable (the one
    call that is timed) gives (B, N1, N2, C) float32."""
    B, N1, N2, C = X.shape
    M = B * N1 * N2
    n_e = torch.as_tensor(np.asarray(n_e), device=DEV)
    keep = ((torch.arange(Ke.shape[1], device=DEV)[None, :, None]
             < n_e[:, 0, None, None])
            & (torch.arange(Ke.shape[2], device=DEV)[None, None, :]
               < n_e[:, 1, None, None]))
    base = torch.arange(B, device=DEV)[:, None, None] * (N1 * N2)
    at = lambda a, b: (base + a.long()[:, :, None] * N2
                       + b.long()[:, None, :])[keep]
    diag = torch.arange(M, device=DEV)
    idx = torch.stack([torch.cat([at(out1, out2), diag]),
                       torch.cat([at(in1, in2), diag])])
    vals = torch.cat([Ke[keep], Kp.reshape(-1)])
    K = torch.sparse_coo_tensor(idx, vals, (M, M), check_invariants=False
                                ).coalesce().to_sparse_csr()
    del idx, vals, keep
    Xf = X.float().reshape(M, C)
    call = lambda: torch.sparse.mm(K, Xf).reshape(B, N1, N2, C)
    call.K, call.X = K, Xf
    return call


def library_case(r, call, want, flush):
    """Hold the library call against the plain version (it must compute the
    same function), then time it: `library_ms` in the row `r`."""
    err = relerr(call(), want)
    torch.cuda.synchronize()
    if not err <= 1e-5:
        fail(f"the library call disagrees with the plain version: {err:.3e}")
    r.update(library_err_vs_plain=err,
             library_ms=time_ms(call, reps=10, flush=flush))


def bound(nbytes, flops):
    """The least time for `nbytes` moved and `flops` done (f32 peak):
    {"bound_ms": ms, "bound_by": what binds}."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_bf16(K, X, flush):
    """The library call with K and X in bf16 (`torch.sparse.mm` of a bf16
    CSR matrix): its time, or why the library refused it. It rounds Kp and
    every product otherwise than the kernels, so its values are not held."""
    try:
        Kb, Xb = K.to(torch.bfloat16), X.bfloat16()
        torch.sparse.mm(Kb, Xb)
        torch.cuda.synchronize()
        return {"library_bf16_ms": time_ms(lambda: torch.sparse.mm(Kb, Xb),
                                           reps=10, flush=flush)}
    except (RuntimeError, NotImplementedError, TypeError) as e:
        # what the library offers is reported, not worked around
        return {"library_bf16_ms": None,
                "library_bf16_refused": str(e).splitlines()[0][:200]}


def kernel_case(rng, N, n1, n2, E, C, transpose, flush, timed):
    """One comparison at bucket N with n1 / n2 real nodes, Ke padded to
    (E, E), the plan made as the serving CLI makes it. Returns a dict of
    errors (and times when `timed`); a timed case also shows that the bf16
    check refuses the kernel's old rounding (all-f32 Ke)."""
    _, s1, d1 = delaunay(rng, n1)
    P2, s2, d2 = delaunay(rng, n2)
    if len(s1) > E or len(s2) > E:
        fail(f"e_max {E} too small for {len(s1)} / {len(s2)} edges")
    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    X = torch.zeros(N, N, C)
    X[:n1, :n2] = torch.randn(n1, n2, C, generator=g)
    Kp = torch.zeros(N, N)
    Kp[:n1, :n2] = torch.randn(n1, n2, generator=g)
    Ke = torch.zeros(E, E)
    Ke[:len(s1), :len(s2)] = torch.randn(len(s1), len(s2), generator=g)
    X, Kp, Ke = X.to(DEV), Kp.to(DEV), Ke.to(DEV)
    plan = k1.plan_univ_v3(k1.pad_points(P2, N), s1, d1, s2, d2,
                           transpose=transpose, n1=N).to(DEV)

    got = k1.assoc_matvec_univ_v3(X, Kp, Ke, plan)
    torch.cuda.synchronize()
    plain = k1.assoc_matvec_univ_v3_plain(X, Kp, Ke, plan)
    pad = lambda a: torch.from_numpy(np.pad(a, (0, E - len(a)))
                                     ).to(DEV)[None]
    noplan = assoc_matvec_chunked(X[None], Kp[None], Ke[None], pad(s1),
                                  pad(d1), pad(s2), pad(d2),
                                  transpose=transpose)[0]
    Xb = X.bfloat16()
    got_bf = k1.assoc_matvec_univ_v3(Xb, Kp, Ke, plan)
    again_bf = k1.assoc_matvec_univ_v3(Xb, Kp, Ke, plan)
    again = k1.assoc_matvec_univ_v3(X, Kp, Ke, plan)
    plain_bf = k1.assoc_matvec_univ_v3_plain(Xb, Kp, Ke, plan)
    torch.cuda.synchronize()
    r = {"N": N, "n1": n1, "n2": n2, "C": C, "transpose": transpose,
         "E1": len(s1), "E2": len(s2), "S1": plan.s1, "S2": plan.s2,
         "spilled": [int((~plan.keep1).sum()), int((~plan.keep2).sum())],
         "err_vs_plain": relerr(got, plain),
         "err_vs_noplan": relerr(got, noplan),
         "bf16_err_vs_plain_bf16": relerr(got_bf, plain_bf),
         "bf16_values_off": values_off(got_bf, plain_bf),
         "bf16_err_vs_f32": relerr(got_bf, got),
         "max_abs_err": float((got - plain).abs().max()),
         "bit_reproducible": bool(torch.equal(got, again)
                                  and torch.equal(got_bf, again_bf))}
    for k in ("err_vs_plain", "err_vs_noplan", "bf16_err_vs_plain_bf16"):
        if not r[k] <= 1e-5:
            fail(f"assoc_univ_v3 {k} = {r[k]:.3e} > 1e-5 at {r}")
    if not r["bit_reproducible"]:
        fail(f"assoc_univ_v3: two launches on the same inputs differ at {r}")
    if not torch.isfinite(got).all():
        fail("assoc_univ_v3 produced non-finite values")
    if timed:
        # the same limit refuses the rounding the kernel had before: f32 Ke
        # on every pair (the plain version on the bf16 values in f32)
        f32_ke = k1.assoc_matvec_univ_v3_plain(Xb.float(), Kp, Ke, plan)
        r["bf16_f32_ke_err"] = relerr(f32_ke, plain_bf)
        r["bf16_values_off_f32_ke"] = values_off(f32_ke, plain_bf)
        if r["bf16_f32_ke_err"] <= 1e-5:
            fail(f"assoc_univ_v3, bf16 X: the limit passes all-f32 Ke at "
                 f"{r}")
        # least work for THIS input: X, Kp and the real block of Ke read
        # once, the kernel's tables read once, Y written once; 2 flops per
        # (association edge, channel) + the Kp term
        e1r, e2r = len(s1), len(s2)
        tables = sum(t.numel() * t.element_size()
                     for t in plan.kernel_tables())
        nbytes = 4 * (2 * N * N * C + N * N + e1r * e2r) + tables
        flops = 2.0 * C * e1r * e2r + 2.0 * N * N * C
        r.update(
            ms=time_ms(lambda: k1.assoc_matvec_univ_v3(X, Kp, Ke, plan),
                       flush=flush),
            # the kernel alone (torch.profiler): `ms` also holds what of the
            # wrapper's host time outlasts the flush
            kernel_ms=tune_univ.profiled_ms(
                lambda: k1.assoc_matvec_univ_v3(X, Kp, Ke, plan),
                "assoc_univ_v3", flush=flush),
            ms_warm_l2=time_ms(
                lambda: k1.assoc_matvec_univ_v3(X, Kp, Ke, plan)),
            ms_bf16=time_ms(
                lambda: k1.assoc_matvec_univ_v3(Xb, Kp, Ke, plan),
                flush=flush),
            plain_ms=time_ms(
                lambda: k1.assoc_matvec_univ_v3_plain(X, Kp, Ke, plan),
                reps=5, flush=flush),
            noplan_ms=time_ms(
                lambda: assoc_matvec_chunked(
                    X[None], Kp[None], Ke[None], pad(s1), pad(d1), pad(s2),
                    pad(d2), transpose=transpose), reps=5, flush=flush),
            bytes=nbytes, flops=flops, **bound(nbytes, flops))
        # bf16 X: X read in 2 bytes, the rest as in f32
        r["bound_ms_bf16"] = bound(nbytes - 2 * N * N * C,
                                   flops)["bound_ms"]
        roles = (d1, s1, d2, s2) if transpose else (s1, d1, s2, d2)
        lib = sparse_library(X[None], Kp[None], Ke[None],
                             *(pad(a) for a in roles), [[e1r, e2r]])
        library_case(r, lambda: lib()[0], plain, flush)
        r.update(library_bf16(lib.K, lib.X, flush))
    return r


def phase_kernels():
    rng = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    rows = []
    # (bucket, n1, n2, e_max, C, transpose): the model's channel counts, and
    # C=16 (each staged node padded by one word); then the launcher's other
    # paths: C=32 (two staged buffers over the budget) and C=33 (two channel
    # chunks) read X and Ke from global memory, and a row of 700 columns is
    # staged over two tiles and written straight from registers
    cases = [(600, n1, n2, 3840, C, t) for (n1, n2) in ((600, 600),
                                                        (520, 600))
             for C in (1, 17) for t in (True, False)] + [
        (600, 600, 600, 3840, C, True) for C in (16, 32, 33)] + [
        (700, n1, n2, 4480, 4, t) for (n1, n2, t) in ((650, 700, True),
                                                      (700, 650, False))]
    for N, n1, n2, E, C, transpose in cases:
        timed = (N, n1, n2, transpose) == (600, 600, 600, True) and C in (1,
                                                                        17)
        r = kernel_case(rng, N, n1, n2, E, C, transpose, flush, timed)
        rows.append(r)
        say("[3 kernels] " + json.dumps(r))
    # zero-edge sides: Ke[:0] with edges on side 2 only, then no edges
    n, C = 130, 4
    P2, s2, d2 = delaunay(rng, n)
    empty = np.zeros(0, np.int64)
    X = torch.randn(n, n, C, device=DEV)
    Kp = torch.randn(n, n, device=DEV)
    for (a, b) in ((s2, d2), (empty, empty)):
        Ke = torch.zeros(8, len(a), device=DEV)[:0]
        plan = k1.plan_univ_v3(P2, empty, empty, a, b, n1=n).to(DEV)
        got = k1.assoc_matvec_univ_v3(X, Kp, Ke, plan)
        torch.cuda.synchronize()
        e = relerr(got, Kp[..., None] * X)
        say(f"[3 kernels] zero-edge side, E2={len(a)}: S1={plan.s1} "
            f"S2={plan.s2} err vs Kp*X = {e:.2e}")
        if not e <= 1e-6:
            fail("zero-edge case disagrees with the Kp diagonal")
    del flush
    return rows


# ------------------------------------------------- 3b bucket / any-size kernels
def bucket_inputs(rng, B, N, E, C, n_lo, n_hi, multi_edges=False):
    """A padded batch of ragged pairs on the card: Delaunay graphs of
    n_lo..n_hi nodes (or, with `multi_edges`, random edge lists with repeated
    edges and self-loops filling every slot), X / Kp zero outside the valid
    block, Ke zero on padded slots."""
    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    X = torch.zeros(B, N, N, C)
    Kp = torch.zeros(B, N, N)
    Ke = torch.zeros(B, E, E)
    idx = np.zeros((4, B, E), np.int32)
    n_e = np.zeros((B, 2), np.int64)
    for b in range(B):
        n1, n2 = (int(v) for v in rng.integers(n_lo, n_hi + 1, size=2))
        if multi_edges:
            lists = [rng.integers(0, n, size=E) for n in (n1, n1, n2, n2)]
        else:
            _, s1, d1 = delaunay(rng, n1)
            _, s2, d2 = delaunay(rng, n2)
            lists = [s1, d1, s2, d2]
        if max(len(a) for a in lists) > E:
            fail(f"e_max {E} too small for {[len(a) for a in lists]} edges")
        for k, a in enumerate(lists):
            idx[k, b, :len(a)] = a
        e1, e2 = len(lists[0]), len(lists[2])
        n_e[b] = (e1, e2)
        X[b, :n1, :n2] = torch.randn(n1, n2, C, generator=g)
        Kp[b, :n1, :n2] = torch.randn(n1, n2, generator=g)
        Ke[b, :e1, :e2] = torch.randn(e1, e2, generator=g)
    src1, dst1, src2, dst2 = (torch.from_numpy(a).to(DEV) for a in idx)
    ar = torch.arange(E)
    m1 = (ar[None] < torch.from_numpy(n_e[:, :1])).to(DEV)
    m2 = (ar[None] < torch.from_numpy(n_e[:, 1:])).to(DEV)
    return (X.to(DEV), Kp.to(DEV), Ke.to(DEV), src1, dst1, src2, dst2,
            m1, m2, n_e)


def bucket_case(rng, B, N, E, C, n_lo, n_hi, transpose, flush, timed,
                multi_edges=False):
    """K2 and K3 against their plain versions and against the plain ops of
    ops.assoc, f32 and bf16 X. Returns one row per kernel; K3's row names
    the path its launcher took and, when timed, carries K2's times on the
    same inputs (`k2_ms`) and, at C=17, K3's time per `block_c`."""
    X, Kp, Ke, s1, d1, s2, d2, m1, m2, n_e = bucket_inputs(
        rng, B, N, E, C, n_lo, n_hi, multi_edges)
    masks = {} if multi_edges else dict(e1_mask=m1, e2_mask=m2)
    edges = (s1, d1, s2, d2)
    ops = assoc_matvec(X, Kp, Ke, *edges, transpose=transpose)
    Xb = X.bfloat16()
    e_real = float((n_e[:, 0] * n_e[:, 1]).sum())
    # least work for THIS input: X, Kp, the real blocks of Ke and the
    # grouped edge lists read once, Y written once; 2 flops per (association
    # edge, channel) + the Kp term
    index_bytes = 4 * B * (4 * E + 2 * (N + 1))
    nbytes = 4 * (2 * B * N * N * C + B * N * N + e_real) + index_bytes
    flops = 2.0 * C * e_real + 2.0 * B * N * N * C
    # the library call computes what both kernels compute: timed once
    lib_row = {}
    if timed:
        roles = (d1, s1, d2, s2) if transpose else (s1, d1, s2, d2)
        lib = sparse_library(X, Kp, Ke, *roles, n_e)
        library_case(lib_row, lib, ops, flush)
        lib_row.update(library_bf16(lib.K, lib.X, flush))
        # bf16 X: X read in 2 bytes, the rest as in f32
        lib_row["bound_ms_bf16"] = bound(nbytes - 2 * B * N * N * C,
                                         flops)["bound_ms"]
    rows = []
    for name, kern, plain in (
            ("assoc_bucket", k23.assoc_matvec_bucket,
             k23.assoc_matvec_bucket_plain),
            ("assoc_large", k23.assoc_matvec_large,
             k23.assoc_matvec_large_plain)):
        got = kern(X, Kp, Ke, *edges, transpose=transpose, **masks)
        torch.cuda.synchronize()
        again = kern(X, Kp, Ke, *edges, transpose=transpose, **masks)
        want = plain(X, Kp, Ke, *edges, transpose=transpose, **masks)
        got_bf = kern(Xb, Kp, Ke, *edges, transpose=transpose, **masks)
        again_bf = kern(Xb, Kp, Ke, *edges, transpose=transpose, **masks)
        want_bf = plain(Xb, Kp, Ke, *edges, transpose=transpose, **masks)
        torch.cuda.synchronize()
        r = {"kernel": name, "B": B, "N": N, "E": E, "C": C,
             "transpose": transpose, "multi_edges": multi_edges,
             "assoc_edges": e_real,
             "err_vs_plain": relerr(got, want),
             "err_vs_ops": relerr(got, ops),
             "bf16_err_vs_plain_bf16": relerr(got_bf, want_bf),
             "bf16_values_off": values_off(got_bf, want_bf),
             "bf16_err_vs_f32": relerr(got_bf, got),
             "max_abs_err": float((got - want).abs().max()),
             "bit_reproducible": bool(torch.equal(got, again)
                                      and torch.equal(got_bf, again_bf))}
        if name == "assoc_large":
            r["path"] = large_path(X, Ke)
        for k in ("err_vs_plain", "err_vs_ops", "bf16_err_vs_plain_bf16"):
            if not r[k] <= 1e-5:
                fail(f"{name} {k} = {r[k]:.3e} > 1e-5 at {r}")
        if timed:
            # the same limit refuses the rounding the kernels had before:
            # bf16 X in f32 products (the kernel on the bf16 values in f32)
            unrounded = kern(Xb.float(), Kp, Ke, *edges,
                             transpose=transpose, **masks)
            r["bf16_f32_products_err"] = relerr(unrounded, want_bf)
            r["bf16_values_off_f32_products"] = values_off(unrounded,
                                                           want_bf)
            if r["bf16_f32_products_err"] <= 1e-5:
                fail(f"{name}, bf16 X: the limit passes f32 products at {r}")
        if not r["bit_reproducible"]:
            fail(f"{name}: two launches on the same inputs differ")
        if not torch.isfinite(got).all():
            fail(f"{name} produced non-finite values")
        if timed:
            call = lambda x=X, **kw: kern(x, Kp, Ke, *edges,
                                          transpose=transpose, **masks, **kw)
            r.update(
                ms=time_ms(call, flush=flush),
                # the kernel alone (torch.profiler): `ms` also holds what of
                # the wrapper's host time outlasts the flush
                kernel_ms=tune_univ.profiled_ms(call, name + "_kernel",
                                                flush=flush),
                ms_warm_l2=time_ms(call),
                ms_bf16=time_ms(lambda: call(Xb), flush=flush),
                plain_ms=time_ms(
                    lambda: plain(X, Kp, Ke, *edges, transpose=transpose,
                                  **masks), reps=5, flush=flush),
                ops_ms=time_ms(
                    lambda: assoc_matvec(X, Kp, Ke, *edges,
                                         transpose=transpose),
                    reps=5, flush=flush),
                bytes=nbytes, flops=flops, **bound(nbytes, flops),
                **lib_row)
            if name == "assoc_large":
                r.update(k2_ms=rows[0]["ms"], k2_ms_bf16=rows[0]["ms_bf16"],
                         k2_kernel_ms=rows[0]["kernel_ms"])
                if C == 17:     # the default block_c, chosen by these times
                    r["block_c_ms"] = {
                        str(bc): time_ms(lambda: call(block_c=bc),
                                         flush=flush) for bc in (8, 16, 32)}
        rows.append(r)
    return rows


def large_path(X, Ke, block_c=k23.DEFAULT_BLOCK_C):
    """The path K3's launcher takes for these inputs (its shape rule)."""
    return k23.large_geometry(*X.shape, Ke.shape[1], Ke.shape[2],
                              X.element_size(), block_c).path


def wide_row_case(rng):
    """A row of 4096 x 17 channels, wider than any bucket the model uses:
    Delaunay edges on graph 2, on graph 1 one self-loop at node 0. K3 reads
    it from global memory over seven column tiles."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    _, s2, d2 = delaunay(rng, 4096)
    wide = [torch.randn(1, 4, 4096, 17, device=DEV, generator=g),
            torch.randn(1, 4, 4096, device=DEV, generator=g),
            torch.randn(1, 1, len(s2), device=DEV, generator=g),
            torch.zeros(1, 1, dtype=torch.int32, device=DEV),
            torch.zeros(1, 1, dtype=torch.int32, device=DEV),
            torch.from_numpy(s2[None]).to(DEV),
            torch.from_numpy(d2[None]).to(DEV)]
    out = {}
    for name, kern, plain in (
            ("assoc_bucket", k23.assoc_matvec_bucket,
             k23.assoc_matvec_bucket_plain),
            ("assoc_large", k23.assoc_matvec_large,
             k23.assoc_matvec_large_plain)):
        errs = []
        for X in (wide[0], wide[0].bfloat16()):
            args = [X] + wide[1:]
            got = kern(*args, transpose=True)
            again = kern(*args, transpose=True)
            torch.cuda.synchronize()
            errs.append(relerr(got, plain(*args, transpose=True)))
            if not torch.equal(got, again):
                fail(f"{name}: two launches on the wide row differ")
        out[name] = {"err_vs_plain": errs[0],
                     "bf16_err_vs_plain_bf16": errs[1]}
        if name == "assoc_large":
            out[name]["path"] = large_path(wide[0], wide[2])
        say(f"[3 kernels] {name}, a 1 x 4 x 4096 x 17 row ({len(s2)} "
            f"graph-2 edges): {json.dumps(out[name])}, two launches "
            f"bit-identical")
        if not max(errs) <= 1e-5:
            fail(f"{name} disagrees with its plain version on a wide row")
    return out


def phase_kernels_bucket():
    rng = np.random.default_rng(SEED + 3)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEV)
    saved = read_counts()
    rows = []
    for (B, N, E, n_lo, n_hi) in ((8, 64, 384, 40, 64),
                                  (2, 256, 1536, 200, 256)):
        for C in (1, 17):
            for transpose in (True, False):
                rows += bucket_case(rng, B, N, E, C, n_lo, n_hi, transpose,
                                    flush, timed=transpose)
    rows += bucket_case(rng, 3, 64, 384, 5, 40, 64, True, flush, timed=False,
                        multi_edges=True)
    # the other E1·E2 >= 1 M shape (B=1 at the UNIV bucket), two channel
    # slices (C=33) and padded staged nodes (C=16, an even word count)
    rows += bucket_case(rng, 1, 600, 3840, 17, 560, 600, True, flush,
                        timed=True)
    for C in (33, 16):
        rows += bucket_case(rng, 2, 256, 1536, C, 200, 256, True, flush,
                            timed=False)
    for r in rows:
        say("[3 kernels] " + json.dumps(r))
    # the grouping prologue (sort + counts + cumsum), shared by the three
    # layers of a forward: its own time, a fresh set of index tensors per call
    X, Kp, Ke, s1, d1, s2, d2, m1, m2, _ = bucket_inputs(
        rng, 8, 64, 384, 1, 40, 64)
    plan_ms = time_ms(lambda: k23.plan_bucket(
        s1.clone(), d1, s2, d2, 64, 64, True, m1, m2))
    say(f"[3 kernels] plan_bucket (B=8, E=384, once per batch): "
        f"{plan_ms:.4f} ms")
    wide = wide_row_case(rng)
    paths = {r["path"] for r in rows if "path" in r}
    paths.add(wide["assoc_large"]["path"])
    if paths != {"staged", "global"}:
        fail(f"phase 3 did not run every path of K3's launcher: {paths}")
    restore_counts(saved)
    del flush
    return rows, plan_ms, wide


# ------------------------------------------------ 3c blocked UNIV kernel (K4)
def univ_bound(N, C, E1, E2, plan):
    """Least work of the function for THIS input (K1's formula): X, Kp, Ke
    and the kernel's tables (per-block runs, spill lists, perms) read once,
    Y written once; 2 flops per (association edge, channel) + the Kp term.
    KeR, which the design materialises, is not part of it."""
    tables = sum(t.numel() * t.element_size() for t in plan.kernel_tables())
    nbytes = 4 * (2 * N * N * C + N * N + E1 * E2) + tables
    flops = 2.0 * C * E1 * E2 + 2.0 * N * N * C
    return {"bytes": nbytes, "flops": flops, **bound(nbytes, flops)}


def bf16_agrees(y, want, kept):
    """The bf16-X comparison of K4 with its plain version: every cell within
    one bf16 ulp of its kept part (2**-7 of it: the kept sum is rounded to
    bf16 after an f32 sum taken in another order) plus 1e-5 of the range, and
    at most 1 % of the cells beyond 1e-5 of the range (a flipped rounding).
    Returns (whether it passes, the cells beyond 1e-5 of the range)."""
    scale = 1e-5 * float(want.abs().max())
    err = (y - want).abs()
    off = int((err > scale).sum())
    ok = bool((err <= scale + 2 ** -7 * kept.abs()).all())
    return ok and off <= 0.01 * err.numel(), off


def univ_case(tag, pts1, pts2, edges, X, Kp, Ke, r1, r2, transpose, prec,
              flush=None):
    """K4 against its plain version (same inputs, same rounding) and, for
    f32 X at "highest", against K1 on the same inputs; one launch per call
    (nothing else launched), two launches bit-identical. bf16 X: the kept
    part is rounded to bf16 after an f32 sum taken in another order than
    the plain version's, so a cell may also differ by one bf16 ulp of its
    kept part (`bf16_agrees`; `bf16_cells_off` counts the cells beyond 1e-5
    of the range), and the same comparison must refuse a result without the
    bf16 rounding. With `flush`, the times of gather_ke_blocks,
    the plain version, K1 and the library call on the same inputs (the
    wrapper and the kernel alone are timed by the sweep, phase 10)."""
    n, C = X.shape[0], X.shape[2]
    hp = k4.plan_univ(pts1, pts2, *edges, r1=r1, r2=r2, transpose=transpose)
    plan = hp.to(DEV)
    dt = k4.compute_dtype(X, prec)
    KeR = k4.gather_ke_blocks(Ke, plan, dtype=dt)
    before = read_counts()
    got = k4.assoc_matvec_univ(X, Kp, Ke, plan, KeR, precision=prec)
    torch.cuda.synchronize()
    again = k4.assoc_matvec_univ(X, Kp, Ke, plan, KeR, precision=prec)
    after = read_counts()
    want = k4.assoc_matvec_univ_plain(X, Kp, Ke, plan, KeR, precision=prec)
    torch.cuda.synchronize()
    r = {"case": tag, "n": n, "C": C, "r1": r1, "r2": r2,
         "transpose": transpose, "prec": prec, "x": str(X.dtype)[6:],
         "E1": len(edges[0]), "E2": len(edges[2]), "b1": hp.b1,
         "b2": hp.b2, "spill1": len(hp.spill1), "spill2": len(hp.spill2),
         "err_vs_plain": relerr(got, want),
         "max_abs_err": float((got - want).abs().max()),
         "bit_reproducible": bool(torch.equal(got, again))}
    if {k: after[k] - before[k] for k in after} != {
            k: 2 * (k == "assoc_univ") for k in after}:
        fail(f"assoc_univ: two calls did not make exactly two launches of "
             f"its kernel and nothing else at {r}")
    if X.dtype == torch.bfloat16:
        kept = k4._unsort(k4.kept_terms_plain(k4.halo(X, plan, dt), KeR,
                                              plan), plan)
        ok, r["bf16_cells_off"] = bf16_agrees(got, want, kept)
        if not ok:
            fail(f"assoc_univ, bf16 X: a cell differs by more than one bf16 "
                 f"ulp of its kept part, or more than 1 % of the cells by "
                 f"more than 1e-5 of the range, at {r}")
        # the same comparison refuses a kernel without the bf16 rounding:
        # the kept part left unrounded, or that and the spilled products in
        # f32 (the kernel with f32 X at "default")
        unrounded = want - kept.bfloat16().float() + kept
        f32_spill = k4.assoc_matvec_univ(X.float(), Kp, Ke, plan, KeR,
                                         precision="default")
        for name, y in (("unrounded", unrounded), ("f32_spill", f32_spill)):
            ok, r[f"bf16_cells_off_{name}"] = bf16_agrees(y, want, kept)
            if ok:
                fail(f"assoc_univ, bf16 X: the comparison passes a result "
                     f"without the bf16 rounding ({name}) at {r}")
    elif prec == "highest":
        p1 = k1.plan_univ_v3(pts2, *edges, transpose=transpose,
                             n1=n).to(DEV)
        r["err_vs_k1"] = relerr(got, k1.assoc_matvec_univ_v3(X, Kp, Ke, p1))
    for k in ("err_vs_plain", "err_vs_k1"):
        if X.dtype != torch.bfloat16 and k in r and not r[k] <= 1e-5:
            fail(f"assoc_univ {k} = {r[k]:.3e} > 1e-5 at {r}")
    if not r["bit_reproducible"]:
        fail(f"assoc_univ: two launches on the same inputs differ at {r}")
    if not torch.isfinite(got).all():
        fail("assoc_univ produced non-finite values")
    if flush is not None:
        r.update(
            gather_ms=time_ms(lambda: k4.gather_ke_blocks(Ke, plan, dt),
                              flush=flush),
            plain_ms=time_ms(lambda: k4.assoc_matvec_univ_plain(
                X, Kp, Ke, plan, KeR, precision=prec), reps=5, flush=flush),
            k1_ms=time_ms(lambda: k1.assoc_matvec_univ_v3(X, Kp, Ke, p1),
                          flush=flush),
            ker_mb=KeR.numel() * KeR.element_size() / 1e6,
            **univ_bound(n, C, len(edges[0]), len(edges[2]), plan))
        s1, d1, s2, d2 = (torch.as_tensor(a, device=DEV)[None]
                          for a in edges)
        roles = (d1, s1, d2, s2) if transpose else (s1, d1, s2, d2)
        lib = sparse_library(X[None], Kp[None], Ke[None], *roles,
                             [[len(edges[0]), len(edges[2])]])
        library_case(r, lambda: lib()[0], want, flush)
    return r


def star_edges(n_leaves):
    """Both directions between node 0 and nodes 1..n_leaves: degree
    n_leaves at node 0 in either orientation."""
    k = np.arange(1, n_leaves + 1, dtype=np.int32)
    z = np.zeros(n_leaves, np.int32)
    return np.concatenate([k, z]), np.concatenate([z, k])


def phase_kernels_univ():
    """K4 at tune_univ's inputs (n=600 Delaunay pairs) at (32, 128) — the
    other five block sizes are held against the plain version by the sweep,
    phase 10 — a spill-heavy random graph and a degree-80 star; K1 on the
    star too (its repaired slot limit). Comparison launches do not count."""
    saved = read_counts()
    flush = tune_univ.l2_flush(DEV)
    inp = tune_univ.make_inputs(DEV, n=600, c=16, seed=SEED)
    r = univ_case("delaunay", inp.pts1, inp.pts2, inp.edges, inp.X, inp.Kp,
                  inp.Ke, 32, 128, True, "highest", flush)
    rows = [r]
    say("[3 kernels] " + json.dumps(r))
    # C = 16 also in "default" and with bf16 X; C = 1 and 17 (scalar
    # channels) in both orientations, all three modes
    cases = [(16, True, "default"), (16, True, "bf16 X")] + [
        (C, t, m) for C in (1, 17) for t in (True, False)
        for m in ("highest", "default", "bf16 X")]
    for C, transpose, mode in cases:
        if inp.X.shape[2] != C:
            inp = tune_univ.make_inputs(DEV, n=600, c=C, seed=SEED + C)
        X = inp.X.bfloat16() if mode == "bf16 X" else inp.X
        r = univ_case("delaunay", inp.pts1, inp.pts2, inp.edges, X, inp.Kp,
                      inp.Ke, 32, 128, transpose,
                      "highest" if mode == "bf16 X" else mode)
        rows.append(r)
        say("[3 kernels] " + json.dumps(r))
    rng = np.random.default_rng(SEED + 4)
    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    # random edges: nearly every graph-1 edge leaves its window at r1 = 8
    n, m = 600, 1800
    edges = tuple(rng.integers(0, n, m).astype(np.int32) for _ in range(4))
    pts = rng.uniform(size=(2, n, 2)).astype(np.float32)
    X = torch.randn(n, n, 4, device=DEV, generator=g)
    Kp = torch.randn(n, n, device=DEV, generator=g)
    Ke = torch.randn(m, m, device=DEV, generator=g)
    r = univ_case("random graph", pts[0], pts[1], edges, X, Kp, Ke, 8, 128,
                  True, "highest")
    rows.append(r)
    say("[3 kernels] " + json.dumps(r))
    # degree-80 star in graph 1: K1 walks node 0's 80 slots in two chunks
    n = 90
    s1, d1 = star_edges(80)
    _, s2, d2 = build_edges(rng.uniform(8, 232, size=(n, 2)))
    pts = rng.uniform(size=(2, n, 2)).astype(np.float32)
    X = torch.randn(n, n, 17, device=DEV, generator=g)
    Kp = torch.randn(n, n, device=DEV, generator=g)
    Ke = torch.randn(len(s1), len(s2), device=DEV, generator=g)
    for transpose in (True, False):
        p1 = k1.plan_univ_v3(pts[1], s1, d1, s2, d2, transpose=transpose,
                             n1=n)
        if p1.s1 != 80:
            fail(f"the star's row has {p1.s1} slots, not 80")
        p1 = p1.to(DEV)
        a = k1.assoc_matvec_univ_v3(X, Kp, Ke, p1)
        torch.cuda.synchronize()
        b = k1.assoc_matvec_univ_v3(X, Kp, Ke, p1)
        e = relerr(a, k1.assoc_matvec_univ_v3_plain(X, Kp, Ke, p1))
        ab = k1.assoc_matvec_univ_v3(X.bfloat16(), Kp, Ke, p1)
        want_bf = k1.assoc_matvec_univ_v3_plain(X.bfloat16(), Kp, Ke, p1)
        e_bf = relerr(ab, want_bf)
        say(f"[3 kernels] assoc_univ_v3 degree-80 star, transpose="
            f"{transpose}: S1={p1.s1}, err vs plain {e:.2e}, "
            f"bit-identical {bool(torch.equal(a, b))}; bf16 X err vs plain "
            f"{e_bf:.2e}, {values_off(ab, want_bf)} values beyond 1e-5 of "
            f"the range")
        if not e <= 1e-5 or not torch.equal(a, b):
            fail("assoc_univ_v3 disagrees on the degree-80 star")
        if not e_bf <= 1e-5:
            fail("assoc_univ_v3 disagrees on the degree-80 star, bf16 X")
        r = univ_case("degree-80 star", pts[0], pts[1], (s1, d1, s2, d2), X,
                      Kp, Ke, 8, 128, transpose, "highest")
        rows.append(r)
        say("[3 kernels] " + json.dumps(r))
    # zero-edge sides: graph 1 without edges (every slot a pad, b1 = 8),
    # then neither graph: the result is Kp X
    n, C = 130, 4
    empty = np.zeros(0, np.int32)
    _, s2, d2 = build_edges(rng.uniform(8, 232, size=(n, 2)))
    pts = rng.uniform(size=(2, n, 2)).astype(np.float32)
    X = torch.randn(n, n, C, device=DEV, generator=g)
    Kp = torch.randn(n, n, device=DEV, generator=g)
    for (a, b) in ((s2, d2), (empty, empty)):
        Ke = torch.zeros(0, len(a), device=DEV)
        plan = k4.plan_univ(pts[0], pts[1], empty, empty, a, b, r1=8,
                            r2=128, transpose=True).to(DEV)
        got = k4.assoc_matvec_univ(X, Kp, Ke, plan)
        torch.cuda.synchronize()
        e = relerr(got, Kp[..., None] * X)
        say(f"[3 kernels] assoc_univ zero-edge side, E2={len(a)}: "
            f"b1={plan.b1} b2={plan.b2}, err vs Kp*X = {e:.2e}")
        if not e <= 1e-6:
            fail("assoc_univ zero-edge case disagrees with the Kp diagonal")
    restore_counts(saved)
    del flush
    return rows


# ------------------------------------------------------------------- serving
def cli_config(n_max, e_max, univ, *flags):
    args = build_parser().parse_args(
        ["a", "b", "--n-max", str(n_max), "--e-max", str(e_max), "--univ",
         str(univ), *flags])
    return model_config_from_args(args)


def make_request(rng, kind, n_lo, n_hi):
    """(img1, P1, img2, P2): 240x320 grayscale uint8 images and keypoints.
    genuine = jittered copy; impostor = independent cloud; ragged = n1 != n2
    (a subset of the jittered copy)."""
    img = lambda: rng.integers(0, 256, size=(240, 320), dtype=np.uint8)
    n = int(rng.integers(n_lo, n_hi + 1))
    P1 = rng.uniform([8, 8], [312, 232], size=(n, 2)).astype(np.float32)
    if kind == "impostor":
        m = int(rng.integers(n_lo, n_hi + 1))
        P2 = rng.uniform([8, 8], [312, 232], size=(m, 2)).astype(np.float32)
    else:
        P2 = np.clip(P1 + rng.normal(0, 1.5, P1.shape), 0,
                     [319, 239]).astype(np.float32)
        if kind == "ragged":
            P2 = P2[:int(0.87 * n)]
    return img(), P1, img(), P2


def check_outputs(tag, result, out, n1, n2):
    for k, v in out.items():
        if not torch.isfinite(v).all():
            fail(f"{tag}: output {k} has non-finite values")
    perm = out["perm_mat"][0]
    if not ((perm == 0) | (perm == 1)).all():
        fail(f"{tag}: perm_mat is not 0/1")
    if perm.sum(0).max() > 1 or perm.sum(1).max() > 1:
        fail(f"{tag}: perm_mat row/column sums exceed 1")
    if perm[n1:].sum() != 0 or perm[:, n2:].sum() != 0:
        fail(f"{tag}: perm_mat has matches outside the valid block")
    m = min(n1, n2)
    k_round = int(torch.round(out["k_prob"][0] * float(m)))
    want = min(max(k_round, 0), m)
    if result["n_matched"] != want or int(perm.sum()) != want:
        fail(f"{tag}: n_matched {result['n_matched']} != round(k_pred) "
             f"clipped = {want}")
    if result["n_kpts"] != [n1, n2]:
        fail(f"{tag}: n_kpts {result['n_kpts']} != {[n1, n2]}")


def serve(tag, model, requests):
    times = []
    for kind, req in requests:
        torch.cuda.synchronize()
        t = time.time()
        result, out = match_arrays(model, *req, return_outputs=True)
        torch.cuda.synchronize()
        dt = time.time() - t
        times.append(dt)
        check_outputs(f"{tag} {kind}", result, out, len(req[1]), len(req[3]))
        say(f"[{tag}] {kind}: {dt * 1e3:.1f} ms  {json.dumps(result)}")
    return times


def phase_serve_univ(model):
    rng = np.random.default_rng(SEED + 1)
    requests = [("genuine (first request, includes warm-up)",
                 make_request(rng, "genuine", 540, 600)),
                ("genuine", make_request(rng, "genuine", 540, 600)),
                ("impostor", make_request(rng, "impostor", 500, 600)),
                ("ragged n1!=n2", make_request(rng, "ragged", 580, 600))]
    reset_counts()
    times = serve("4 serve univ", model, requests)
    launches = read_counts()
    want = 3 * len(requests)
    say(f"[4 serve univ] kernel launches on the main path: {launches} "
        f"(expected {want} of assoc_univ_v3: one per GNN layer per request)")
    if launches != {"assoc_univ_v3": want, "assoc_bucket": 0,
                    "assoc_large": 0, "assoc_univ": 0, "inoculate": 0,
                    "assoc_grad": 0}:
        fail("the UNIV route did not go through the assoc_univ_v3 kernel "
             "(and no other) once per GNN layer")
    say(f"[4 serve univ] wall ms per request after the first: "
        f"{[round(t * 1e3, 1) for t in times[1:]]}")
    return launches, times, requests[1][1]


def phase_profile(what, fn):
    """Optional (`--profile`): where the device time of one call of `fn` (a
    UNIV request, an evaluate batch) goes, by kernel name, from
    torch.profiler. Not part of the default run."""
    from torch.profiler import ProfilerActivity, profile

    saved = read_counts()
    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t
    restore_counts(saved)
    evs = [e for e in prof.key_averages() if e.device_time_total > 0
           and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in evs)
    n = sum(e.count for e in evs)
    say(f"[profile] {what} under the profiler: wall "
        f"{wall * 1e3:.1f} ms, device busy {total / 1e3:.1f} ms in {n} "
        f"kernel launches")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:14]:
        say(f"[profile] {e.device_time_total / 1e3:8.2f} ms {e.count:6d}x  "
            f"{e.key[:90]}")


@contextlib.contextmanager
def tf32_off():
    """Full-f32 convolutions and matmuls on the card, as on the CPU."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def cpu_copy(model, cfg):
    return build_model(cfg, device="cpu", state_dict={
        k: v.cpu() for k, v in model.state_dict().items()})


def compare_outputs(tag, out_g, out_c):
    """The card's outputs against the CPU's, with the limits stated below."""
    errs = {}
    for k in ("Kp", "raw_scores", "sinkhorn", "ds_mat", "cls_prob",
              "k_prob"):
        a, b = out_g[k].cpu().float(), out_c[k].float()
        errs[k] = {"max_abs": float((a - b).abs().max()),
                   "ref_max": float(b.abs().max())}
    pg, pc = out_g["perm_mat"].cpu(), out_c["perm_mat"]
    agree = float((pg == pc).all(dim=2).float().mean())
    say(f"[{tag}] gpu vs cpu: {json.dumps(errs)}")
    say(f"[{tag}] perm_mat rows identical: {agree:.4f}")
    # float32 on both sides with TF32 off; only the order of sums differs.
    # raw_scores pass three embedded Sinkhorns at tau = 0.01 (score
    # differences x100 before 20 normalization sweeps) and the final Sinkhorn
    # divides by tau once more, so rounding noise of ~1e-7 is amplified stage
    # by stage: limits are relative to each output's largest value.
    tol = {"Kp": 1e-5, "raw_scores": 1e-4, "sinkhorn": 1e-3}
    for k, rel in tol.items():
        lim = rel * max(errs[k]["ref_max"], 1e-30)
        if not errs[k]["max_abs"] <= lim:
            fail(f"{tag}: {k} differs by {errs[k]['max_abs']:.3e} > "
                 f"{lim:.3e}")
    for k in ("cls_prob", "k_prob"):
        if not errs[k]["max_abs"] <= 1e-3:
            fail(f"{tag}: {k} differs by {errs[k]['max_abs']:.3e} > 1e-3")
    return errs, agree


def phase_parity(model, cfg, req):
    """The card's result against the port's own CPU run (plain kernel
    version) of the same weights and inputs, TF32 off on both sides."""
    saved = read_counts()
    with tf32_off():
        res_g, out_g = match_arrays(model, *req, return_outputs=True)
        torch.cuda.synchronize()
    t = time.time()
    res_c, out_c = match_arrays(cpu_copy(model, cfg), *req,
                                return_outputs=True)
    say(f"[5 parity] CPU run (plain kernel version): {time.time() - t:.1f} s")
    restore_counts(saved)           # comparison launches do not count
    say(f"[5 parity] n_matched gpu {res_g['n_matched']} cpu "
        f"{res_c['n_matched']}")
    return compare_outputs("5 parity", out_g, out_c)


def phase_serve_bucket():
    cfg = cli_config(64, 384, 600)
    model = build_model(cfg, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    requests = [(k, make_request(rng, k, 40, 60))
                for k in ("genuine", "impostor", "ragged")]
    reset_counts()
    times = serve("6 serve bucket", model, requests)
    launches = read_counts()
    say(f"[6 serve bucket] kernel launches: {launches}")
    if launches["assoc_univ_v3"] != 0:
        fail("the bucket route must not launch the UNIV kernel")
    if launches["assoc_bucket"] != 3 * len(requests):
        fail("the bucket route must launch assoc_bucket 3 times per request")
    say(f"[6 serve bucket] wall ms per request: "
        f"{[round(t * 1e3, 1) for t in times]}")
    return times


# ---------------------------------------------------------------- evaluation
def eval_config(batch_size, n_max, e_max, *flags):
    """The Config `cli.evaluate` builds from its flags."""
    args = cli_evaluate.build_parser().parse_args(
        ["--batch-size", str(batch_size), "--n-max", str(n_max), "--e-max",
         str(e_max), *flags])
    cfg = model_config_from_args(args)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=batch_size))


def write_split(root, fingers, n_pores):
    """A synthetic test split (R4): `fingers` fingers x 2 sessions x 2
    stances, written by the port's generator from SEED."""
    t = time.time()
    generate_synthetic_dataset(root, fingers_per_split=(0, fingers, 0),
                               n_pores=n_pores, seed=SEED, sessions=2,
                               stances=2)
    return time.time() - t


def pair_dataset(root, cfg, index_dir):
    bench = make_benchmark("Synthetic", "test", root=root, task="classify",
                           output_dir=index_dir)
    return PairDataset(bench, cfg, augment=False)


def check_batch(tag, batch, out):
    """Finite outputs and a partial permutation inside each sample's valid
    block."""
    for k, v in out.items():
        if not torch.isfinite(v).all():
            fail(f"{tag}: output {k} has non-finite values")
    perm = out["perm_mat"]
    if not ((perm == 0) | (perm == 1)).all():
        fail(f"{tag}: perm_mat is not 0/1")
    if perm.sum(1).max() > 1 or perm.sum(2).max() > 1:
        fail(f"{tag}: perm_mat row/column sums exceed 1")
    N = perm.shape[1]
    ar = torch.arange(N, device=perm.device)
    valid = ((ar[None, :, None] < batch.n_nodes[:, 0, None, None])
             & (ar[None, None, :] < batch.n_nodes[:, 1, None, None]))
    if (perm * (~valid)).sum() != 0:
        fail(f"{tag}: perm_mat has matches outside the valid block")


class FirstFetch:
    """A loader seen through a stopwatch: how long the consumer waited for
    the first batch (worker start-up, first samples, first copy)."""

    def __init__(self, loader):
        self.loader, self.seconds = loader, None

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        t = time.time()
        for batch in self.loader:
            if self.seconds is None:
                self.seconds = time.time() - t
            yield batch


def run_evaluate(tag, model, loader, n_pairs, kernel, discretize="greedy"):
    """Drive cli.evaluate.evaluate_loader over the whole loader; `kernel`
    is the one the aggregations must go through, 3 launches per forward
    (two forwards per batch with `discretize="hungarian"`)."""
    seen = []
    loader = FirstFetch(loader)

    def on_batch(bi, batch, out):
        check_batch(f"{tag} batch {bi}", batch, out)
        seen.append(int(batch.label.shape[0]))

    reset_counts()
    torch.cuda.synchronize()
    t = time.time()
    res = cli_evaluate.evaluate_loader(model, loader, on_batch=on_batch,
                                       discretize=discretize)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_counts()
    n_batches = len(seen)
    say(f"[{tag}] {n_pairs} pairs in {n_batches} batches of sizes {seen}; "
        f"kernel launches on the main path: {launches}")
    if n_batches != len(loader) or sum(seen) != n_pairs:
        fail(f"{tag}: {sum(seen)} pairs in {n_batches} batches, expected "
             f"{n_pairs} in {len(loader)}")
    for k in ("labels", "scores", "cls_scores", "k_probs"):
        if len(res[k]) != n_pairs or not np.isfinite(res[k]).all():
            fail(f"{tag}: {k} has {len(res[k])} entries for {n_pairs} pairs "
                 f"or is not finite")
    ms = [round(x * 1e3, 1) for x in res["batch_seconds"]]
    steady = res["batch_seconds"][1:]
    say(f"[{tag}] wall ms per batch: first {ms[0]} (of which "
        f"{loader.seconds * 1e3:.1f} waiting for the loader's first batch), "
        f"then {ms[1:]}")
    say(f"[{tag}] {n_pairs / wall:.1f} pairs/s over the whole run (first "
        f"batch included), {sum(seen[1:]) / max(sum(steady), 1e-9):.1f} "
        f"pairs/s after the first batch")
    say(f"[{tag}] step metrics (random weights): "
        f"{json.dumps({k: round(v, 5) for k, v in res['metrics'].items()})}")
    say(f"[{tag}] report (random weights, says nothing about accuracy): "
        f"{json.dumps({k: round(v, 5) for k, v in res['report'].items()})}")
    want = {k: 0 for k in launches}
    want[kernel] = 3 * n_batches * (2 if discretize == "hungarian" else 1)
    if launches != want:
        fail(f"{tag}: expected {want}: {kernel} once per GNN layer per "
             f"forward and no other kernel")
    return launches, res, wall


def phase_evaluate(model, cfg, root, index_dir):
    """>= 8 full batches of 8 plus a short one, spawned worker processes,
    pinned + side-stream prefetch: the CLI's defaults."""
    pd = pair_dataset(root, cfg, index_dir)
    n = len(pd)
    if n < 65 or n % 8 == 0:
        fail(f"evaluate: {n} pairs do not make 8 full batches plus a short "
             f"one")
    loader = DataLoader(pd, cfg, drop_last=False, device=DEV,
                        device_prefetch=True, num_workers=4,
                        use_processes=True)
    try:
        launches, res, wall = run_evaluate("7 evaluate", model, loader, n,
                                           "assoc_bucket")
        if res["labels"].tolist() != [float(pd.bench.is_genuine(*p))
                                      for p in pd.pairs]:
            fail("evaluate: labels are not in pair order")
    finally:
        loader.close()
    return launches, res, pd


def phase_evaluate_parity(model, cfg, pd):
    """Every prefetched batch (pinned memory, side stream) against the same
    batch copied on the consumer's stream: bit for bit. Then one batch
    through the model on the card against the port's own CPU run of it,
    TF32 off."""
    kw = dict(drop_last=False, device=DEV, num_workers=4,
              use_processes=False)
    pre = DataLoader(pd, cfg, device_prefetch=True, **kw)
    plain = DataLoader(pd, cfg, device_prefetch=False, **kw)
    try:
        first, n = None, 0
        for a, b in zip(pre, plain):
            # keep the card busy on the consumer's stream while the next
            # batch's copy runs on the side stream
            torch.mm(torch.randn(2048, 2048, device=DEV),
                     torch.randn(2048, 2048, device=DEV))
            for name, x, y in zip(a._fields, a, b):
                if (x is None) != (y is None) or (
                        x is not None and not torch.equal(x, y)):
                    fail(f"evaluate parity: prefetched field {name} of batch "
                         f"{n} differs from the unprefetched one")
            first = first or a
            n += 1
    finally:
        pre.close()
        plain.close()
    say(f"[8 parity] {n} prefetched batches bit-identical to the "
        f"unprefetched ones")
    saved = read_counts()
    with tf32_off():
        out_g = model(first)
        torch.cuda.synchronize()
    t = time.time()
    out_c = cpu_copy(model, cfg)(first.to("cpu"))
    say(f"[8 parity] CPU run of one batch of {first.batch_size} (plain "
        f"kernel version): {time.time() - t:.1f} s")
    restore_counts(saved)
    return compare_outputs("8 parity", out_g, out_c), first


def phase_evaluate_large(root, index_dir):
    """Batches of 2 at n_max=256, e_max=1536: 2.36 M association edge slots
    per sample, where `assoc_matvec_auto` picks the any-size kernel."""
    cfg = eval_config(2, 256, 1536)
    if cfg.shapes.e_max ** 2 < CHUNKED_NNZ_THRESHOLD:
        fail("this configuration would not reach assoc_large")
    model = build_model(cfg, device="cuda", seed=SEED)
    pd = pair_dataset(root, cfg, index_dir)
    pd.pairs = pd.pairs[:3] + pd.pairs[-2:]       # 3 genuine + 2 impostors
    loader = DataLoader(pd, cfg, drop_last=False, device=DEV,
                        device_prefetch=True, num_workers=2,
                        use_processes=False)
    try:
        launches, res, _ = run_evaluate("9 evaluate large", model, loader,
                                        len(pd), "assoc_large")
    finally:
        loader.close()
    sample = pd.get(0)
    say(f"[9 evaluate large] keypoints of the first pair: "
        f"{[len(p) for p in sample.points]}")
    return launches, res


# ------------------------------------------------------------------ 10 tune
def phase_tune():
    """scripts.tune_univ's sweep, in this process, as its CLI runs it: the
    warm-up of every library, then 12 rows of K4 at n=600, C=16."""
    n_libs = len(_build.sources())
    reset_counts()
    t = time.time()
    rows = tune_univ.sweep("cuda", emit=lambda line: say("[10 tune] " + line))
    launches = read_counts()
    say(f"[10 tune] {len(rows)} rows in {time.time() - t:.1f} s; kernel "
        f"launches on the path: {launches}")
    if len(rows) != len(tune_univ.CONFIGS) * len(tune_univ.PRECS):
        fail("the sweep did not produce one row per (config, precision)")
    for r in rows:
        if not r["err_vs_plain"] <= 1e-5:
            fail(f"tune row disagrees with the plain version: {r}")
        if not r["bit_identical"]:
            fail(f"tune row: two calls on the same inputs differ: {r}")
    want = {k: 0 for k in launches}
    want.update(inoculate=n_libs, assoc_univ=launches["assoc_univ"])
    if launches != want or launches["assoc_univ"] == 0:
        fail(f"tune: expected {n_libs} inoculate launches and assoc_univ "
             f"launches, no other kernel (no assoc_bucket / assoc_large: "
             f"the spill terms are in assoc_univ)")
    best = max(rows, key=lambda r: r["edges_per_s"])
    say(f"[10 tune] best: {json.dumps(best)}")
    return launches, rows


# ---------------------------------------------------------------- 11 detect
def host_ms(fn, reps=10):
    """Median host-clock time of one call of a host function, in ms."""
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def detect_images():
    """Two 480x400 impressions of one finger from the port's generator, then
    the eight PolyU fixture test images (96x96) with their .tsv pores."""
    import cv2

    out = [(f"impression 3/{s}", render_impression(3, s)[0], None)
           for s in (1, 2)]
    for png in sorted(FIXTURE.glob("*.png")):
        gt = np.loadtxt(png.with_suffix(".tsv"), skiprows=1, usecols=(1, 2),
                        ndmin=2).astype(np.float32)
        out.append((png.name, cv2.imread(str(png), cv2.IMREAD_GRAYSCALE), gt))
    if len(out) != 10:
        fail(f"detect: {len(out) - 2} fixture images, expected 8")
    return out


def coord_set(c):
    return {tuple(r) for r in np.asarray(c).tolist()}


def split_changes(got, want):
    """The symmetric difference of two detections split into pores that
    moved by one pixel (a pore of `got` paired one to one with a pore of
    `want` at Chebyshev distance 1) and pores gained or lost."""
    gained = sorted(coord_set(got) - coord_set(want))
    lost = coord_set(want) - coord_set(got)
    moved = 0
    for x, y in gained:
        near = next((p for p in sorted(lost)
                     if max(abs(p[0] - x), abs(p[1] - y)) <= 1), None)
        if near is not None:
            lost.discard(near)
            moved += 1
    return {"moved_1px": moved, "gained": len(gained) - moved,
            "lost": len(lost)}


def phase_native():
    """The host-native library (g++ at first use, keyed by the host CPU):
    build / load time, then a batched OpenMP LAPJV solve in this process,
    where torch has run its threaded ops, against scipy's optimum."""
    from scipy.optimize import linear_sum_assignment

    path = native.library_path()
    built = not path.exists()
    t = time.time()
    native.get_lib()
    say(f"[11 detect] native library {path.name}: "
        f"{'built' if built else 'found'} and loaded in "
        f"{time.time() - t:.2f} s; torch threads {torch.get_num_threads()}")
    rng = np.random.default_rng(SEED)
    s = rng.normal(size=(32, 64, 64)).astype(np.float32)
    n = np.full(32, 64)
    out = native.lap_maximize_batch(s, n, n)
    for b in range(32):
        r, c = linear_sum_assignment(-s[b])
        if abs(float((out[b] * s[b]).sum()) - float(s[b][r, c].sum())) \
                > 1e-4 * 64:
            fail(f"native LAPJV: block {b} is not optimal")
    say(f"[11 detect] batched LAPJV (32 x 64 x 64, OpenMP) optimal on every "
        f"block; {host_ms(lambda: native.lap_maximize_batch(s, n, n), 5):.2f}"
        f" ms per batch")


def phase_detect():
    """The trained CNN detector (net17nomax, 40 features, 8 layers) on the
    card against the port's own CPU run of it: TF32 off, identical
    coordinates and the map within 1e-5; TF32 on (torch's default), the
    detections it changes. Forward ms per image by CUDA events, host NMS
    ms, candidate cells; the two DPF detectors' host seconds; the fixture
    F-score."""
    images = detect_images()
    t = time.time()
    model = load_detector("net17nomax", DETECTOR, device="cuda")
    cpu = load_detector("net17nomax", DETECTOR, device="cpu")
    say(f"[11 detect] net17nomax with the trained weights of "
        f"{DETECTOR.relative_to(ROOT)} on the card and the CPU in "
        f"{time.time() - t:.1f} s; cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    reset_counts()
    rows, changed, map_err = [], 0, 0.0
    split = {"moved_1px": 0, "gained": 0, "lost": 0}
    for name, img, _ in images:
        want, wmap = detect_pores_in_image(cpu, img)
        with tf32_off():
            got, gmap = detect_pores_in_image(model, img)
        err = float(np.abs(gmap - wmap).max())
        map_err = max(map_err, err)
        if not np.array_equal(got, want):
            fail(f"detect {name}: TF32 off, the card's {len(got)} pores "
                 f"differ from the CPU's {len(want)}")
        if not err <= 1e-5:
            fail(f"detect {name}: TF32 off, the map differs by {err:.3e}")
        tf32, tmap = detect_pores_in_image(model, img)
        n_changed = len(coord_set(tf32) ^ coord_set(want))
        changed += n_changed
        parts = split_changes(tf32, want)
        for k in split:
            split[k] += parts[k]
        x = torch.from_numpy(img.astype(np.float32))[None, None].to(DEV)

        def forward():
            with torch.inference_mode():
                model(x / 255.0)

        coords, scores = candidates(wmap, 0.65)
        row = {"image": name, "hw": list(img.shape), "map_hw": list(
            wmap.shape), "pores": len(want), "candidates": len(coords),
            "map_err_tf32_off": err,
            "map_err_tf32_on": float(np.abs(tmap - wmap).max()),
            "changed_tf32_on": n_changed, "tf32_split": parts,
            "forward_ms": time_ms(forward, reps=20),
            "nms_ms": host_ms(lambda: native.nms_fixed_boxes(
                coords, scores, 17, 0.2), reps=20),
            "detect_ms": host_ms(lambda: detect_pores_in_image(model, img),
                                 reps=5)}
        rows.append(row)
        say(f"[11 detect] {json.dumps(row)}")
    launches = read_counts()
    if any(launches.values()):
        fail(f"detect: the detector launched a kernel of the port: "
             f"{launches}")
    say(f"[11 detect] TF32 off: coordinates identical to the CPU run on "
        f"all {len(rows)} images, map within {map_err:.3e}; TF32 on: "
        f"{changed} detections changed (symmetric difference) of "
        f"{sum(r['pores'] for r in rows)}: {json.dumps(split)} (a moved "
        f"pore counts twice in the difference)")
    imgs = [img for _, img, gt in images if gt is not None]
    gts = [gt for *_, gt in images if gt is not None]
    kw = dict(window=17, probability=0.65, nms_iou=0.2)
    f_gpu = validate_full_images(model, imgs, gts, **kw)
    f_cpu = validate_full_images(cpu, imgs, gts, **kw)
    say(f"[11 detect] fixture F-score (8 images, prob 0.65, NMS 0.2): card "
        f"{json.dumps(f_gpu)}; CPU {json.dumps(f_cpu)}")
    if not f_gpu["f_score"] > 0:
        fail("detect: F-score 0 on the fixture")
    dpf_rows = []
    for name, img, _ in images[:2]:
        t = time.time()
        lem = detect_pores_lemes(img)
        first = time.time() - t
        dpf_rows.append({
            "image": name, "lemes_pores": len(lem),
            "lemes_first_s": first,
            "lemes_s": host_ms(lambda: detect_pores_lemes(img), 3) / 1e3,
            "dpf_pores": len(detect_pores_dpf(img)),
            "dpf_s": host_ms(lambda: detect_pores_dpf(img), 5) / 1e3})
        if not len(lem):
            fail(f"detect: Lemes DPF found no pore in {name}")
        say(f"[11 detect] DPF (host): {json.dumps(dpf_rows[-1])}")
    return rows, dpf_rows, changed


# ---------------------------------------------------- 12 serve bare images
def write_bare_pairs(tmp):
    """PNG files of generator impressions, no keypoint files: a genuine pair
    (finger 3, impressions 1 and 2) and an impostor pair (fingers 4, 5)."""
    import cv2

    path = {}
    for f, s in ((3, 1), (3, 2), (4, 1), (5, 1)):
        path[f, s] = f"{tmp}/f{f}_{s}.png"
        cv2.imwrite(path[f, s], np.stack([render_impression(f, s)[0]] * 3,
                                         -1))
    return [("genuine", path[3, 1], path[3, 2]),
            ("impostor", path[4, 1], path[5, 1])]


def serve_bare(tag, model, pairs, flags, kernel):
    """`cli.match` without keypoint files, as `main` runs it: `read_pair`
    with the detector of `flags`, then `match_arrays`. The wall time split
    into detection and matching; `kernel` 3 times per request."""
    reset_counts()
    walls = []
    for kind, a, b in pairs:
        args = build_parser().parse_args([a, b, *flags])
        det = make_detector(args)
        det_s = []

        def timed(gray):
            t = time.time()
            coords = det(gray)
            torch.cuda.synchronize()
            det_s.append(time.time() - t)
            return coords

        t = time.time()
        pair = read_pair(args, detector=timed)
        read_s = time.time() - t
        if isinstance(pair, dict):
            fail(f"{tag} {kind}: {pair}")
        (i1, P1), (i2, P2) = pair
        torch.cuda.synchronize()
        t = time.time()
        result, out = match_arrays(model, i1, P1, i2, P2,
                                   univ_kernel=args.univ_kernel,
                                   return_outputs=True)
        torch.cuda.synchronize()
        match_s = time.time() - t
        check_outputs(f"{tag} {kind}", result, out, len(P1), len(P2))
        walls.append({"kind": kind, "detect_s": det_s,
                      "read_s": read_s, "match_ms": match_s * 1e3})
        say(f"[{tag}] {kind}: detection {[round(x, 3) for x in det_s]} s "
            f"(read_pair {read_s:.3f} s), matching {match_s * 1e3:.1f} ms  "
            f"{json.dumps({k: result[k] for k in ('score', 'k_pred', 'n_kpts', 'n_matched')})}")
    launches = read_counts()
    want = {k: 0 for k in launches}
    want[kernel] = 3 * len(pairs)
    say(f"[{tag}] kernel launches: {launches}")
    if launches != want:
        fail(f"{tag}: expected {want}")
    return walls, launches


def phase_serve_bare(tmp):
    """Bare-image requests: two UNIV requests with the Lemes DPF detector
    (the CLI's default), two bucket requests with the trained CNN; then the
    entry point itself, `cli.match.main`, on the first pair."""
    pairs = write_bare_pairs(tmp)
    ucfg = cli_config(600, 3840, 600)
    umodel = build_model(ucfg, device="cuda", seed=SEED)
    uflags = ["--n-max", "600", "--e-max", "3840", "--univ", "600"]
    univ, _ = serve_bare("12 serve bare univ dpf", umodel, pairs, uflags,
                         "assoc_univ_v3")
    bflags = ["--detector", "cnn", "--detector-checkpoint", str(DETECTOR)]
    bmodel = build_model(cli_config(64, 384, 600), device="cuda", seed=SEED)
    bucket, _ = serve_bare("12 serve bare bucket cnn", bmodel, pairs, bflags,
                           "assoc_bucket")
    # the CLI entry point, weights from seed 0 as above: the same verdict
    argv = [pairs[0][1], pairs[0][2], *uflags, "--checkpoint-dir",
            f"{tmp}/no_checkpoint"]
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli_match.main(argv)
    wall = time.time() - t
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    args = build_parser().parse_args(argv)
    (i1, P1), (i2, P2) = read_pair(args)
    want = match_arrays(umodel, i1, P1, i2, P2)
    say(f"[12 serve bare] cli.match.main (dpf, UNIV, model built inside): "
        f"rc {rc}, {wall:.1f} s; {json.dumps(got)[:300]}")
    if rc != 0 or got["n_kpts"] != want["n_kpts"] or \
            got["n_matched"] != want["n_matched"] or \
            abs(got["score"] - want["score"]) > 1e-4:
        fail(f"cli.match.main gave {got}, the function path {want}")
    del umodel, bmodel
    torch.cuda.empty_cache()
    return {"univ_dpf": univ, "bucket_cnn": bucket}


# ------------------------------------------------------------ 13 hungarian
def hungarian_pieces(model, req, univ_kernel=None):
    """One request's --discretize hungarian in its parts: the first forward
    (to ds_mat on the host), the host LAPJV, the masked second pass.
    Returns (mask, second-pass outputs, seconds of each part)."""
    img1, P1, img2, P2 = req
    batch, plan = build_request(img1, P1, img2, P2, model.cfg, univ_kernel)
    batch = batch.to(next(model.parameters()).device)
    sync = torch.cuda.synchronize if batch.points.is_cuda else (lambda: 0)
    sync()
    t0 = time.time()
    ds = model(batch, univ_plan=plan)["ds_mat"].cpu().numpy()
    t1 = time.time()
    n1, n2 = batch.n_nodes[:, 0].cpu(), batch.n_nodes[:, 1].cpu()
    mask = hungarian_host(ds, n1, n2)
    t2 = time.time()
    _, out = make_eval_step_masked(model, default_stages()[-1],
                                   univ_plan=plan)(
        batch, torch.from_numpy(mask).to(batch.points.device))
    sync()
    t3 = time.time()
    lap_ms = host_ms(lambda: hungarian_host(ds, n1, n2), reps=5)
    return mask, out, {"first_ms": (t1 - t0) * 1e3, "lapjv_ms": lap_ms,
                       "second_ms": (t3 - t2) * 1e3, "n": list(ds.shape)}


def serve_hungarian(tag, model, requests, kernel):
    """Requests through `match_arrays(discretize="hungarian")`: `kernel` 6
    times per request (both passes); then each one again in its parts,
    every match inside the LAPJV mask, the entry point's matches equal to
    the parts'."""
    reset_counts()
    results = []
    for kind, req in requests:
        torch.cuda.synchronize()
        t = time.time()
        res, out = match_arrays(model, *req, discretize="hungarian",
                                return_outputs=True)
        torch.cuda.synchronize()
        wall = time.time() - t
        check_outputs(f"{tag} {kind}", res, out, len(req[1]), len(req[3]))
        results.append((kind, req, res, out, wall))
    launches = read_counts()
    want = {k: 0 for k in launches}
    want[kernel] = 6 * len(requests)
    say(f"[{tag}] kernel launches: {launches} (expected {want[kernel]} of "
        f"{kernel}: 3 per forward, two forwards per request)")
    if launches != want:
        fail(f"{tag}: the Hungarian second pass left the route: {launches}")
    rows = []
    for kind, req, res, out, wall in results:
        mask, out2, parts = hungarian_pieces(
            model, req, True if kernel == "assoc_univ_v3" else None)
        perm = out["perm_mat"].cpu().numpy()
        if (perm > mask).any():
            fail(f"{tag} {kind}: a match outside the LAPJV mask")
        if not np.array_equal(perm, out2["perm_mat"].cpu().numpy()):
            fail(f"{tag} {kind}: the entry point and its parts disagree")
        rows.append({"kind": kind, "wall_ms": wall * 1e3, **parts,
                     "n_matched": res["n_matched"], "k_pred": res["k_pred"],
                     "mask_size": int(mask.sum())})
        say(f"[{tag}] {kind}: {json.dumps(rows[-1])}")
    restore_counts(launches)        # the parts' launches do not count
    return rows, results


def phase_hungarian():
    """Two UNIV and two bucket requests with --discretize hungarian; one
    request of each route against the port's own CPU run, TF32 off."""
    ucfg = cli_config(600, 3840, 600)
    model = build_model(ucfg, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    ureq = [("genuine", make_request(rng, "genuine", 540, 600)),
            ("impostor", make_request(rng, "impostor", 500, 600))]
    urows, _ = serve_hungarian("13 hungarian univ", model, ureq,
                               "assoc_univ_v3")
    hungarian_vs_cpu("13 hungarian univ", model, ucfg, ureq[0][1], True)
    del model
    torch.cuda.empty_cache()
    bcfg = cli_config(64, 384, 600)
    bmodel = build_model(bcfg, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 4)
    breq = [(k, make_request(rng, k, 40, 60)) for k in ("genuine",
                                                         "ragged")]
    brows, _ = serve_hungarian("13 hungarian bucket", bmodel, breq,
                               "assoc_bucket")
    hungarian_vs_cpu("13 hungarian bucket", bmodel, bcfg, breq[0][1], None)
    return urows, brows


def hungarian_vs_cpu(tag, model, cfg, req, univ):
    """One `match_arrays(discretize="hungarian")` request on the card with
    TF32 off against the port's own CPU run: LAPJV mask and `perm_mat`
    identical, `cls_prob` and `k_prob` within 1e-3. Its launches do not
    count."""
    saved = read_counts()
    with tf32_off():
        mask_g, _, _ = hungarian_pieces(model, req, univ)
        res_g, out_g = match_arrays(model, *req, discretize="hungarian",
                                    return_outputs=True)
        torch.cuda.synchronize()
    t = time.time()
    cpu = cpu_copy(model, cfg)
    mask_c, _, _ = hungarian_pieces(cpu, req, univ)
    res_c, out_c = match_arrays(cpu, *req, discretize="hungarian",
                                return_outputs=True)
    say(f"[{tag}] CPU run of one request (plain kernel version, two "
        f"forwards + LAPJV, and its first pass again): "
        f"{time.time() - t:.1f} s")
    restore_counts(saved)
    rows_same = float((mask_g == mask_c).all(axis=2).mean())
    errs = {k: float((out_g[k].cpu() - out_c[k]).abs().max())
            for k in ("cls_prob", "k_prob", "ds_mat")}
    say(f"[{tag}] gpu vs cpu (TF32 off): LAPJV mask rows identical "
        f"{rows_same:.4f}, n_matched {res_g['n_matched']} / "
        f"{res_c['n_matched']}, {json.dumps(errs)}")
    if rows_same != 1.0 or not torch.equal(out_g["perm_mat"].cpu(),
                                           out_c["perm_mat"]):
        fail(f"{tag}: the card's mask or matches differ from the CPU run's")
    if res_g["matches"] != res_c["matches"] or max(
            errs["cls_prob"], errs["k_prob"]) > 1e-3:
        fail(f"{tag}: the card's result differs from the CPU run's")


def phase_evaluate_hungarian(cfg, pd):
    """evaluate_loader with discretize="hungarian" over the 70-pair split
    (B=8, n_max=64; thread workers): one score per pair, assoc_bucket 6
    times per batch; one batch against the port's CPU run, TF32 off."""
    model = build_model(cfg, device="cuda", seed=SEED)
    loader = DataLoader(pd, cfg, drop_last=False, device=DEV,
                        device_prefetch=True, num_workers=4,
                        use_processes=False)
    try:
        launches, res, wall = run_evaluate("14 evaluate hungarian", model,
                                           loader, len(pd), "assoc_bucket",
                                           discretize="hungarian")
    finally:
        loader.close()
    first = next(iter(DataLoader(pd, cfg, drop_last=False, device=DEV,
                                 num_workers=1, use_processes=False)))
    saved = read_counts()
    stage = default_stages()[-1]

    def two_passes(net, batch):
        _, out = make_eval_step(net, stage)(batch)
        mask = hungarian_host(out["ds_mat"], batch.n_nodes[:, 0],
                              batch.n_nodes[:, 1])
        dev = batch.points.device
        return mask, make_eval_step_masked(net, stage)(
            batch, torch.from_numpy(mask).to(dev))[1]

    with tf32_off():
        mask_g, out_g = two_passes(model, first)
        torch.cuda.synchronize()
    mask_c, out_c = two_passes(cpu_copy(model, cfg), first.to("cpu"))
    restore_counts(saved)
    rows_same = float((mask_g == mask_c).all(axis=2).mean())
    perm_same = torch.equal(out_g["perm_mat"].cpu(), out_c["perm_mat"])
    err = float((out_g["cls_prob"].cpu() - out_c["cls_prob"]).abs().max())
    say(f"[14 evaluate hungarian] one batch gpu vs cpu (TF32 off): LAPJV "
        f"mask rows identical {rows_same:.4f}, perm_mat identical "
        f"{perm_same}, cls_prob within {err:.3e}")
    if rows_same != 1.0 or not perm_same or err > 1e-3:
        fail("14 evaluate hungarian: the card's batch differs from the CPU "
             "run's")
    if (out_g["perm_mat"].cpu().numpy() > mask_g).any():
        fail("14 evaluate hungarian: a match outside the LAPJV mask")
    return launches, res, wall


# --------------------------------------------- 15 backward kernels (K6, K2/K3)
def grad_case(rng, B, N, E, C, n_lo, n_hi, transpose, flush, timed):
    """K6 (`assoc_edge_grad`) against its plain version; dX through K2 / K3
    with the roles swapped against the plain ops' transposed product; the
    whole `ops.assoc` Function's gradients against torch.autograd of the
    plain forward, all on the same CUDA inputs (padded, ragged, masked).
    Every comparison: within 1e-5 of the reference's range (f32 on both
    sides, only the order of sums differs); K6 bit-identical over two
    launches."""
    X, Kp, Ke, s1, d1, s2, d2, m1, m2, n_e = bucket_inputs(
        rng, B, N, E, C, n_lo, n_hi)
    g = torch.Generator(device=DEV).manual_seed(int(rng.integers(1 << 30)))
    dY = torch.randn(X.shape, device=DEV, generator=g)
    edges = (s1, d1, s2, d2)
    masks = dict(e1_mask=m1, e2_mask=m2)
    em = m1[:, :, None] & m2[:, None, :]
    got = k6.assoc_edge_grad(dY, X, *edges, transpose=transpose, **masks)
    again = k6.assoc_edge_grad(dY, X, *edges, transpose=transpose, **masks)
    want = k6.assoc_edge_grad_plain(dY, X, *edges, transpose=transpose,
                                    **masks)
    large = E * E >= CHUNKED_NNZ_THRESHOLD
    kern = k23.assoc_matvec_large if large else k23.assoc_matvec_bucket
    dX = kern(dY, Kp, Ke, *edges, transpose=not transpose, **masks)
    dX_plain = assoc_matvec(dY, Kp, Ke, *edges, transpose=not transpose)
    xs = [t.clone().requires_grad_() for t in (X, Kp, Ke)]
    ys = [t.clone().requires_grad_() for t in (X, Kp, Ke)]
    torch.autograd.backward(ops_assoc.assoc_matvec_auto(
        *xs, *edges, transpose=transpose, **masks), dY)
    torch.autograd.backward(assoc_matvec(*ys, *edges, transpose=transpose),
                            dY)
    torch.cuda.synchronize()
    geom = k6.grad_geometry(B, N, N, C, E, E, X.element_size())
    r = {"kernel": "assoc_grad", "B": B, "N": N, "E": E, "C": C,
         "transpose": transpose, "dX_kernel": "assoc_large" if large
         else "assoc_bucket", "path": geom.path, "passes": geom.passes,
         "assoc_edges": float((n_e[:, 0] * n_e[:, 1]).sum()),
         "err_vs_plain": max(relerr(got[0], want[0]),
                             relerr(got[1], want[1])),
         "max_abs_err": max(float((a - b).abs().max())
                            for a, b in zip(got, want)),
         "dX_err_vs_plain": relerr(dX, dX_plain),
         "fn_dX_err": relerr(xs[0].grad, ys[0].grad),
         "fn_dKp_err": relerr(xs[1].grad, ys[1].grad),
         "fn_dKe_err": relerr(xs[2].grad[em], ys[2].grad[em]),
         "fn_dKe_padded_zero": bool((xs[2].grad[~em] == 0).all()),
         "bit_reproducible": all(torch.equal(a, b)
                                 for a, b in zip(got, again))}
    for k in ("err_vs_plain", "dX_err_vs_plain", "fn_dX_err", "fn_dKp_err",
              "fn_dKe_err"):
        if not r[k] <= 1e-5:
            fail(f"backward {k} = {r[k]:.3e} > 1e-5 at {r}")
    if not (r["bit_reproducible"] and r["fn_dKe_padded_zero"]):
        fail(f"assoc_grad: two launches differ or padded dKe != 0: {r}")
    if timed:
        # least work for THIS input: dY and X read once, the edge lists and
        # masks once, dKe and dKp written once; 2 C flops per real
        # association edge and per cell
        nbytes = (4 * (2 * B * N * N * C + B * E * E + B * N * N)
                  + 4 * 4 * B * E + 2 * B * E)
        flops = 2.0 * C * r["assoc_edges"] + 2.0 * B * N * N * C
        call = lambda: k6.assoc_edge_grad(dY, X, *edges,
                                          transpose=transpose, **masks)
        dx_call = lambda: kern(dY, Kp, Ke, *edges, transpose=not transpose,
                               **masks)
        r.update(
            ms=time_ms(call, flush=flush),
            # the kernels alone (torch.profiler), without the wrappers' host
            # time that `ms` may hold
            kernel_ms=tune_univ.profiled_ms(call, "assoc_grad_kernel",
                                            flush=flush),
            plain_ms=time_ms(lambda: k6.assoc_edge_grad_plain(
                dY, X, *edges, transpose=transpose, **masks), reps=5,
                flush=flush),
            dX_ms=time_ms(dx_call, flush=flush),
            dX_kernel_ms=tune_univ.profiled_ms(
                dx_call, r["dX_kernel"] + "_kernel", flush=flush),
            bytes=nbytes, flops=flops, **bound(nbytes, flops))
        r.update(sddmm_library(dY, X, edges, transpose, n_e, want, flush))
        r.update(dx_library(dY, Kp, Ke, edges, transpose, n_e, dX_plain,
                            flush))
    return r


def dx_library(dY, Kp, Ke, edges, transpose, n_e, want, flush, bf16=False):
    """The dX launch's own bound and library call: K2 / K3 on dY with the
    roles swapped is the forward's function on other inputs, so its library
    call is `torch.sparse.mm` of K with the roles swapped (f32, on dY as
    the kernel reads it) and its bound the forward's bytes with dY for X
    (bf16 dY: read in 2 bytes, Kp = 0 still read)."""
    B, N, _, C = dY.shape
    E = Ke.shape[1]
    e_real = float((n_e[:, 0] * n_e[:, 1]).sum())
    index_bytes = 4 * B * (4 * E + 2 * (N + 1))
    nbytes = ((6 if bf16 else 8) * B * N * N * C + 4 * B * N * N
              + 4 * e_real + index_bytes)
    flops = 2.0 * C * e_real + 2.0 * B * N * N * C
    out = {}
    out["dX_bound_ms"], out["dX_bound_by"] = bound(nbytes, flops).values()
    roles = (edges[0], edges[1], edges[2], edges[3]) if transpose else \
        (edges[1], edges[0], edges[3], edges[2])
    lib = sparse_library(dY.float(), Kp, Ke, *roles, n_e)
    err = relerr(lib(), want)
    torch.cuda.synchronize()
    if not err <= 1e-5:
        fail(f"the dX library call disagrees with the plain version: "
             f"{err:.3e}")
    out["dX_library_ms"] = time_ms(lib, reps=10, flush=flush)
    if bf16:
        out.update({"dX_" + k: v for k, v in
                    library_bf16(lib.K, lib.X, flush).items()})
    return out


def sddmm_library(dY, X, edges, transpose, n_e, want, flush):
    """K6's library call: dKe and dKp are dY_flat @ X_flat^T (both
    (B·N1·N2, C)) sampled at K's nonzero pattern, the real (out1, out2) x
    (in1, in2) edge entries and the diagonal: one
    `torch.sparse.sampled_addmm` (cuSPARSE's SDDMM) over that pattern as a
    CSR matrix built here, outside the timing, as `sparse_library` builds K
    for the forward. Held against the plain version `want` (f32; bf16 X
    widened: the library has no bf16 rounding of the products) at 1e-5 of
    the range, then timed. A bf16 call (dY and X in bf16) is tried once:
    its time, or why cuSPARSE refused it."""
    B, N1, N2, C = X.shape
    M = B * N1 * N2
    out1, in1, out2, in2 = k6._roles(*edges, transpose)
    n_e = torch.as_tensor(np.asarray(n_e), device=DEV)
    keep = ((torch.arange(out1.shape[1], device=DEV)[None, :, None]
             < n_e[:, 0, None, None])
            & (torch.arange(out2.shape[1], device=DEV)[None, None, :]
               < n_e[:, 1, None, None]))
    base = torch.arange(B, device=DEV)[:, None, None] * (N1 * N2)
    at = lambda a, b: base + a.long()[:, :, None] * N2 + b.long()[:, None, :]
    rows, cols = at(out1, out2), at(in1, in2)
    diag = torch.arange(M, device=DEV)
    idx = torch.stack([torch.cat([rows[keep], diag]),
                       torch.cat([cols[keep], diag])])
    P = torch.sparse_coo_tensor(idx, torch.ones(idx.shape[1], device=DEV),
                                (M, M), check_invariants=False).coalesce()
    lin = P.indices()[0] * M + P.indices()[1]          # sorted, row-major
    P = P.to_sparse_csr()
    pos_e = torch.searchsorted(lin, (rows * M + cols)[keep])
    pos_d = torch.searchsorted(lin, diag * M + diag)
    Yf = dY.reshape(M, C)
    Xf = X.float().reshape(M, C)
    call = lambda: torch.sparse.sampled_addmm(P, Yf, Xf.t(), beta=0.0)
    vals = call().values()
    torch.cuda.synchronize()
    err = max(relerr(vals[pos_e], want[0][keep]),
              relerr(vals[pos_d], want[1].reshape(-1)))
    if not err <= 1e-5:
        fail(f"sampled_addmm disagrees with assoc_edge_grad's plain version:"
             f" {err:.3e}")
    out = {"library": "torch.sparse.sampled_addmm (f32, K's CSR pattern)",
           "library_err_vs_plain": err, "library_nnz": int(lin.numel()),
           "library_ms": time_ms(call, reps=10, flush=flush)}
    try:
        Pb, Yb, Xb = P.to(torch.bfloat16), Yf.bfloat16(), Xf.bfloat16()
        torch.sparse.sampled_addmm(Pb, Yb, Xb.t(), beta=0.0)
        torch.cuda.synchronize()
        out["library_bf16_ms"] = time_ms(
            lambda: torch.sparse.sampled_addmm(Pb, Yb, Xb.t(), beta=0.0),
            reps=10, flush=flush)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        # what the library offers is reported, not worked around
        out["library_bf16_ms"] = None
        out["library_bf16_refused"] = str(e).splitlines()[0][:200]
    return out


def phase_backward_kernels():
    rng = np.random.default_rng(SEED + 15)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEV)
    saved = read_counts()
    rows = []
    for C in (1, 17):
        for transpose in (True, False):
            rows.append(grad_case(rng, 8, 64, 384, C, 40, 64, transpose,
                                  flush, timed=transpose))
    rows.append(grad_case(rng, 2, 256, 1536, 17, 200, 256, True, flush,
                          timed=True))
    # K6's other paths: C=33 (two passes over each row's run, staged) and
    # C=64 at N=256 (two X rows over the staging budget: global memory)
    rows.append(grad_case(rng, 8, 64, 384, 33, 40, 64, True, flush,
                          timed=False))
    rows.append(grad_case(rng, 2, 256, 1536, 64, 200, 256, False, flush,
                          timed=False))
    for r in rows:
        say("[15 backward] " + json.dumps(r))
    paths = {r["path"] for r in rows}
    if paths != {"staged", "global"} or max(r["passes"] for r in rows) < 2:
        fail(f"phase 15 did not run every path of K6's launcher: {paths}")
    restore_counts(saved)
    del flush
    return rows


# ------------------------------------------ 18 the bf16 backward kernels
def ulps_off(got, want):
    """Entries of `got` further from `want` than one bf16 ulp of `want`
    (the spacing of bf16 at |want|) plus 1e-5 of want's range: both are f32
    sums taken in another order (within 1e-5 of the range) that are then
    rounded to bf16, which moves a result by at most one ulp more."""
    want = want.float()
    mag = want.abs().clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    lim = ulp + 1e-5 * float(want.abs().max())
    return int(((got.float() - want).abs() > lim).sum())


def grad_case_bf16(rng, B, N, E, C, n_lo, n_hi, transpose, flush):
    """The backward of the association matvec on bf16 X, on the card
    against the plain versions on the same inputs: K6's bf16 instantiation
    (`assoc_edge_grad` on bf16 X) and the K2 / K3 launch on X' = bf16(dY)
    with the roles swapped and Kp = 0 that makes dX, then the whole
    `ops.assoc` Function (its dX in bf16) against the same Function on a CPU
    copy (plain versions). Limits: dKe and the Function's dX and dKe within
    one bf16 ulp of each entry (they are rounded to bf16 after an f32 sum
    in another order); the f32 sums before that rounding, dKp and the K2 /
    K3 launch, within 1e-5 of the range; K6 and the dX launch bit-identical
    over two launches. Timed: K6, its plain version, the dX launch, the
    library call; bound with bf16 bytes for X."""
    X, Kp, Ke, s1, d1, s2, d2, m1, m2, n_e = bucket_inputs(
        rng, B, N, E, C, n_lo, n_hi)
    Xb = X.bfloat16()
    g = torch.Generator(device=DEV).manual_seed(int(rng.integers(1 << 30)))
    dY = torch.randn(X.shape, device=DEV, generator=g)
    edges = (s1, d1, s2, d2)
    masks = dict(e1_mask=m1, e2_mask=m2)
    em = m1[:, :, None] & m2[:, None, :]
    got = k6.assoc_edge_grad(dY, Xb, *edges, transpose=transpose, **masks)
    again = k6.assoc_edge_grad(dY, Xb, *edges, transpose=transpose, **masks)
    want = k6.assoc_edge_grad_plain(dY, Xb, *edges, transpose=transpose,
                                    **masks)
    large = E * E >= CHUNKED_NNZ_THRESHOLD
    kern = k23.assoc_matvec_large if large else k23.assoc_matvec_bucket
    zero = torch.zeros_like(Kp)
    dx_call = lambda: kern(dY.bfloat16(), zero, Ke, *edges,
                           transpose=not transpose, **masks)
    dX, dX_again = dx_call(), dx_call()
    dX_plain = assoc_matvec(dY.bfloat16(), zero, Ke, *edges,
                            transpose=not transpose)
    cards = [Xb.clone().requires_grad_(), Kp.clone().requires_grad_(),
             Ke.clone().requires_grad_()]
    cpus = [t.detach().cpu().requires_grad_() for t in cards]
    torch.autograd.backward(ops_assoc.assoc_matvec_auto(
        *cards, *edges, transpose=transpose, **masks), dY)
    torch.autograd.backward(ops_assoc.assoc_matvec_auto(
        *cpus, *(t.cpu() for t in edges), transpose=transpose,
        **{k: v.cpu() for k, v in masks.items()}), dY.cpu())
    torch.cuda.synchronize()
    fdX, fdKp, fdKe = (t.grad for t in cards)
    cdX, cdKp, cdKe = (t.grad.to(DEV) for t in cpus)
    r = {"kernel": "assoc_grad", "x_dtype": "bfloat16", "B": B, "N": N,
         "E": E, "C": C, "transpose": transpose,
         "dX_kernel": "assoc_large" if large else "assoc_bucket",
         "assoc_edges": float((n_e[:, 0] * n_e[:, 1]).sum()),
         "dKe_ulps_off": ulps_off(got[0], want[0]),
         "dKe_bf16_representable": bool(torch.equal(
             got[0].bfloat16().float(), got[0])),
         "dKp_err_vs_plain": relerr(got[1], want[1]),
         "err_vs_plain": max(relerr(got[0], want[0]),
                             relerr(got[1], want[1])),
         "max_abs_err": max(float((a - b).abs().max())
                            for a, b in zip(got, want)),
         "dX_err_vs_plain": relerr(dX, dX_plain),
         "fn_dX_dtype": str(fdX.dtype),
         "fn_dX_ulps_off": ulps_off(fdX, cdX),
         "fn_dKe_ulps_off": ulps_off(fdKe[em], cdKe[em]),
         "fn_dKp_err": relerr(fdKp, cdKp),
         "fn_dKe_padded_zero": bool((fdKe[~em] == 0).all()),
         "bit_reproducible": all(torch.equal(a, b)
                                 for a, b in zip(got, again))
         and torch.equal(dX, dX_again)}
    for k in ("dKp_err_vs_plain", "dX_err_vs_plain", "fn_dKp_err"):
        if not r[k] <= 1e-5:
            fail(f"bf16 backward {k} = {r[k]:.3e} > 1e-5 at {r}")
    for k in ("dKe_ulps_off", "fn_dX_ulps_off", "fn_dKe_ulps_off"):
        if r[k] != 0:
            fail(f"bf16 backward: {k} = {r[k]} entries beyond one bf16 ulp "
                 f"at {r}")
    if not (r["bit_reproducible"] and r["fn_dKe_padded_zero"]
            and r["dKe_bf16_representable"]
            and r["fn_dX_dtype"] == "torch.bfloat16"):
        fail(f"bf16 backward: not bit-identical, padded dKe != 0, dKe not "
             f"bf16 values or dX not bf16: {r}")
    # least work for THIS input: dY (f32) and X (bf16) read once, the edge
    # lists and masks once, dKe and dKp (f32) written once
    nbytes = (4 * B * N * N * C + 2 * B * N * N * C + 4 * B * E * E
              + 4 * B * N * N + 4 * 4 * B * E + 2 * B * E)
    flops = 2.0 * C * r["assoc_edges"] + 2.0 * B * N * N * C
    call = lambda: k6.assoc_edge_grad(dY, Xb, *edges, transpose=transpose,
                                      **masks)
    r.update(
        ms=time_ms(call, flush=flush),
        kernel_ms=tune_univ.profiled_ms(call, "assoc_grad_kernel",
                                        flush=flush),
        dX_kernel_ms=tune_univ.profiled_ms(
            dx_call, r["dX_kernel"] + "_kernel", flush=flush),
        plain_ms=time_ms(lambda: k6.assoc_edge_grad_plain(
            dY, Xb, *edges, transpose=transpose, **masks), reps=5,
            flush=flush),
        dX_ms=time_ms(dx_call, flush=flush),
        bytes=nbytes, flops=flops, **bound(nbytes, flops))
    plain_f32 = k6.assoc_edge_grad_plain(dY, Xb.float(), *edges,
                                         transpose=transpose, **masks)
    r.update(sddmm_library(dY, Xb, edges, transpose, n_e, plain_f32, flush))
    # the library has no bf16 rounding of the products: held against the
    # plain f32 product on the same bf16 values
    r.update(dx_library(dY.bfloat16(), zero, Ke, edges, transpose, n_e,
                        assoc_matvec(dY.bfloat16().float(), zero, Ke,
                                     *edges, transpose=not transpose),
                        flush, bf16=True))
    return r


def phase_backward_bf16():
    """Phase 18: the bf16 backward kernels at the training shapes (B=8,
    N=64, E=384; C=1 / 17, both orientations) and at B=2, N=256, E=1536
    (C=17, the dX through K3)."""
    rng = np.random.default_rng(SEED + 18)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEV)
    saved = read_counts()
    rows = []
    for C in (1, 17):
        for transpose in (True, False):
            rows.append(grad_case_bf16(rng, 8, 64, 384, C, 40, 64,
                                       transpose, flush))
    rows.append(grad_case_bf16(rng, 2, 256, 1536, 17, 200, 256, True, flush))
    for r in rows:
        say("[18 backward bf16] " + json.dumps(r))
    # K6's bf16 instantiation on its other paths: C=33 (two passes,
    # staged) and C=100 at N=256 (global memory), against the plain version
    paths = {k6.grad_geometry(8, 64, 64, 17, 384, 384, 2).path}
    for B, N, E, C, n_lo in ((8, 64, 384, 33, 40), (2, 256, 1536, 100, 200)):
        X, _, _, s1, d1, s2, d2, m1, m2, _ = bucket_inputs(
            rng, B, N, E, C, n_lo, N)
        Xb = X.bfloat16()
        dY = torch.randn(X.shape, device=DEV)
        args = (dY, Xb, s1, d1, s2, d2)
        masks = dict(e1_mask=m1, e2_mask=m2)
        got = k6.assoc_edge_grad(*args, transpose=True, **masks)
        again = k6.assoc_edge_grad(*args, transpose=True, **masks)
        want = k6.assoc_edge_grad_plain(*args, transpose=True, **masks)
        torch.cuda.synchronize()
        g = k6.grad_geometry(B, N, N, C, E, E, 2)
        paths.add(g.path)
        r = {"kernel": "assoc_grad", "x_dtype": "bfloat16", "B": B, "N": N,
             "C": C, "path": g.path, "passes": g.passes,
             "dKe_ulps_off": ulps_off(got[0], want[0]),
             "dKp_err_vs_plain": relerr(got[1], want[1]),
             "bit_reproducible": all(torch.equal(a, b)
                                     for a, b in zip(got, again))}
        say("[18 backward bf16] " + json.dumps(r))
        if r["dKe_ulps_off"] or not (r["dKp_err_vs_plain"] <= 1e-5
                                     and r["bit_reproducible"]):
            fail(f"K6 bf16 disagrees with its plain version: {r}")
    if paths != {"staged", "global"}:
        fail(f"phase 18 did not run every path of K6's launcher: {paths}")
    restore_counts(saved)
    del flush
    return rows


# --------------------------------------- 16 one train step: card against CPU
class GreedyTap:
    """Wraps models.ngm.greedy_perm_batch while installed: records what it
    returns (`record`), or returns the recorded picks after checking that it
    keeps as many matches (`replay`; with `same_count=False` the difference
    in the number of matches is only recorded). The greedy ranks a
    near-uniform map at random init, where ties at the 1e-6 level decide a
    pick; replaying the card's picks on the CPU keeps the comparison on the
    arithmetic."""

    def __init__(self, same_count=True):
        self.real = t_ngm.greedy_perm_batch
        self.picks = []
        self.mode = None
        self.same_count = same_count
        self.count_diffs = []

    def __call__(self, rank, ks, n1, n2):
        got = self.real(rank, ks, n1, n2)
        if self.mode == "record":
            self.picks.append(got.cpu())
            return got
        want = self.picks.pop(0)
        diff = (got.sum((1, 2)).cpu() - want.sum((1, 2))).tolist()
        self.count_diffs.append(diff)
        if self.same_count and any(diff):
            fail("16 train parity: the CPU keeps another number of matches")
        return want.to(got.device)

    def run(self, mode, fn):
        self.mode = mode
        t_ngm.greedy_perm_batch = self
        try:
            return fn()
        finally:
            t_ngm.greedy_perm_batch = self.real


class OutGradTap:
    """While installed on a model, records the gradient that reaches the
    output of the backbone (its taps: the node and edge feature maps that
    models/ngm.py aligns at the keypoints, and the global feature) and of
    every convolution, BatchNorm and max-pool of models/backbone.py, by
    name, in the order the forward ran them; and the forward output of each
    residual block (its final ReLU), to count the gates the two sides
    open differently."""

    def __init__(self, model):
        self.model = model
        self.grads = {}
        self.order = []
        self.acts = {}

    def _keep(self, name, t):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            self.order.append(name)
            t.register_hook(lambda g, name=name: self.grads.__setitem__(
                name, g.detach().float().cpu()))

    def __enter__(self):
        bb = self.model.backbone
        self.handles = []

        def taps(mod, inp, out):
            node_maps, edges, glob = out
            for i, m in enumerate(node_maps):
                self._keep(f"tap.node_map{i}", m)
            self._keep("tap.edge_map", edges)
            self._keep("tap.global_feat", glob)
        self.handles.append(bb.register_forward_hook(taps))
        kinds = (torch.nn.Conv2d, torch.nn.BatchNorm2d, torch.nn.MaxPool2d)
        for name, mod in bb.named_modules():
            if isinstance(mod, t_backbone.BasicBlock):
                self.handles.append(mod.register_forward_hook(
                    lambda m, i, o, name=name: self.acts.__setitem__(
                        name, o.detach().float().cpu())))
            if isinstance(mod, kinds):
                self.handles.append(mod.register_forward_hook(
                    lambda m, i, o, name=name: self._keep(
                        f"backbone.{name}", o)))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def top_down(self):
        """Names from the taps down to the first convolution."""
        taps = [n for n in self.order if n.startswith("tap.")]
        return taps + [n for n in reversed(self.order)
                       if not n.startswith("tap.")]


def backbone_layer_report(card, cpu):
    """Each recorded output gradient of the card against the CPU's, from
    the top down: max |card - cpu| over the CPU tensor's largest value, and
    the first layer past 1e-3 of it."""
    rows = []
    for n in cpu.top_down():
        a, b = card.grads.get(n), cpu.grads.get(n)
        if a is None or b is None:
            continue
        rows.append([n, float((a - b).abs().max())
                     / max(float(b.abs().max()), 1e-30)])
    first = next((n for n, e in rows if e > 1e-3), None)
    # residual blocks whose final ReLU is open on one side and shut on the
    # other, and how far from 0 the larger of the two values is there
    gates = {}
    for n, b in cpu.acts.items():
        a = card.acts[n]
        flip = (a > 0) != (b > 0)
        gates[n] = [int(flip.sum()), float(torch.maximum(a, b)[flip].max())
                    if flip.any() else 0.0, int(b.numel())]
    return {"rel_err_top_down": rows, "first_past_1e-3": first,
            "relu_gate_flips": gates}


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms and no autotuning, while in use."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved


def train_parity_config():
    """The training CLI's full-width model at sk_tau = 0.05 (as the CPU
    parity tests: the config's 0.01 multiplies rounding noise by 100 at
    each Sinkhorn stage) and batches of 2."""
    cfg = cli_train_config(2)
    return dataclasses.replace(cfg, ngm=dataclasses.replace(cfg.ngm,
                                                            sk_tau=0.05))


def cli_train_config(batch_size):
    """The Config `cli.train` builds from its defaults (full width)."""
    from fpmatch_tpu_torch.core.config import Config
    cfg = Config()
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=batch_size, image_channels=1))


def step_and_grads(model, batch, stage):
    state = create_state(model, stage)
    state, metrics = make_train_step(model, stage)(state, batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads


def compare_step(tag, stage, mg, mc, gg, gc, model_g, model_c, before_g,
                 before_c):
    """One train step's card results against the CPU's: loss terms, each
    gradient (the limits of `phase_train_parity`), BatchNorm statistics,
    frozen tensors. Returns (row, partition of each gradient, largest
    gradient per partition); `check_step` fails on the row."""
    part = {n: partition_of(n.split(".")[0]) for n in gc}
    pmax = {}
    for n, g in gc.items():
        pmax[part[n]] = max(pmax.get(part[n], 0.0), float(g.abs().max()))
    worst, cos = {}, {}
    for n, g in gc.items():
        if not torch.isfinite(gg[n]).all():
            fail(f"{tag}: {n} has non-finite gradients")
        if n.startswith(("afau.row_block.", "afau.final_row_")):
            continue
        scale = max(float(g.abs().max()), 1e-2 * pmax[part[n]])
        worst[n] = float((gg[n] - g).abs().max()) / scale
        # a direction only above the 1 % floor (below it, e.g. a bias
        # that feeds a Sinkhorn, the gradient is zero up to rounding)
        cos[n] = 1.0 if float(g.abs().max()) < 1e-2 * pmax[part[n]] \
            else float(torch.nn.functional.cosine_similarity(
                gg[n].double().reshape(-1), g.double().reshape(-1),
                dim=0))
    # the backbone's gradient passes 20 train-mode BatchNorm backwards
    # (each subtracts batch means: cancellation) and cuDNN's f32
    # convolution backward, which sums in another order than the CPU:
    # it is held to 10 % per element and a cosine of 0.999 per tensor;
    # every other partition to 1e-3
    bad_grad = {n: (e, cos[n]) for n, e in worst.items()
                if not (e <= (0.1 if part[n] == "backbone" else 1e-3)
                        and cos[n] >= 0.999)}
    loss_err = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6)
                for k in ("loss", "total_loss", "cls_loss", "ks_loss")}
    stats_err, frozen_changed = {}, []
    sd_g, sd_c = model_g.state_dict(), model_c.state_dict()
    for k, v in sd_c.items():
        top = k.split(".")[0]
        stat = k.endswith(("running_mean", "running_var"))
        if stat:        # BatchNorm in train mode: the backbone, the cls
            moves = (stage.train_main if top == "backbone"
                     else stage.train_cls)
        else:
            moves = k in gc
        if moves and stat:
            stats_err[k] = float((sd_g[k].cpu() - v).abs().max()) / \
                max(float(v.abs().max()), 1e-30)
        elif not moves and not (torch.equal(sd_g[k].cpu(), before_g[k])
                                and torch.equal(v, before_c[k])):
            frozen_changed.append(k)
    row = {"stage": stage.name, "loss_rel_err": loss_err,
           "grad_rel_err_max": max(worst.values()),
           "grad_rel_err_max_outside_backbone": max(
               (e for n, e in worst.items() if part[n] != "backbone"),
               default=0.0),
           "grad_cosine_min": min(cos.values()),
           "grad_rel_err_worst": sorted(worst.items(),
                                        key=lambda kv: -kv[1])[:3],
           "bn_stats_rel_err_max": max(stats_err.values(), default=0.0),
           "n_grads": len(gc), "frozen_changed": frozen_changed,
           "bad_grad": bad_grad}
    return row, part, pmax


def check_step(tag, row, gg, gc):
    """Fail on a `compare_step` row: loss terms 1e-4 of their value (ks_loss
    and the total that holds it 1e-2), the gradient limits, BatchNorm
    statistics 1e-4, frozen tensors untouched, the same tensors trained."""
    loss_err = row["loss_rel_err"]
    if any(not e <= (1e-2 if k in ("ks_loss", "total_loss") else 1e-4)
           for k, e in loss_err.items()):
        fail(f"{tag}: loss terms differ: {loss_err}")
    if row["bad_grad"]:
        fail(f"{tag}: gradients differ: {row['bad_grad']}")
    if not row["bn_stats_rel_err_max"] <= 1e-4:
        fail(f"{tag}: BatchNorm statistics differ")
    if row["frozen_changed"]:
        fail(f"{tag}: frozen tensors changed: {row['frozen_changed'][:5]}")
    if set(gg) != set(gc):
        fail(f"{tag}: the card and the CPU trained other parameters")


def phase_train_parity():
    """Stage 1 (grad clip; backbone, trunk and classifier train) and then
    stage 2 (k head only) one step each, on the card and on the port's CPU
    path, same weights and batch, TF32 off. Limits: loss terms 1e-4 of
    their value (ks_loss and the total that holds it 1e-2: the AFA-U head
    magnifies rounding ~300x on a near-uniform Sinkhorn map, and the card's
    atomics make it vary by 5e-4 - 1e-3 from run to run); each gradient 1e-3 of its tensor's largest
    value (a tensor below 1 % of its partition's largest is held at that
    1 % level), the backbone's 0.1 (see below), and a cosine of 0.999 per
    tensor; the AFA-U row half, float32-noise-bound at init, to finiteness;
    BatchNorm running statistics 1e-4 of their range; frozen parameters and
    statistics bit for bit."""
    cfg = train_parity_config()
    model_g = build_model(cfg, device="cuda", seed=SEED)
    model_c = cpu_copy(model_g, cfg)
    host = synthetic_pair_batch(cfg, 2, genuine_ratio=0.5, n_range=(40, 60),
                                seed=SEED + 16)
    bg, bc = host.to(DEV), host.to("cpu")
    saved = read_counts()
    tap = GreedyTap()
    out = {}
    for i, stage in enumerate(default_stages()[:2]):
        before_g = {k: v.detach().cpu().clone()
                    for k, v in model_g.state_dict().items()}
        before_c = {k: v.clone() for k, v in model_c.state_dict().items()}
        first = i == 0
        # stage 1 (the backbone trains): the gradient at the backbone's
        # taps and at each of its layers, and the same step again on the
        # card with cuDNN's deterministic algorithms
        model_d = copy.deepcopy(model_g) if first else None
        taps_g, taps_c = OutGradTap(model_g), OutGradTap(model_c)
        with tf32_off(), (taps_g if first else contextlib.nullcontext()):
            t = time.time()
            mg, gg = tap.run("record",
                             lambda: step_and_grads(model_g, bg, stage))
            torch.cuda.synchronize()
            t_g = time.time() - t
        picks = list(tap.picks)
        t = time.time()
        with taps_c if first else contextlib.nullcontext():
            mc, gc = tap.run("replay",
                             lambda: step_and_grads(model_c, bc, stage))
        t_c = time.time() - t
        row, part, pmax = compare_step("16 train parity", stage, mg, mc, gg,
                                       gc, model_g, model_c, before_g,
                                       before_c)
        row.update(card_s=t_g, cpu_s=t_c)
        say("[16 train parity] " + json.dumps(row))
        if first:
            row["backbone_diagnostic"] = backbone_diagnostic(
                model_d, bg, stage, picks, taps_g, taps_c, gg, gc, part,
                pmax)
            del model_d
        check_step("16 train parity", row, gg, gc)
        out[stage.name] = row
    restore_counts(saved)
    return out


def backbone_diagnostic(model_d, batch, stage, picks, taps_g, taps_c, gg,
                        gc, part, pmax):
    """Queue C 2, phase 16's stage-1 step: the backbone's gradient on the
    card against the CPU, from the top down — the gradient at the taps,
    then at each convolution, BatchNorm and max-pool of the backbone — as
    phase 16 ran it (cuDNN's defaults, TF32 off) and again on a copy of the
    same weights with cuDNN's deterministic algorithms and no autotuning,
    the same batch and picks. Reported, not held: each layer's error over
    its largest value, the first layer past 1e-3, and the backbone's worst
    parameter gradient in both runs."""
    tap = GreedyTap(same_count=False)
    tap.picks = list(picks)
    taps_d = OutGradTap(model_d)
    with tf32_off(), cudnn_deterministic(), taps_d:
        _, gd = tap.run("replay", lambda: step_and_grads(model_d, batch,
                                                         stage))
        torch.cuda.synchronize()

    def worst(gg):
        errs = {n: float((gg[n] - g).abs().max()) / max(
            float(g.abs().max()), 1e-2 * pmax[part[n]])
            for n, g in gc.items() if part[n] == "backbone"}
        return sorted(errs.items(), key=lambda kv: -kv[1])[:3]

    rep = {"default": backbone_layer_report(taps_g, taps_c),
           "deterministic": backbone_layer_report(taps_d, taps_c),
           "param_worst_default": worst(gg),
           "param_worst_deterministic": worst(gd),
           "match_count_cpu_minus_card_deterministic": tap.count_diffs}
    for k in ("default", "deterministic"):
        r = rep[k]
        say(f"[16 backbone {k}] first layer past 1e-3 of its largest "
            f"value: {r['first_past_1e-3']}; top down: "
            + json.dumps([[n, round(e, 6)] for n, e in
                          r["rel_err_top_down"]]))
        say(f"[16 backbone {k}] residual blocks' ReLU gates open on one "
            f"side only [count, largest value there, elements]: "
            + json.dumps(r["relu_gate_flips"]))
    say("[16 backbone] worst parameter gradients, default / deterministic: "
        + json.dumps([rep["param_worst_default"],
                      rep["param_worst_deterministic"]]))
    return rep


def profile_train_step():
    """`--profile`: one stage-1 train step at full width, B=8 (n_max 64),
    after one warm-up step, under torch.profiler."""
    cfg = cli_train_config(8)
    model = build_model(cfg, device="cuda", seed=SEED)
    batch = synthetic_pair_batch(cfg, 8, genuine_ratio=0.5, n_range=(40, 60),
                                 seed=SEED + 17).to(DEV)
    stage = default_stages()[0]
    state = create_state(model, stage)
    step = make_train_step(model, stage)
    step(state, batch)
    phase_profile("one train step, stage 1, B=8, full width",
                  lambda: step(state, batch))


# ------------------------------------------------- 17 cli.train at full width
def stage_counter(rows):
    """on_stage_end for cli.train: the kernel launches of each stage (the
    deltas of the counts, which are not reset between stages)."""
    last = read_counts()
    bwd_last = dict(ops_assoc.BACKWARD_LAUNCHES)

    def cb(stage, hist):
        nonlocal last, bwd_last
        now = read_counts()
        bwd = dict(ops_assoc.BACKWARD_LAUNCHES)
        d = {k: now[k] - last[k] for k in now}
        db = {k: bwd[k] - bwd_last[k] for k in bwd}
        h = hist[-1]
        row = {"stage": stage.name,
               "train_step_ms": h.get("train_step_ms"),
               "train_pairs_per_s": h.get("train_pairs_per_s"),
               "train_total_loss": h["train_total_loss"],
               "val_total_loss": h["val_total_loss"],
               "assoc_bucket_forward": d["assoc_bucket"] - db["assoc_bucket"],
               "assoc_bucket_backward": db["assoc_bucket"],
               "assoc_grad": d["assoc_grad"],
               "other_launches": {k: v for k, v in d.items() if v and k not in
                                  ("assoc_bucket", "assoc_grad")}}
        rows.append(row)
        say("[17 train] " + json.dumps(row))
        last, bwd_last = now, bwd
    return cb


def run_cli_train(tag, argv):
    rows = []
    reset_counts()
    for k in ops_assoc.BACKWARD_LAUNCHES:
        ops_assoc.BACKWARD_LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t = time.time()
    report = cli_train.main(argv, on_stage_end=stage_counter(rows))
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_counts()
    say(f"[{tag}] cli.train {' '.join(argv)}: {wall:.1f} s; kernel launches "
        f"on the main path: {launches}")
    for r in rows:
        trunk = r["stage"] in ("stage1", "stage3", "stage5")
        if not np.isfinite(r["train_total_loss"]):
            fail(f"{tag}: non-finite loss in {r['stage']}")
        if (r["assoc_grad"] > 0) != trunk or \
                (r["assoc_bucket_backward"] > 0) != trunk:
            fail(f"{tag}: K6 / K2 backward launches in {r['stage']} must be "
                 f"> 0 exactly in stages 1, 3, 5: {r}")
        if r["assoc_bucket_forward"] <= 0 or r["other_launches"]:
            fail(f"{tag}: {r['stage']} must run K2 forward and no other "
                 f"kernel: {r}")
    if not all(np.isfinite(v) for v in report.values()):
        fail(f"{tag}: the final test report is not finite: {report}")
    say(f"[{tag}] final test report (random init, a few steps): "
        f"{json.dumps({k: round(v, 5) for k, v in report.items()})}")
    return rows, report, launches, wall


def phase_train(tmp):
    """`cli.train` through all six stages at full width (n_max 64, e_max
    384, batches of 8, ResNet-18) on a synthetic split written here (60
    pores), 32 training pairs per epoch, one epoch, one pass: 4 steps a
    stage, thread workers (step times without first-use costs are phase
    30's and 32's); the checkpoints load back; then `--smoke` once."""
    root = f"{tmp}/train/Synthetic"
    t = time.time()
    generate_synthetic_dataset(root, fingers_per_split=(16, 6, 4),
                               n_pores=60, seed=SEED, size=(320, 280))
    say(f"[17 train] synthetic split (16 / 6 / 4 fingers, 60 pores) "
        f"written in {time.time() - t:.1f} s")
    argv = ["--data-root", root, "--stages", "1,2,3,4,5,6", "--epochs", "1",
            "--passes", "1", "--length", "32", "--thread-workers",
            "--checkpoint-dir", f"{tmp}/train/ckpt1", "--test-length", "16",
            "--seed", str(SEED)]
    runs = [run_cli_train("17 train run 1", argv)]
    # the checkpoints load back into a model of the same config
    cfg = cli_train_config(8)
    for name in ("stage1_best", "stage6_last"):
        sd = restore_params(f"{tmp}/train/ckpt1", name)
        build_model(cfg, device="cuda", state_dict=sd)
    say("[17 train] checkpoints stage1_best and stage6_last load back")
    smoke = run_cli_train("17 train smoke",
                          ["--smoke", "--thread-workers", "--checkpoint-dir",
                           f"{tmp}/train/smoke"])
    return runs, smoke


# ------------------------------------------------- 19-21 --bf16 end to end
class DtypeTap:
    """While installed, records the dtype of X at every launch of K1, K2,
    K3 and K6 (their launch functions, wrapped; the wrappers' own counts
    are untouched): proof that a bf16 run launched the bf16 instantiations
    and no f32 one."""

    SITES = ((k1, "_launch", "assoc_univ_v3"),
             (k23, "_launch_bucket", "assoc_bucket"),
             (k23, "_launch_large", "assoc_large"),
             (k6, "_launch", "assoc_grad"))

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        self.real = []
        for mod, fn, name in self.SITES:
            real = getattr(mod, fn)
            self.real.append((mod, fn, real))
            x_arg = 1 if name == "assoc_grad" else 0   # K6 takes (dY, X, ...)

            def tap(*a, real=real, name=name, x_arg=x_arg, **k):
                self.seen.setdefault(name, set()).add(str(a[x_arg].dtype))
                return real(*a, **k)
            setattr(mod, fn, tap)
        return self

    def __exit__(self, *exc):
        for mod, fn, real in self.real:
            setattr(mod, fn, real)

    def only_bf16(self, tag):
        bad = {k: v for k, v in self.seen.items() if v != {"torch.bfloat16"}}
        if bad or not self.seen:
            fail(f"{tag}: kernels launched on other than bf16 X: {self.seen}")
        return {k: sorted(v) for k, v in self.seen.items()}


def bf16_vs_cpu(tag, model, model32, cfg, req):
    """One --bf16 request on the card (TF32 off) against the port's CPU run
    of it in bf16. Kp is held within 2**-6 of its range (bf16 operands that
    the card's and the CPU's convolutions and matmuls round after sums in
    another order, through a 768-wide product); the distance of the card's
    f32 Kp (same weights) is printed beside it, and what the three embedded
    Sinkhorns at tau = 0.01 amplify downstream is reported. That the card
    ran bf16 is shown by the X dtypes of its kernel launches (DtypeTap)."""
    saved = read_counts()
    with tf32_off():
        _, out_g = match_arrays(model, *req, return_outputs=True)
        _, out_32 = match_arrays(model32, *req, return_outputs=True)
        torch.cuda.synchronize()
    t = time.time()
    _, out_c = match_arrays(cpu_copy(model, cfg), *req, return_outputs=True)
    cpu_s = time.time() - t
    restore_counts(saved)
    errs = {k: {"max_abs": float((out_g[k].cpu().float()
                                  - out_c[k].float()).abs().max()),
                "ref_max": float(out_c[k].abs().max())}
            for k in ("Kp", "raw_scores", "sinkhorn", "ds_mat", "cls_prob",
                      "k_prob")}
    kp32 = float((out_32["Kp"].cpu() - out_c["Kp"]).abs().max())
    agree = float((out_g["perm_mat"].cpu() == out_c["perm_mat"]).all(
        dim=2).float().mean())
    row = {"errs": errs, "Kp_f32_card_vs_bf16_cpu": kp32,
           "perm_rows_identical": agree, "cpu_s": cpu_s}
    say(f"[{tag}] gpu bf16 vs cpu bf16: {json.dumps(row)}")
    if not errs["Kp"]["max_abs"] <= 2.0 ** -6 * errs["Kp"]["ref_max"]:
        fail(f"{tag}: Kp differs from the CPU's bf16 run: {errs['Kp']}")
    return row


def phase_serve_bf16(tmp, t_univ32, t_bucket32):
    """Phase 19: `cli.match --bf16` at full width, the weights of phases 4
    and 6 (seed 0) and their requests: 4 UNIV requests (K1 on bf16
    features, 3 launches each), 3 bucket requests (K2 bf16, 3 each), wall ms
    beside the f32 ones of this call; one request of each route against the
    CPU in bf16; then `cli.match.main` with `--bf16` once."""
    out = {}
    routes = (("univ", (600, 3840, 600), SEED + 1, "assoc_univ_v3",
               t_univ32),
              ("bucket", (64, 384, 600), SEED + 2, "assoc_bucket",
               t_bucket32))
    for route, shape, seed, kernel, t32 in routes:
        tag = f"19 serve bf16 {route}"
        cfg = cli_config(*shape, "--bf16")
        if (cfg.backbone.dtype, cfg.ngm.compute_dtype) != ("bfloat16",) * 2:
            fail(f"{tag}: --bf16 did not reach the config")
        model = build_model(cfg, device="cuda", seed=SEED)
        rng = np.random.default_rng(seed)
        if route == "univ":
            requests = [("genuine (first request, includes warm-up)",
                         make_request(rng, "genuine", 540, 600)),
                        ("genuine", make_request(rng, "genuine", 540, 600)),
                        ("impostor", make_request(rng, "impostor", 500, 600)),
                        ("ragged n1!=n2",
                         make_request(rng, "ragged", 580, 600))]
        else:
            requests = [(k, make_request(rng, k, 40, 60))
                        for k in ("genuine", "impostor", "ragged")]
        reset_counts()
        with DtypeTap() as tap:
            times = serve(tag, model, requests)
        launches = read_counts()
        want = {k: 0 for k in launches}
        want[kernel] = 3 * len(requests)
        say(f"[{tag}] kernel launches: {launches}; X dtypes "
            f"{tap.only_bf16(tag)}")
        if launches != want:
            fail(f"{tag}: expected {want}")
        say(f"[{tag}] wall ms per request, bf16 {[round(t * 1e3, 1) for t in times]}"
            f" beside f32 (phase {4 if route == 'univ' else 6}) "
            f"{[round(t * 1e3, 1) for t in t32]}")
        model32 = build_model(cli_config(*shape), device="cuda", seed=SEED)
        parity = bf16_vs_cpu(tag, model, model32, cfg,
                             requests[1 if route == "univ" else 0][1])
        out[route] = {"ms_bf16": [t * 1e3 for t in times],
                      "ms_f32": [t * 1e3 for t in t32], "launches": launches,
                      "parity": parity}
        del model32
        if route == "univ":
            umodel = model
        else:
            del model
    # the entry point with --bf16 on a bare-image pair (DPF, UNIV route)
    pairs = write_bare_pairs(tmp)
    argv = [pairs[0][1], pairs[0][2], "--n-max", "600", "--e-max", "3840",
            "--univ", "600", "--checkpoint-dir", f"{tmp}/no_checkpoint",
            "--bf16"]
    buf = io.StringIO()
    reset_counts()
    t = time.time()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli_match.main(argv)
    wall = time.time() - t
    launches = read_counts()
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    (i1, P1), (i2, P2) = read_pair(build_parser().parse_args(argv))
    want = match_arrays(umodel, i1, P1, i2, P2)
    say(f"[19 serve bf16] cli.match.main --bf16 (dpf, UNIV): rc {rc}, "
        f"{wall:.1f} s, launches {launches}; {json.dumps(got)[:300]}")
    if rc != 0 or launches["assoc_univ_v3"] != 3 or \
            got["n_kpts"] != want["n_kpts"] or \
            got["n_matched"] != want["n_matched"] or \
            abs(got["score"] - want["score"]) > 1e-4:
        fail(f"cli.match.main --bf16 gave {got}, the function path {want}")
    out["main"] = {"rc": rc, "wall_s": wall}
    del umodel
    torch.cuda.empty_cache()
    return out


def phase_evaluate_bf16(pd32, root_large, index_dir, res7, res9):
    """Phase 20: `evaluate --bf16` (`cli.evaluate`'s config with the flag,
    seed-0 weights) over phase 7's 70-pair split in batches of 8 at n_max 64
    (K2 on bf16 features) and phase 9's 5 pairs in batches of 2 at n_max
    256 (K3), each with thread workers (phase 7 drives the spawned
    workers, whose start-up took some 40 s of the first batch here too);
    pairs/s after the first batch beside the f32 runs of phases 7 and 9."""
    out = {}
    for tag, shape, kernel, res32, workers, processes in (
            ("20 evaluate bf16", (8, 64, 384), "assoc_bucket", res7, 4,
             False),
            ("20 evaluate bf16 large", (2, 256, 1536), "assoc_large", res9,
             2, False)):
        cfg = eval_config(*shape, "--bf16")
        model = build_model(cfg, device="cuda", seed=SEED)
        if kernel == "assoc_bucket":
            pd = PairDataset(pd32.bench, cfg, augment=False)
        else:
            pd = pair_dataset(root_large, cfg, index_dir)
            pd.pairs = pd.pairs[:3] + pd.pairs[-2:]
        loader = DataLoader(pd, cfg, drop_last=False, device=DEV,
                            device_prefetch=True, num_workers=workers,
                            use_processes=processes)
        try:
            with DtypeTap() as tap:
                launches, res, wall = run_evaluate(tag, model, loader,
                                                   len(pd), kernel)
        finally:
            loader.close()
        rate = lambda r, bs: (len(r["labels"]) - bs) / sum(
            r["batch_seconds"][1:])
        row = {"pairs": len(pd), "launches": launches,
               "x_dtypes": tap.only_bf16(tag),
               "pairs_per_s_after_first_bf16": rate(res, shape[0]),
               "pairs_per_s_after_first_f32": rate(res32, shape[0]),
               "ms_per_batch_bf16": [x * 1e3 for x in res["batch_seconds"]],
               "ms_per_batch_f32": [x * 1e3 for x in res32["batch_seconds"]]}
        say(f"[{tag}] {json.dumps(row)}")
        out[kernel] = row
        del model
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_assoc():
    """The association matvec's plain versions (forward, dX and K6) in place
    of its kernels inside ops.assoc, while in use: a diagnostic only."""
    plain = {"assoc_matvec_bucket": k23.assoc_matvec_bucket_plain,
             "assoc_matvec_large": k23.assoc_matvec_large_plain,
             "assoc_edge_grad": k6.assoc_edge_grad_plain}
    real = {n: getattr(ops_assoc, n) for n in plain}
    for n, f in plain.items():
        setattr(ops_assoc, n, f)
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(ops_assoc, n, f)


# phase 21: the card's bf16 gradient may be further from the f32 step's than
# the CPU's bf16 gradient by at most this much in cosine, per partition
# (the reason is in CHANGES.md)
F32_MARGIN = 0.02


def cosine(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.double().reshape(-1), b.double().reshape(-1), dim=0))


def bf16_step_diagnostic(model_f, model_p, host, stage, picks, gg, gc):
    """Queue C 1, phase 21's bf16 step: (a) the f32 step of the same
    weights, batch and picks on the card as the yardstick: each partition's
    and each tensor's cosine to it, of the card's bf16 gradient and of the
    CPU's (per tensor only above phase 16's floor: 1 % of its partition's
    largest f32 gradient; the tensors below it are listed); (b) the same
    bf16 step on the card with the association matvec's plain versions in
    place of K2 / K3 / K6 (no kernel launched), against the kernels' run;
    (c) for each tensor below the floor: the f32 step's card-vs-CPU cosine
    (the CPU's f32 step replays the same picks), each side's bf16 cosine
    to its own f32 step, the two bf16 sides' cosine and (b)'s."""
    def replay(model, ctx, dev=DEV):
        tap = GreedyTap(same_count=False)
        tap.picks = list(picks)
        with tf32_off(), ctx:
            _, grads = tap.run("replay", lambda: step_and_grads(
                model, host.to(dev), stage))
            torch.cuda.synchronize()
        return grads, tap.count_diffs

    gf, counts_f = replay(model_f, contextlib.nullcontext())
    gfc, _ = replay(cpu_copy(model_f, train_parity_config()),
                    contextlib.nullcontext(), "cpu")
    before = read_counts()
    gp, counts_p = replay(model_p, plain_assoc())
    launched = {k: v - before[k] for k, v in read_counts().items()
                if v != before[k]}
    if launched:
        fail(f"21 diagnostic: kernels launched with the plain versions in "
             f"place: {launched}")
    parts = {}
    for n in gf:
        parts.setdefault(partition_of(n.split(".")[0]), []).append(n)
    pmax = {p: max(float(gf[n].abs().max()) for n in names)
            for p, names in parts.items()}
    above = {n for p, names in parts.items() for n in names
             if float(gf[n].abs().max()) >= 1e-2 * pmax[p]}
    cat = lambda g, names: torch.cat([g[n].double().reshape(-1)
                                      for n in names])
    part_of = {n: p for p, names in parts.items() for n in names}
    out = {"partition_cosine_to_f32": {}, "tensor_cosine_to_f32_lowest": {},
           "below_1pct_floor": sorted(set(gf) - above),
           "match_count_f32_minus_card": counts_f}
    # (c) below the floor: [largest f32 value / its partition's largest,
    # f32 card-vs-CPU cosine, card bf16 to card f32, CPU bf16 to CPU f32,
    # card bf16 to CPU bf16, the plain versions' bf16 step to the kernels']
    out["below_floor_cosines"] = {
        n: [float(gf[n].abs().max()) / pmax[part_of[n]],
            cosine(gf[n], gfc[n]), cosine(gg[n], gf[n]),
            cosine(gc[n], gfc[n]), cosine(gg[n], gc[n]),
            cosine(gp[n], gg[n])] for n in out["below_1pct_floor"]}
    for side, g in (("card", gg), ("cpu", gc)):
        out["partition_cosine_to_f32"][side] = {
            p: cosine(cat(g, names), cat(gf, names))
            for p, names in parts.items()}
        out["tensor_cosine_to_f32_lowest"][side] = sorted(
            ((n, cosine(g[n], gf[n])) for n in above),
            key=lambda kv: kv[1])[:5]
    out["plain_versions"] = {
        "partition_cosine_to_kernels": {
            p: cosine(cat(gp, names), cat(gg, names))
            for p, names in parts.items()},
        "partition_rel_err_to_kernels": {
            p: max(float((gp[n] - gg[n]).abs().max()) for n in names)
            / max(max(float(gg[n].abs().max()) for n in names), 1e-30)
            for p, names in parts.items()},
        "tensor_cosine_to_kernels_lowest": sorted(
            ((n, cosine(gp[n], gg[n])) for n in above),
            key=lambda kv: kv[1])[:5],
        "match_count_plain_minus_card": counts_p}
    say("[21 diagnostic] partition cosines to the f32 step, card / CPU: "
        + json.dumps(out["partition_cosine_to_f32"]))
    say("[21 diagnostic] lowest tensor cosines to the f32 step (above the "
        "1 % floor), card / CPU: "
        + json.dumps(out["tensor_cosine_to_f32_lowest"]))
    say(f"[21 diagnostic] {len(out['below_1pct_floor'])} tensors below the "
        f"1 % floor [largest f32 value / partition's largest, f32 card-vs-"
        f"CPU cosine, card bf16 to card f32, CPU bf16 to CPU f32, card bf16 "
        f"to CPU bf16, plain versions' bf16 step to the kernels']: "
        + json.dumps(out["below_floor_cosines"]))
    say("[21 diagnostic] the bf16 step with the plain versions against the "
        "kernels' step: " + json.dumps(out["plain_versions"]))
    return out


def phase_train_parity_bf16():
    """Phase 21a: one --bf16 train step of stage 1 at full width (B=2,
    sk_tau 0.05, phase 16's batch and weights) on the card and on the
    port's CPU path, TF32 off, the card's greedy picks replayed. Reported:
    the loss terms, per-partition gradient cosines, finite gradients. Held:
    every gradient finite, the same parameters trained, loss terms within
    5e-2 relative, a cosine of 0.99 or more over the graph side and the
    classifier, 0.9 over the backbone (the two sides round bf16 operands
    after sums in another order; the embedded Sinkhorns and, in the
    backbone, 20 train-mode BatchNorm backwards amplify the difference: two
    compiles of the reference package's bf16 step, with and without excess
    precision, agree to 0.94 there (tests/test_torch_bf16.py), and the
    first run here gave 0.958)."""
    cfg = train_parity_config()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="bfloat16"), ngm=dataclasses.replace(
        cfg.ngm, compute_dtype="bfloat16"))
    model_g = build_model(cfg, device="cuda", seed=SEED)
    model_c = cpu_copy(model_g, cfg)
    # Queue C 1: the f32 step of the same weights (the yardstick), and the
    # same bf16 step with the association matvec's plain versions
    model_f = build_model(train_parity_config(), device="cuda", state_dict={
        k: v.clone() for k, v in model_g.state_dict().items()})
    model_p = copy.deepcopy(model_g)
    host = synthetic_pair_batch(cfg, 2, genuine_ratio=0.5, n_range=(40, 60),
                                seed=SEED + 16)
    saved = read_counts()
    stage = default_stages()[0]
    # in bf16 the predicted k (AFA-U on the Sinkhorn map) can round to
    # another number of matches on the two sides: the picks are replayed
    # and the difference in their number is reported
    tap = GreedyTap(same_count=False)
    with tf32_off(), DtypeTap() as dt:
        mg, gg = tap.run("record",
                         lambda: step_and_grads(model_g, host.to(DEV), stage))
        torch.cuda.synchronize()
    picks = list(tap.picks)
    mc, gc = tap.run("replay", lambda: step_and_grads(model_c,
                                                      host.to("cpu"), stage))
    diag = bf16_step_diagnostic(model_f, model_p, host, stage, picks, gg, gc)
    restore_counts(saved)
    if set(gg) != set(gc):
        fail("21 train parity bf16: the card and the CPU trained other "
             "parameters")
    bad = [n for n, g in gg.items() if not torch.isfinite(g).all()]
    if bad:
        fail(f"21 train parity bf16: non-finite gradients: {bad[:5]}")
    parts = {}
    for n in gc:
        parts.setdefault(partition_of(n.split(".")[0]), []).append(n)
    cos = {}
    for part, names in parts.items():
        a = torch.cat([gg[n].double().reshape(-1) for n in names])
        b = torch.cat([gc[n].double().reshape(-1) for n in names])
        cos[part] = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    # per tensor only above phase 16's floor (1 % of its partition's
    # largest CPU gradient): below it a gradient is zero up to rounding
    pmax = {p: max(float(gc[n].abs().max()) for n in names)
            for p, names in parts.items()}
    floor = {n for p, names in parts.items() for n in names
             if float(gc[n].abs().max()) < 1e-2 * pmax[p]}
    per_tensor = {n: cosine(gg[n], gc[n]) for n in gc if n not in floor}
    loss = {k: {"card": mg[k], "cpu": mc[k],
                "rel_err": abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6)}
            for k in ("loss", "total_loss", "cls_loss", "ks_loss")}
    row = {"loss": loss, "partition_cosine": cos,
           "tensor_cosine_min": sorted(per_tensor.items(),
                                       key=lambda kv: kv[1])[:3],
           "tensors_below_1pct_floor": sorted(floor),
           "x_dtypes": dt.only_bf16("21 train parity bf16"),
           "match_count_cpu_minus_card": tap.count_diffs,
           "n_grads": len(gc), "diagnostic": diag}
    say("[21 train parity bf16] " + json.dumps(row))
    low = {part: (diag["partition_cosine_to_f32"]["card"][part],
                  diag["partition_cosine_to_f32"]["cpu"][part])
           for part in cos
           if not diag["partition_cosine_to_f32"]["card"][part]
           >= diag["partition_cosine_to_f32"]["cpu"][part] - F32_MARGIN}
    if low:
        fail(f"21 train parity bf16: the card's gradient is further from "
             f"the f32 step's than the CPU's by more than {F32_MARGIN} "
             f"(card, cpu): {low}")
    if any(not v["rel_err"] <= 5e-2 for v in loss.values()):
        fail(f"21 train parity bf16: loss terms differ: {loss}")
    if any(not c >= (0.9 if part == "backbone" else 0.99)
           for part, c in cos.items()):
        fail(f"21 train parity bf16: partition cosines {cos}")
    return row


def phase_train_bf16(tmp, runs32):
    """Phase 21b: `cli.train --bf16` at full width (n_max 64, B=8) through
    stages 1 and 2 on phase 17's split, 4 steps a stage; K6 bf16 and the
    K2 backward in stage 1 only (run_cli_train's check); every K2 / K6
    launch on bf16 X; ms per step and pairs/s beside phase 17's f32 runs."""
    argv = ["--data-root", f"{tmp}/train/Synthetic", "--stages", "1,2",
            "--epochs", "1", "--passes", "1", "--length", "32",
            "--thread-workers", "--checkpoint-dir", f"{tmp}/train/ckpt_bf16",
            "--test-length", "16", "--seed", str(SEED), "--bf16"]
    with DtypeTap() as tap:
        rows, report, launches, wall = run_cli_train("21 train bf16", argv)
    f32 = {r["stage"]: [s for run in runs32 for s in run[0]
                        if s["stage"] == r["stage"]] for r in rows}
    for r in rows:
        say(f"[21 train bf16] {r['stage']}: bf16 "
            f"{r['train_step_ms']:.1f} ms/step, "
            f"{r['train_pairs_per_s']:.1f} pairs/s; f32 (phase 17) "
            f"{[round(x['train_step_ms'], 1) for x in f32[r['stage']]]} "
            f"ms/step, "
            f"{[round(x['train_pairs_per_s'], 1) for x in f32[r['stage']]]}"
            f" pairs/s")
    return {"stages": rows, "f32_stages": f32, "report": report,
            "launches": launches, "wall_s": wall,
            "x_dtypes": tap.only_bf16("21 train bf16")}


def phase_parent_timing(parent):
    """With `--parent DIR` (an unpacked checkout of the parent commit):
    fpmatch_tpu_torch/scripts/time_assoc_grad.py on the parent's tree and
    on this one in turns (parent, this, this, parent), on the same inputs:
    K2 in f32 and bf16, the bf16 dX in both orientations, K6 in f32 and
    bf16. Returns {(row, N, C): {"parent_ms": [...], "ms": [...],
    "same_bits_as_parent": bool}}; fails if a row's two calls differ."""
    script = ROOT / "fpmatch_tpu_torch" / "scripts" / "time_assoc_grad.py"
    with tempfile.TemporaryDirectory(prefix="fpm_parent_") as tmp:
        dump = f"{tmp}/parent.pt"
        table = {}
        for tree, extra in ((parent, ["--dump", dump]),
                            (ROOT, ["--against", dump]),
                            (ROOT, ["--against", dump]), (parent, [])):
            p = subprocess.run([sys.executable, str(script), "--tree",
                                str(tree), *extra], capture_output=True,
                               text=True, timeout=900)
            if p.returncode != 0:
                fail(f"time_assoc_grad.py on {tree}: {p.stdout[-2000:]}"
                     f"{p.stderr[-2000:]}")
            for line in p.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                r = json.loads(line)
                t = table.setdefault(f"{r['row']}/N{r['N']}/C{r['C']}", {
                    "parent_ms": [], "ms": [], "parent_kernel_ms": [],
                    "kernel_ms": [], "same_bits_as_parent": True})
                side = "" if tree == ROOT else "parent_"
                t[side + "ms"].append(r["ms"])
                t[side + "kernel_ms"].append(r["kernel_ms"])
                if "same_bits_as_other" in r:
                    t["same_bits_as_parent"] &= r["same_bits_as_other"]
    for k, t in table.items():
        say(f"[15 parent] {k}: parent {t['parent_ms']} ms (kernel alone "
            f"{t['parent_kernel_ms']}), this tree {t['ms']} ms (kernel alone "
            f"{t['kernel_ms']}; turns parent, this, this, parent); same bits "
            f"as the parent: {t['same_bits_as_parent']}")
    return table


# ------------------------------------- 22-26 the matcher's other options
OPTION_FLAGS = ("--hyperedge", "--cls-k-features")
# the CUDA kernels of the main paths, by the name torch.profiler gives them
KERNEL_NAMES = _measure.KERNEL_NAMES


def profiler_launches(tag, fn):
    """One more call of `fn` under torch.profiler
    (`scripts._measure.profile_window`): the launches of K1 / K2 / K3 / K6
    the profiler sees on the device, which must equal the wrappers' counts
    of the same call (neither is kept in the main path's counts)."""
    saved = read_counts()
    row = _measure.profiled(fn, DEV, 1)
    restore_counts(saved)
    seen, wrappers = row["profiler_launches"], row["wrapper_launches"]
    say(f"[{tag}] torch.profiler's kernel launches of one call: {seen}"
        + (f" ({row['windows']} windows)" if row["windows"] > 1 else ""))
    if seen != wrappers:
        fail(f"{tag}: the profiler saw {seen}, the wrappers counted "
             f"{wrappers}")
    return seen


def expect_launches(tag, launches, **want):
    full = {k: 0 for k in launches}
    full.update(want)
    if launches != full:
        fail(f"{tag}: kernel launches {launches}, expected {full}")


def write_request_files(d, req):
    """Two PNGs and two .tsv keypoint files of a request, for cli.match."""
    import cv2

    d.mkdir(parents=True, exist_ok=True)
    img1, P1, img2, P2 = req
    files = []
    for name, img, P in (("a", img1, P1), ("b", img2, P2)):
        cv2.imwrite(str(d / f"{name}.png"), img)
        with open(d / f"{name}.tsv", "w") as f:
            f.write("x\ty\n" + "".join(f"{x:.3f}\t{y:.3f}\n" for x, y in P))
        files += [str(d / f"{name}.png"), str(d / f"{name}.tsv")]
    return files


def phase_serve_options(tmp):
    """22: --hyperedge --cls-k-features serving at full width on the bucket
    route (n_max 64, e_max 384, t_max 384): three requests through
    match_arrays (K2 three times each), one against the port's CPU run
    (TF32 off, phase 5's limits), the UNIV route refused as the reference
    refuses it, and cli.match.main --viz once."""
    cfg = cli_config(64, 384, 600, *OPTION_FLAGS)
    model = build_model(cfg, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 22)
    requests = [(k, make_request(rng, k, 40, 60))
                for k in ("genuine", "impostor", "ragged")]
    reset_counts()
    times = serve("22 serve options", model, requests)
    launches = read_counts()
    say(f"[22 serve options] kernel launches on the main path: {launches}")
    expect_launches("22 serve options", launches,
                    assoc_bucket=3 * len(requests))
    prof = profiler_launches("22 serve options",
                             lambda: match_arrays(model, *requests[0][1]))
    saved = read_counts()
    req = requests[2][1]
    with tf32_off():
        res_g, out_g = match_arrays(model, *req, return_outputs=True)
        torch.cuda.synchronize()
    t = time.time()
    res_c, out_c = match_arrays(cpu_copy(model, cfg), *req,
                                return_outputs=True)
    cpu_s = time.time() - t
    restore_counts(saved)
    say(f"[22 parity] ragged request, CPU run {cpu_s:.1f} s; n_matched gpu "
        f"{res_g['n_matched']} cpu {res_c['n_matched']}")
    errs, agree = compare_outputs("22 parity", out_g, out_c)
    try:
        match_arrays(model, *req, univ_kernel=True)
    except NotImplementedError as e:
        if "hyperedge + univ kernel" not in str(e):
            fail(f"22 serve options: the UNIV route raised {e!r}")
        say(f"[22 serve options] UNIV route refused: {e!r}")
    else:
        fail("22 serve options: a --hyperedge request on the UNIV route "
             "must raise")
    png1, tsv1, png2, tsv2 = write_request_files(Path(tmp) / "viz", req)
    viz = str(Path(tmp) / "viz" / "pair.png")
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli_match.main([png1, png2, "--kpts1", tsv1, "--kpts2", tsv2,
                             "--n-max", "64", "--e-max", "384", *OPTION_FLAGS,
                             "--viz", viz, "--checkpoint-dir",
                             str(Path(tmp) / "none")])
    main_launches = read_counts()
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    import cv2
    drawn = cv2.imread(viz)
    say(f"[22 serve options] cli.match.main --viz: rc {rc}, launches "
        f"{main_launches}, {viz} {None if drawn is None else drawn.shape}: "
        f"{json.dumps({k: v for k, v in result.items() if k != 'matches'})}")
    if rc != 0 or result.get("viz") != viz or drawn is None \
            or drawn.shape != (240, 640, 3):
        fail("22 serve options: cli.match.main --viz did not draw the pair")
    expect_launches("22 serve options main", main_launches, assoc_bucket=3)
    return {"wall_ms": [t * 1e3 for t in times], "launches": launches,
            "profiler_launches": prof, "parity": errs,
            "perm_rows_identical": agree, "cpu_s": cpu_s}


def phase_evaluate_options(tmp, index_dir):
    """23: evaluate_loader with --hyperedge --cls-k-features over augmented
    test pairs (`PairDataset(augment=True)`, as `cli.evaluate --augment`
    builds it): phase 7's split at B=8, n_max 64 (K2) and phase 9's at
    B=2, n_max 256 (K3), thread workers, pinned + side-stream prefetch;
    pairs/s, each batch checked as phase 7's."""
    out = {}
    for tag, (B, N, E), root, kernel, cut in (
            ("23 evaluate options", (8, 64, 384), f"{tmp}/bucket",
             "assoc_bucket", False),
            ("23 evaluate options large", (2, 256, 1536), f"{tmp}/large",
             "assoc_large", True)):
        cfg = eval_config(B, N, E, *OPTION_FLAGS, "--augment")
        model = build_model(cfg, device="cuda", seed=SEED)
        bench = make_benchmark("Synthetic", "test", root=root,
                               task="classify", output_dir=index_dir)
        pd = PairDataset(bench, cfg, augment=True)
        if cut:
            pd.pairs = pd.pairs[:3] + pd.pairs[-2:]
        loader = DataLoader(pd, cfg, drop_last=False, device=DEV,
                            device_prefetch=True, num_workers=4,
                            use_processes=False)
        try:
            launches, res, wall = run_evaluate(tag, model, loader, len(pd),
                                               kernel)
        finally:
            loader.close()
        sample = pd.get(0)
        if sample.tris is None or not len(sample.tris[0]):
            fail(f"{tag}: the pairs carry no triangles")
        batch = collate([pd.get(i) for i in range(B)], cfg).to(DEV)
        prof = profiler_launches(tag, lambda: model(batch))
        out[kernel] = {"pairs": len(pd), "wall_s": wall,
                       "pairs_per_s": len(pd) / wall,
                       "batch_ms": [x * 1e3 for x in res["batch_seconds"]],
                       "launches": launches, "profiler_launches": prof,
                       "triangles_first_pair": [len(t) for t in
                                                sample.tris]}
        del model
        torch.cuda.empty_cache()
    return out


def tri_term_cost(B, N, T, channels, reps=10):
    """The triangle term of one train step alone, at the step's shapes (the
    three GNN layers' input widths): assoc_tri_matvec + assoc_tri_degree
    forward and backward per layer, CUDA-event ms (median of `reps`) and
    the peak memory it allocates above what was allocated before."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 24)
    tri = torch.randint(0, N, (B, T, 3), generator=gen).to(DEV)
    mask = torch.ones((B, T), dtype=torch.bool, device=DEV)
    Kt = torch.rand((B, T, T), generator=gen).to(DEV).requires_grad_()
    layers = []
    for C in channels:
        X = torch.randn((B, N, N, C), generator=gen).to(DEV).requires_grad_()
        layers.append((X, torch.randn((B, N, N, C), generator=gen).to(DEV)))

    def step():
        for X, dY in layers:
            deg = ops_assoc.assoc_tri_degree(mask, mask, tri, tri, N, N)
            y = ops_assoc.assoc_tri_matvec(X, Kt, tri, tri) \
                / torch.clamp(deg, min=1.0)[..., None]
            y.backward(dY)

    step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return time_ms(step, reps=reps), peak


def tri_share_profiled(model, batch, stage):
    """One warm train step under torch.profiler with the triangle term's
    functions (angle attributes, triangle affinity, assoc_tri_degree,
    assoc_tri_matvec) each inside a `tri_term` range: the device time of the
    kernels launched inside those ranges (forward) and of the autograd
    nodes whose sequence numbers the ranges' ops hold (backward), beside the
    step's device total."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from fpmatch_tpu_torch.models import layers as t_layers

    real = [(t_layers, "assoc_tri_matvec"), (t_layers, "assoc_tri_degree"),
            (t_ngm, "hyperedge_angle_attrs")]
    saved = [(m, n, getattr(m, n)) for m, n in real]

    def ranged(fn):
        def call(*a, **k):
            with record_function("tri_term"):
                return fn(*a, **k)
        return call

    for m, n, fn in saved:
        setattr(m, n, ranged(fn))
    aff = model.tri_aff.forward
    model.tri_aff.forward = ranged(aff)
    counts = read_counts()
    try:
        state = create_state(model, stage)
        step = make_train_step(model, stage)
        step(state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
        del model.tri_aff.forward
        restore_counts(counts)
    evs = prof.events()
    # device kernels only (not the device-side copy of the ranges)
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA" and e.key != "tri_term") / 1e3
    ranges = [e for e in evs if e.name == "tri_term"
              and e.device_type.name == "CPU"]
    fwd = sum(e.device_time_total for e in ranges) / 1e3
    seqs, todo = set(), list(ranges)
    while todo:
        e = todo.pop()
        if getattr(e, "sequence_nr", -1) >= 0:
            seqs.add(e.sequence_nr)
        todo.extend(e.cpu_children)
    bwd = [e for e in evs if e.name.startswith(
        "autograd::engine::evaluate_function") and e.sequence_nr in seqs]
    bwd_ms = sum(e.device_time_total for e in bwd) / 1e3 if bwd else None
    return {"step_device_ms": total, "tri_forward_ms": fwd,
            "tri_backward_ms": bwd_ms, "tri_ranges": len(ranges),
            "tri_backward_nodes": len(bwd),
            "tri_share": None if bwd_ms is None or not total
            else (fwd + bwd_ms) / total}


def phase_train_options():
    """24: one stage-1 train step with --hyperedge --cls-k-features at full
    width, B=8 (n_max 64, e_max 384, t_max 384, sk_tau 0.05 as phase 16),
    on the card and on the port's CPU path, TF32 off, the card's picks
    replayed: phase 16's limits (`compare_step`). K2 forward, its dX and K6
    each three times; the step's peak memory; the triangle term's time,
    alone (CUDA events) and inside a profiled step (torch.profiler)."""
    cfg = cli_train_config(8)
    cfg = dataclasses.replace(cfg, ngm=dataclasses.replace(
        cfg.ngm, sk_tau=0.05, hyperedge=True, cls_k_features=True))
    model_g = build_model(cfg, device="cuda", seed=SEED)
    model_c = cpu_copy(model_g, cfg)
    host = synthetic_pair_batch(cfg, 8, genuine_ratio=0.5, n_range=(40, 60),
                                seed=SEED + 24)
    bg, bc = host.to(DEV), host.to("cpu")
    stage = default_stages()[0]
    before_g = {k: v.detach().cpu().clone()
                for k, v in model_g.state_dict().items()}
    before_c = {k: v.clone() for k, v in model_c.state_dict().items()}
    saved = read_counts()
    tap = GreedyTap()
    reset_counts()
    for k in ops_assoc.BACKWARD_LAUNCHES:
        ops_assoc.BACKWARD_LAUNCHES[k] = 0
    with tf32_off():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        mg, gg = tap.run("record", lambda: step_and_grads(model_g, bg, stage))
        torch.cuda.synchronize()
        t_g = time.time() - t
        peak = torch.cuda.max_memory_allocated() - base
    launches = read_counts()
    bwd = dict(ops_assoc.BACKWARD_LAUNCHES)
    t = time.time()
    mc, gc = tap.run("replay", lambda: step_and_grads(model_c, bc, stage))
    t_c = time.time() - t
    row, _, _ = compare_step("24 train options", stage, mg, mc, gg, gc,
                             model_g, model_c, before_g, before_c)
    row.update(card_s=t_g, cpu_s=t_c, launches=launches,
               backward_launches=bwd, step_peak_mb=peak / 2 ** 20,
               n_tris=host.n_tris.tolist())
    say("[24 train options] " + json.dumps(row))
    check_step("24 train options", row, gg, gc)
    for n in ("tri_aff.A.weight", "gnn_0.lin_t.weight", "match_cls.fc.weight"):
        if n not in gg:
            fail(f"24 train options: {n} got no gradient")
    expect_launches("24 train options", launches, assoc_bucket=6,
                    assoc_grad=3)
    if bwd["assoc_bucket"] != 3:
        fail(f"24 train options: {bwd} backward launches of K2, expected 3")
    restore_counts(saved)
    tap_p = GreedyTap()
    prof = profiler_launches("24 train options", lambda: tap_p.run(
        "record", lambda: step_and_grads(model_g, bg, stage)))
    T, N = cfg.shapes.t_max, cfg.shapes.n_max
    chans = [1] + [c + cfg.ngm.sk_emb for c in cfg.ngm.gnn_feat[:-1]]
    alone_ms, alone_peak = tri_term_cost(8, N, T, chans)
    share = tri_share_profiled(model_g, bg, stage)
    w_mb = [8 * T * T * c * 4 / 2 ** 20 for c in chans]
    row.update(profiler_launches=prof, tri_alone_ms=alone_ms,
               tri_alone_peak_mb=alone_peak / 2 ** 20,
               w_per_rotation_mb=w_mb, profiled=share)
    say(f"[24 train options] triangle term alone (3 layers, C={chans}, "
        f"fwd+bwd): {alone_ms:.3f} ms, peak {alone_peak / 2 ** 20:.1f} MB; "
        f"W per rotation {[round(x, 1) for x in w_mb]} MB; step peak "
        f"{peak / 2 ** 20:.1f} MB; profiled step: {json.dumps(share)}")
    return row


def phase_backbones():
    """25: a forward of each other backbone kind at B=8, n_max 64 (K2), full
    widths: VGG16 and VGG16-bn (node_feature_dim 1024) on 240x320 images,
    and "none" on 128-wide precomputed keypoint features; each against the
    port's CPU run, TF32 off (phase 5's limits), then timed with TF32 on."""
    from fpmatch_tpu_torch.core.config import Config, ShapeConfig

    out = {}
    for kind in ("vgg16", "vgg16_bn", "none"):
        cfg = Config(shapes=ShapeConfig(n_max=64, e_max=384))
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, kind=kind))
        if kind != "none":
            cfg = dataclasses.replace(cfg, ngm=dataclasses.replace(
                cfg.ngm, node_feature_dim=1024))
        host = synthetic_pair_batch(cfg, 8, genuine_ratio=0.5,
                                    n_range=(40, 60), seed=SEED + 25)
        feature_dim = None
        if kind == "none":
            feature_dim = 128
            rng = np.random.default_rng(SEED + 25)
            host = host._replace(features=rng.normal(
                size=(8, 2, 64, feature_dim)).astype(np.float32))
        model = build_model(cfg, device="cuda", seed=SEED,
                            feature_dim=feature_dim)
        bg = host.to(DEV)
        tag = f"25 backbone {kind}"
        reset_counts()
        with tf32_off():
            out_g = model(bg)
            torch.cuda.synchronize()
        launches = read_counts()
        expect_launches(tag, launches, assoc_bucket=3)
        check_batch(tag, bg, out_g)
        saved = read_counts()
        t = time.time()
        out_c = cpu_copy(model, cfg)(host.to("cpu"))
        cpu_s = time.time() - t
        errs, agree = compare_outputs(tag, out_g, out_c)
        ms = time_ms(lambda: model(bg), reps=5)
        restore_counts(saved)
        n_par = sum(p.numel() for p in model.backbone.parameters())
        say(f"[{tag}] forward {ms:.1f} ms (TF32 default), backbone "
            f"{n_par / 1e6:.2f} M parameters, CPU run {cpu_s:.1f} s")
        out[kind] = {"forward_ms": ms, "launches": launches, "parity": errs,
                     "perm_rows_identical": agree, "cpu_s": cpu_s}
        del model, out_g
        torch.cuda.empty_cache()
    return out


def phase_overfit():
    """26: python -m fpmatch_tpu_torch.cli.overfit at the reference CLI's
    defaults (100 steps, lr 1e-4, n_max 32, one pair of 128x160, seed 0) on
    the card, TF32 off so that its first step can be held against the CPU's
    (the CLI's first step on the CPU: loss within 1e-3 relative; sk_tau
    0.01 multiplies rounding noise by 100 at each Sinkhorn stage); every
    loss finite; loss and accuracy every tenth step. Whether accuracy rose
    is reported, not held."""
    from fpmatch_tpu_torch.cli import overfit as cli_overfit

    hist = []

    def on_step(i, m):
        hist.append({k: float(m[k]) for k in ("loss", "accuracy",
                                              "ks_error", "total_loss")})
        if not np.isfinite(hist[-1]["loss"]):
            fail(f"26 overfit: non-finite loss at step {i}")

    reset_counts()
    for k in ops_assoc.BACKWARD_LAUNCHES:
        ops_assoc.BACKWARD_LAUNCHES[k] = 0
    buf = io.StringIO()
    with tf32_off(), contextlib.redirect_stdout(buf):
        t = time.time()
        acc = cli_overfit.main(["--steps", "100"], on_step=on_step)
        torch.cuda.synchronize()
        wall = time.time() - t
    launches = read_counts()
    bwd = dict(ops_assoc.BACKWARD_LAUNCHES)
    for line in buf.getvalue().splitlines():
        say(f"[26 overfit] {line}")
    saved = read_counts()
    cpu = []
    with contextlib.redirect_stdout(io.StringIO()):
        cli_overfit.main(["--steps", "1", "--device", "cpu"],
                         on_step=lambda i, m: cpu.append(float(m["loss"])))
    restore_counts(saved)
    first = hist[0]["loss"]
    rel = abs(first - cpu[0]) / max(abs(cpu[0]), 1e-6)
    say(f"[26 overfit] {wall:.1f} s for 100 steps; first-step loss card "
        f"{first:.6f} cpu {cpu[0]:.6f} (rel {rel:.2e}); accuracy step 0 "
        f"{hist[0]['accuracy']:.4f} -> step 99 {acc:.4f}; launches "
        f"{launches}, backward K2 {bwd}")
    if not rel <= 1e-3:
        fail(f"26 overfit: first-step loss differs from the CPU's by {rel}")
    expect_launches("26 overfit", launches, assoc_bucket=600,
                    assoc_grad=300)
    return {"wall_s": wall, "every_tenth": hist[::10] + [hist[-1]],
            "first_loss": {"card": first, "cpu": cpu[0], "rel_err": rel},
            "accuracy_first_last": [hist[0]["accuracy"], acc],
            "launches": launches, "backward_launches": bwd}


def phase_options(tmp):
    """Phases 22-26 in order; returns their JSON."""
    t = time.time()
    out = {"serve": phase_serve_options(tmp),
           "evaluate": phase_evaluate_options(tmp, f"{tmp}/index"),
           "train_step": phase_train_options(),
           "backbones": phase_backbones(),
           "overfit": phase_overfit()}
    out["wall_s"] = time.time() - t
    say(f"[22-26] the options' phases took {out['wall_s']:.1f} s")
    return out


# ----------------------------------------------------- 27 edge-sharded path
MESH_NOISE_BOUND = ("afau.row_block.", "afau.final_row_")


def partition_cosines(gg, gc):
    """Per partition, the cosine of the gradients `gg` to `gc` over every
    tensor but the AFA-U row half (float32-noise-bound at init, phase
    16)."""
    out = {}
    for part in ("backbone", "main", "k", "cls"):
        names = [n for n in gc if partition_of(n.split(".")[0]) == part
                 and not n.startswith(MESH_NOISE_BOUND)]
        if names:
            a = torch.cat([gg[n].double().reshape(-1) for n in names])
            b = torch.cat([gc[n].double().reshape(-1) for n in names])
            out[part] = float(torch.nn.functional.cosine_similarity(a, b,
                                                                    dim=0))
    return out


def mesh_world_one():
    """27, part 1: an NCCL process group of world size 1 in this process
    and its 1 x 1 rank grid; cli.train's full-width model (B = 8, n_max 64,
    f32, TF32 off; sk_tau 0.05 as phase 16) forward with a p = 1 row plan
    through the real exchange, then one stage-3 train step through the
    data-group gradient path, each against the same weights without a grid
    or a plan (outputs: rtol 2e-2 / atol 2e-3, perm_mat flips <= 0.5 %;
    gradients: cosine >= 0.9999 per partition, the greedy picks of the
    one-device step replayed)."""
    import socket

    import torch.distributed as dist
    from fpmatch_tpu_torch.parallel.distributed import (initialize,
                                                        make_hybrid_mesh)
    from fpmatch_tpu_torch.parallel.edge_partition import plan_batch_rows

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(0)
    initialize(DEV, f"tcp://127.0.0.1:{port}", 1, 0, timeout_s=300)
    try:
        if dist.get_backend() != "nccl":
            fail(f"27 mesh: backend {dist.get_backend()}, not nccl")
        grid = make_hybrid_mesh(1, 1)
        cfg = cli_train_config(8)
        cfg = dataclasses.replace(cfg, ngm=dataclasses.replace(cfg.ngm,
                                                               sk_tau=0.05))
        mesh = build_model(cfg, device="cuda", seed=SEED, grid=grid)
        ref = build_model(cfg, device="cuda", seed=SEED)
        host = synthetic_pair_batch(cfg, 8, genuine_ratio=0.5,
                                    n_range=(40, 60), seed=SEED + 27)
        plan = plan_batch_rows(cfg.shapes.n_max, host.src[:, 0],
                               host.dst[:, 0], 1)
        bp, b = host._replace(row_plan=plan).to(DEV), host.to(DEV)
        row = {"B": 8, "n_max": cfg.shapes.n_max, "backend": "nccl",
               "world_size": dist.get_world_size()}
        with tf32_off():
            reset_counts()
            out_m = mesh(bp)
            torch.cuda.synchronize()
            row["forward_launches"] = read_counts()
            saved = read_counts()
            out_r = ref(b)
            torch.cuda.synchronize()
            restore_counts(saved)
        expect_launches("27 mesh forward", row["forward_launches"],
                        assoc_bucket=6)
        profiler_launches("27 mesh forward", lambda: mesh(bp))
        diffs = {k: float((out_m[k] - out_r[k]).abs().max())
                 for k in ("raw_scores", "ds_mat", "cls_prob", "k_prob")}
        flips = float((out_m["perm_mat"] - out_r["perm_mat"]).abs().sum())
        row.update(forward_max_abs_diff=diffs, perm_flips=flips,
                   perm_cells=out_m["perm_mat"].numel())
        for k in diffs:
            if not torch.allclose(out_m[k], out_r[k], rtol=2e-2, atol=2e-3):
                fail(f"27 mesh forward: {k} differs by {diffs[k]:.3e}")
        if flips > 0.005 * out_m["perm_mat"].numel():
            fail(f"27 mesh forward: {flips} perm_mat flips")

        stage = default_stages()[2]
        tap = GreedyTap()
        with tf32_off():
            saved = read_counts()
            mc, gc = tap.run("record", lambda: step_and_grads(ref, b, stage))
            torch.cuda.synchronize()
            restore_counts(saved)
            reset_counts()
            t = time.time()
            state = create_state(mesh, stage)
            state, metrics = tap.run("replay", lambda: make_train_step(
                mesh, stage, grid)(state, bp))
            torch.cuda.synchronize()
            row["step_s"] = time.time() - t
            row["step_launches"] = read_counts()
        expect_launches("27 mesh train step", row["step_launches"],
                        assoc_bucket=12, assoc_grad=6)
        mg = {k: float(v) for k, v in metrics.items()}
        gg = {n: p.grad.detach().cpu() for n, p in mesh.named_parameters()
              if p.grad is not None}
        gc = {n: g.cpu() for n, g in gc.items()}
        if set(gg) != set(gc):
            fail("27 mesh train step: other parameters trained")
        cos = partition_cosines(gg, gc)
        loss_err = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6)
                    for k in ("loss", "total_loss", "cls_loss", "ks_loss")}
        sd_m, sd_r = mesh.state_dict(), ref.state_dict()
        stats = max(float((sd_m[k] - v).abs().max())
                    / max(float(v.abs().max()), 1e-30)
                    for k, v in sd_r.items()
                    if k.endswith(("running_mean", "running_var")))
        row.update(grad_cosine=cos, loss_rel_err=loss_err,
                   bn_stats_rel_err_max=stats,
                   finite=all(bool(torch.isfinite(g).all())
                              for g in gg.values()))
        say("[27 mesh world 1] " + json.dumps(row))
        if not row["finite"]:
            fail("27 mesh train step: non-finite gradients")
        if any(c < 0.9999 for c in cos.values()):
            fail(f"27 mesh train step: gradient cosines {cos}")
        if not loss_err["loss"] <= 2e-3:
            fail(f"27 mesh train step: loss differs: {loss_err}")
        return row
    finally:
        dist.destroy_process_group()


def emulated_case(rng, B, N, E, C, p, transpose, flush):
    """27, part 2: p ranks of one edge group in this process
    (`emulated_row_sharded_aggregate`: the exchange an index copy of the
    stacked packs), every rank's forward and backward contraction on the
    kernels, against the unsharded kernel call (`assoc_matvec_auto`) and
    the plain version (ops.assoc.assoc_matvec with autograd) on the same
    inputs: Y, dX, dKp and dKe (on the real slots) within 1e-5 of each
    one's range. Each rank's launches and CUDA-event ms of one layer (its
    forward), beside the unsharded call's ms and the plan's
    halo_fraction."""
    from fpmatch_tpu_torch.parallel.edge_partition import (
        emulated_row_sharded_aggregate, halo_fraction, plan_batch_rows)

    X, Kp, Ke, s1, d1, s2, d2, m1, m2, _ = bucket_inputs(
        rng, B, N, E, C, int(0.7 * N), N)
    W = torch.randn(X.shape, device=DEV)
    plan = plan_batch_rows(N, s1.cpu().numpy(), d1.cpu().numpy(), p,
                           transpose=transpose)
    dplan = plan.to(DEV)
    real = (m1[:, :, None] & m2[:, None, :]).float()

    def grads(fn):
        Xg, Kpg, Keg = (t.clone().requires_grad_() for t in (X, Kp, Ke))
        Y = fn(Xg, Kpg, Keg)
        (Y * W).sum().backward()
        torch.cuda.synchronize()
        return {"Y": Y.detach(), "dX": Xg.grad, "dKp": Kpg.grad,
                "dKe": Keg.grad * real}

    saved = read_counts()
    reset_counts()
    got = grads(lambda x, kp, ke: emulated_row_sharded_aggregate(
        x, kp, ke, dplan, s2, d2, e1_mask=m1, e2_mask=m2,
        transpose=transpose))
    launches = read_counts()
    kern = grads(lambda x, kp, ke: ops_assoc.assoc_matvec_auto(
        x, kp, ke, s1, d1, s2, d2, transpose=transpose, e1_mask=m1,
        e2_mask=m2))
    plain = grads(lambda x, kp, ke: assoc_matvec(x, kp, ke, s1, d1, s2, d2,
                                                 transpose=transpose))
    err = {f"{k}_vs_{name}": relerr(got[k], ref[k])
           for name, ref in (("kernel", kern), ("plain", plain))
           for k in got}
    if not all(e <= 1e-5 for e in err.values()):
        fail(f"27 emulated p={p} N={N} transpose={transpose}: {err}")

    # one layer's forward per rank, CUDA events, 10 turns
    events = {q: [] for q in range(p)}
    counts = {}

    def on_rank(q, fn):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn()
        end.record()
        events[q].append((start, end))
        after = read_counts()
        counts[q] = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
        return y

    with torch.no_grad():
        for _ in range(10):
            emulated_row_sharded_aggregate(X, Kp, Ke, dplan, s2, d2,
                                           e1_mask=m1, e2_mask=m2,
                                           transpose=transpose,
                                           on_rank=on_rank)
        torch.cuda.synchronize()
        unsharded_ms = time_ms(lambda: ops_assoc.assoc_matvec_auto(
            X, Kp, Ke, s1, d1, s2, d2, transpose=transpose, e1_mask=m1,
            e2_mask=m2), reps=10, flush=flush)
    restore_counts(saved)
    row = {"B": B, "N": N, "E": E, "C": C, "p": p, "transpose": transpose,
           "halo_fraction": halo_fraction(plan), "launches_fwd_bwd": launches,
           "rank_launches_fwd": [counts[q] for q in range(p)],
           "rank_ms_fwd": [float(np.median([s.elapsed_time(e)
                                            for s, e in events[q]]))
                           for q in range(p)],
           "unsharded_ms": unsharded_ms, "max_rel_err": max(err.values()),
           "max_abs_err": max(float((got[k] - kern[k]).abs().max())
                              for k in got)}
    say("[27 emulated] " + json.dumps(row))
    return row


def phase_mesh():
    """27: the edge-sharded path (parallel/) on one card; returns its
    JSON."""
    t = time.time()
    out = {"world_1": mesh_world_one()}
    rng = np.random.default_rng(SEED + 270)
    flush = tune_univ.l2_flush(DEV)
    out["emulated"] = [emulated_case(rng, B, N, E, 17, p, tr, flush)
                       for B, N, E in ((8, 64, 384), (2, 256, 1536))
                       for tr in (True, False) for p in (2, 4, 8)]
    kernels = {k for r in out["emulated"] for k in r["launches_fwd_bwd"]
               if r["launches_fwd_bwd"][k]}
    if not {"assoc_bucket", "assoc_large", "assoc_grad"} <= kernels:
        fail(f"27 emulated: kernels launched {sorted(kernels)}")
    n = torch.cuda.device_count()
    if n > 1:
        out["cli"] = {}
        for mesh in ("1x2", "2x1"):
            out["cli"][mesh] = run_mesh_cli(mesh)
    else:
        say(f"[27 cli] cli.train --mesh 1x2 / 2x1 not run: {n} card "
            f"visible, a mesh of two ranks needs two (NCCL puts one rank "
            f"on a card)")
    out["wall_s"] = time.time() - t
    say(f"[27] the edge-sharded phase took {out['wall_s']:.1f} s")
    return out


def run_mesh_cli(mesh):
    """cli.train --mesh on the visible cards: stage 1, one epoch on a
    small synthetic split (the ranks spawned by the CLI)."""
    with tempfile.TemporaryDirectory(prefix="fpm_mesh_") as tmp:
        root = f"{tmp}/Synthetic"
        generate_synthetic_dataset(root, fingers_per_split=(6, 3, 2),
                                   n_pores=110, seed=SEED)
        t = time.time()
        report = cli_train.main(
            ["--data-root", root, "--stages", "1", "--epochs", "1",
             "--passes", "1", "--length", "16", "--test-length", "8",
             "--thread-workers", "--mesh", mesh,
             "--checkpoint-dir", f"{tmp}/ckpt"])
        row = {"mesh": mesh, "wall_s": time.time() - t,
               "report": {k: float(v) for k, v in report.items()}}
    say(f"[27 cli {mesh}] " + json.dumps(row))
    if not np.isfinite(row["report"]["total_loss"]):
        fail(f"27 cli {mesh}: non-finite loss")
    return row


# ------------------------------------------- 28 pore-detector training
# RESULTS.md's protocol of the repo's trained detector (results/poredet/):
# 24 train / 6 val / 6 test impressions, 30 epochs
POREDET_PROTOCOL = ("--train-n", "24", "--val-n", "6", "--test-n", "6",
                    "--epochs", "30")
POREDET_MIN_TEST_II_F = 0.65


def poredet_step_parity():
    """One Adam step of net17nomax (40 features) from the same initial
    weights on one patch batch, on the card and on the CPU (TF32 off).
    Held: the loss within 1e-5, the batch statistics within 1e-5 of each
    tensor's range, each gradient to a cosine of 0.99999, and the card's
    Adam step applied to the CPU's gradients within 1e-5 of each
    parameter's range of the CPU's step. The parameters after each
    device's own step are reported, not held: Adam's first step moves a
    weight by lr * g / (|g| + eps), about lr times the sign of g, so where
    |g| is near the devices' gradient difference (the BatchNorm backward's
    cancellation) that step follows rounding noise."""
    imgs, gts = train_poredet.render_set(9000, 3)
    X, Y = pd_train.make_patch_bank(imgs, gts, 17, SEED)
    n = min(256, len(X))
    xb = torch.from_numpy(X[:n]).permute(0, 3, 1, 2).contiguous()
    yb = torch.from_numpy(Y[:n])
    lr = 1e-3
    fresh = lambda dev: pd_arch.lecun_init_(
        pd_arch.make_architecture("net17nomax"),
        torch.Generator().manual_seed(SEED)).to(dev)
    out = {}
    with tf32_off():
        for dev in ("cpu", "cuda"):
            m = fresh(dev)
            loss = pd_train.train_step(m, pd_train.make_optimizer(m, lr),
                                       xb.to(dev), yb.to(dev))
            out[dev] = (m, float(loss))
        # the card's optimizer on the CPU's gradients
        (mg, lg), (mc, lc) = out["cuda"], out["cpu"]
        ma = fresh("cuda")
        for p, q in zip(ma.parameters(), mc.parameters()):
            p.grad = q.grad.to(DEV)
        pd_train.make_optimizer(ma, lr).step()
    pc = dict(mc.named_parameters())
    cos = {k: 1.0 if not bool(pc[k].grad.any()) and not bool(p.grad.any())
           else float(torch.nn.functional.cosine_similarity(
               p.grad.double().cpu().reshape(-1),
               pc[k].grad.double().reshape(-1), dim=0))
           for k, p in mg.named_parameters()}
    grad_err = {k: relerr(p.grad.cpu(), pc[k].grad)
                for k, p in mg.named_parameters()}
    adam_err = {k: relerr(p.detach().cpu(), pc[k].detach())
                for k, p in ma.named_parameters()}
    own_err = {k: relerr(p.detach().cpu(), pc[k].detach())
               for k, p in mg.named_parameters()}
    sg, sc = mg.state_dict(), mc.state_dict()
    stats_err = {k: relerr(sg[k].cpu(), sc[k]) for k in sc
                 if k.endswith(("running_mean", "running_var"))}
    row = {"batch": n, "loss_card": lg, "loss_cpu": lc,
           "stats_max_rel_err": max(stats_err.values()),
           "grad_cosine_min": min(cos.values()),
           "grad_max_rel_err": max(grad_err.values()),
           "adam_on_cpu_grads_max_rel_err": max(adam_err.values()),
           "own_step_params_max_rel_err": max(own_err.values()),
           "own_step_worst": max(own_err, key=own_err.get),
           "own_step_max_abs_diff": max(
               float((p.detach().cpu() - pc[k].detach()).abs().max())
               for k, p in mg.named_parameters())}
    say("[28 step] " + json.dumps(row))
    if (abs(lg - lc) > 1e-5 * abs(lc) or row["stats_max_rel_err"] > 1e-5
            or row["grad_cosine_min"] < 0.99999
            or row["adam_on_cpu_grads_max_rel_err"] > 1e-5
            or row["own_step_max_abs_diff"] > 2 * lr * (1 + 1e-3)):
        fail(f"28: the card's Adam step differs from the CPU's: {row}")
    return row


def repo_detector_figures():
    """The TEST rows of the repo's trained detector
    (results/poredet/metrics.csv, trained under the protocol above)."""
    import csv

    with open(ROOT / "results" / "poredet" / "metrics.csv") as f:
        return {r["detector"]: {k: float(r[k]) for k in (
            "f_score", "true_detection_rate", "false_detection_rate")}
            for r in csv.DictReader(f) if ":TEST" in r["detector"]}


def phase_train_poredet(tmp):
    """28: the pore detector trained on the card through
    `python -m fpmatch_tpu_torch.scripts.train_poredet`'s main (TF32 off),
    after one step against the CPU; returns its JSON."""
    t = time.time()
    out = {"step_parity": poredet_step_parity()}
    argv = ["--arch", "net17nomax", "--out", f"{tmp}/poredet",
            *POREDET_PROTOCOL, "--device", "cuda"]
    say(f"[28 train] python -m fpmatch_tpu_torch.scripts.train_poredet "
        f"{' '.join(argv)}")
    reset_counts()
    t1 = time.time()
    with tf32_off():
        res = train_poredet.main(
            argv, log_fn=lambda m: say(f"[28 train] {m}")
            if "\n" not in m else None)
    wall = time.time() - t1
    tr = res["train"]
    rows = {r["detector"]: r for r in res["rows"]}
    phases = {k: {m: v[m] for m in ("f_score", "true_detection_rate",
                                    "false_detection_rate")}
              for k, v in res["phases"].items()}
    out.update({
        "wall_s": wall, "n_patches": tr["n_patches"],
        "step_ms_median": float(np.median(tr["step_ms"])),
        "step_ms": tr["step_ms"], "losses": tr["losses"],
        "val_f": tr["val_f"], "kept_epoch": tr["epoch"],
        "grid": res["grid"], "phases": phases,
        "dpf": {k: rows[k]["f_score"] for k in ("dpf_compact",
                                                 "dpf_lemes")},
        "repo_figures": repo_detector_figures(), "launches": read_counts()})
    say(f"[28 train] {tr['n_patches']} patches, "
        f"{out['step_ms_median']:.2f} ms a step (median of the epochs), "
        f"kept epoch {tr['epoch']}, grid {res['grid']}, {wall:.1f} s")
    for k, v in phases.items():
        say(f"[28 train] {k}: F {v['f_score']:.4f} TDR "
            f"{v['true_detection_rate']:.4f} FDR "
            f"{v['false_detection_rate']:.4f} | the repo's trained "
            f"detector (results/poredet): {out['repo_figures'].get('net17nomax:' + k)}")
    say(f"[28 train] DPF on the same test images: {out['dpf']}")
    f2 = phases["TEST_II"]["f_score"]
    if not f2 >= POREDET_MIN_TEST_II_F:
        fail(f"28: TEST_II F {f2:.4f} < {POREDET_MIN_TEST_II_F}")
    # the written .npz, reloaded, detects as the trained model
    img = train_poredet.render_set(9800, 1)[0][0]
    kw = dict(probability=res["grid"]["probability"],
              nms_iou=res["grid"]["nms_iou"], window=17)
    with tf32_off():
        mine, _ = detect_pores_in_image(res["model"], img, **kw)
        back, _ = detect_pores_in_image(
            load_detector("net17nomax", res["npz"], device="cuda"), img, **kw)
    if not np.array_equal(mine, back):
        fail("28: the reloaded .npz detects otherwise than the trained model")
    out["reload_detections"] = len(back)
    out["phase_s"] = time.time() - t
    say(f"[28] the detector's training phase took {out['phase_s']:.1f} s "
        f"(the reloaded .npz: the same {len(back)} detections)")
    return out


# ---------------------------------------- 29 QAP and the library layers
def planted_qap(rng, n, e_max):
    """tests/test_ops.py's planted QAP on a Delaunay graph: graph 2 is graph
    1 under a random permutation, Kp high on the planted matches, Ke 1 on
    the real edge pairs and 0 on the padded slots; returns numpy arrays."""
    _, s1, d1 = delaunay(rng, n)
    E = min(len(s1), e_max)
    pad = lambda a: np.concatenate([a[:E], np.zeros(e_max - E, a.dtype)]
                                   ).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    s1, d1 = pad(s1), pad(d1)
    s2, d2 = pad(perm[s1[:E]]), pad(perm[d1[:E]])
    Kp = (np.eye(n)[perm] + 0.05 * rng.uniform(size=(n, n))).astype(
        np.float32)
    Ke = np.zeros((e_max, e_max), np.float32)
    Ke[:E, :E] = 1.0
    return perm, Kp, Ke, s1, d1, s2, d2, np.arange(e_max) < E


def qap_case(n, e_max, kernel, iters=20):
    """One planted QAP on the card against the port's CPU run; K3 against
    the fused contraction on its inputs."""
    rng = np.random.default_rng(SEED + 290 + n)
    perm, *arrays, mask = planted_qap(rng, n, e_max)
    cpu = [torch.from_numpy(a) for a in arrays]
    card = [a.to(DEV) for a in cpu]
    m = torch.from_numpy(mask).to(DEV)
    kw = dict(iters=iters, tau=0.05, e1_mask=m, e2_mask=m)
    want = qap_power_sinkhorn(*cpu, n, n, iters=iters, tau=0.05)
    reset_counts()
    got = qap_power_sinkhorn(*card, n, n, **kw)
    launches = read_counts()
    tag = f"29 qap n={n}"
    expect_launches(tag, launches, **{kernel: iters})
    seen = profiler_launches(tag, lambda: qap_power_sinkhorn(*card, n, n,
                                                             **kw))
    # a solve's wall time after those two (host clock, synchronised;
    # median of 5), its launches not counted
    saved = read_counts()
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        qap_power_sinkhorn(*card, n, n, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    ms = float(np.median(ms))
    restore_counts(saved)
    err = float((got.cpu() - want).abs().max())
    hard = greedy_perm(got, float(n), n, n).cpu()
    same = bool(torch.equal(hard, greedy_perm(want, float(n), n, n)))
    recovery = float(hard.numpy()[np.arange(n), perm].mean())
    saved = read_counts()
    obj = float(qap_objective(hard.to(DEV), *card, e1_mask=m, e2_mask=m))
    # the fused contraction against K3 on the same inputs, C = 17
    X = torch.randn((1, n, n, 17), generator=torch.Generator().manual_seed(
        n)).to(DEV)
    ops_in = [X, card[0][None], card[1][None]] + [a[None] for a in card[2:]]
    fused = assoc_matvec_fused(*ops_in, transpose=True)
    k3 = k23.assoc_matvec_large(*ops_in, transpose=True,
                                e1_mask=m[None], e2_mask=m[None])
    restore_counts(saved)
    row = {"n": n, "E": int(mask.sum()), "e_max": e_max,
           "assoc_edges": e_max * e_max, "iters": iters, "launches": launches,
           "profiler_launches": seen, "ms": ms, "max_abs_err_vs_cpu": err,
           "greedy_equal": same, "recovery": recovery, "objective": obj,
           "fused_vs_k3_rel_err": relerr(fused, k3)}
    say(f"[{tag}] " + json.dumps(row))
    if err > 1e-4 or not same or recovery < 0.9:
        fail(f"{tag}: soft assignment {err:.2e} from the CPU's (1e-4), "
             f"greedy equal {same}, recovery {recovery}")
    if row["fused_vs_k3_rel_err"] > 1e-5:
        fail(f"{tag}: assoc_matvec_fused differs from K3 by "
             f"{row['fused_vs_k3_rel_err']:.2e}")
    return row


def layer_cases():
    """Gconv, ChannelIndependentConv, DenseAssocGNNLayer and
    BilinearAffinity on the card against the CPU (TF32 off, 1e-5 of the
    range): B = 8 Delaunay graphs of 64 nodes / 384 edge slots, 32
    features; K of a 16-node pair materialized by assoc_dense."""
    rng = np.random.default_rng(SEED + 291)
    B, N, E, F = 8, 64, 384, 32
    src = np.zeros((B, E), np.int32)
    dst = np.zeros((B, E), np.int32)
    em = np.zeros((B, E), bool)
    for b in range(B):
        _, s, d = delaunay(rng, N - b)
        k = min(len(s), E)
        src[b, :k], dst[b, :k], em[b, :k] = s[:k], d[:k], True
    nm = np.arange(N)[None] < (N - np.arange(B))[:, None]
    x = rng.normal(size=(B, N, F)).astype(np.float32)
    ef = rng.normal(size=(B, E, 8)).astype(np.float32)
    perm, Kp, Ke, s1, d1, s2, d2, _ = planted_qap(rng, 16, 96)
    T = torch.from_numpy
    K = assoc_dense(*[T(a)[None] for a in (Kp, Ke, s1, d1, s2, d2)], 16, 16)
    Xa = T(rng.normal(size=(1, 256, 8)).astype(np.float32))
    am = T(np.arange(256)[None] < 200)
    Y = T(rng.normal(size=(B, 48, F)).astype(np.float32))
    torch.manual_seed(SEED)
    bil = t_layers.BilinearAffinity(F)
    with torch.no_grad():
        bil.A.add_(0.1 * torch.randn(F, F))
    cases = {
        "Gconv": (t_gcn.Gconv(F, 16), (x, src, dst, em, nm)),
        "ChannelIndependentConv": (t_gcn.ChannelIndependentConv(F, 8, 16),
                                   (x, ef, src, dst, em, nm)),
        "DenseAssocGNNLayer": (t_layers.DenseAssocGNNLayer(8, 16),
                               (K, Xa, am)),
        "BilinearAffinity": (bil, (x[:, :48], Y))}
    out = {}
    with tf32_off(), torch.no_grad():
        for name, (mod, args) in cases.items():
            args = [a if isinstance(a, torch.Tensor) else T(a) for a in args]
            want = mod(*args)
            got = copy.deepcopy(mod).to(DEV)(*[a.to(DEV) for a in args])
            pairs = list(zip(got, want)) if isinstance(want, tuple) \
                else [(got, want)]
            out[name] = max(relerr(g.cpu(), w) for g, w in pairs)
    say("[29 layers] card against CPU, error over range: " + json.dumps(out))
    bad = {k: v for k, v in out.items() if v > 1e-5}
    if bad:
        fail(f"29 layers: {bad}")
    return out


def phase_qap_layers(data_root):
    """29: the QAP solver on K2 / K3, the library layers, verify_setup."""
    t = time.time()
    out = {"qap": [qap_case(64, 384, "assoc_bucket"),
                   qap_case(256, 1536, "assoc_large")],
           "layers": layer_cases()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_verify.main(["--data-root", data_root])
    for line in buf.getvalue().splitlines():
        say(f"[29 verify_setup] {line}")
    if rc != 0:
        fail(f"29: verify_setup returned {rc}")
    out["verify_setup_rc"] = rc
    out["phase_s"] = time.time() - t
    say(f"[29] QAP, the library layers and verify_setup took "
        f"{out['phase_s']:.1f} s")
    return out


# ----------------------------------------------- 30-34 the port's tools
TOOL_KERNELS = tuple(KERNEL_NAMES)
# phase 30's timed steps a variant (the tool's default is 10): a step is
# host-bound and its host median moves by a quarter between variants, so
# the ablations are read by the profiled step's busy ms and launches
STEP_PROFILER_STEPS = 5


def tool_counts(counts):
    return {k: counts[k] for k in TOOL_KERNELS}


def check_self_profiled(tag, launches):
    """A tool's calls under torch.profiler: their K1 / K2 / K3 / K6
    launches by kernel name equal to the wrappers' counts of the same
    calls."""
    if launches["profiler"] != tool_counts(launches["wrappers"]):
        fail(f"{tag}: the profiler saw {launches['profiler']}, the "
             f"wrappers counted {launches['wrappers']}")


def check_device_events():
    """`scripts._measure.device_events` (the profiler's own records, which
    the tools and `profiler_launches` read) against torch.profiler's
    `key_averages()` on one window of 2,000 elementwise launches: the same
    launches and device ms. Returns both readings' host seconds."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 16, device=DEV)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2000):
            x.mul_(1.0)
        torch.cuda.synchronize()
    t = time.perf_counter()
    raw = _measure.device_events(prof)
    raw_s = time.perf_counter() - t
    t = time.perf_counter()
    evs = [e for e in prof.key_averages()
           if e.device_type.name == "CUDA" and e.device_time_total > 0
           and not e.is_user_annotation]
    avg_s = time.perf_counter() - t
    got = (sum(c for c, _ in raw.values()), sum(m for _, m in raw.values()))
    want = (sum(e.count for e in evs),
            sum(e.device_time_total for e in evs) / 1e3)
    say(f"[30 profiler records] launches, device ms: {got} from the "
        f"records in {raw_s:.3f} s, {want} from key_averages() in "
        f"{avg_s:.3f} s")
    if got[0] != want[0] or abs(got[1] - want[1]) > 1e-6 * want[1]:
        fail(f"30: the profiler's records {got} against key_averages() "
             f"{want}")
    return {"records_s": raw_s, "key_averages_s": avg_s,
            "launches": got[0], "device_ms": got[1]}


def phase_profile_train_step_tool():
    """30: scripts.profile_train_step at its shapes (Config() at full
    width, B=8, n_max 64, stage 3; `STEP_PROFILER_STEPS` timed steps a
    variant after two warm-up steps, one under torch.profiler): the step
    split and the ablations. Every variant's profiled launches of K1 / K2 / K3 / K6 equal
    to the wrappers'; K2 in every variant but the optimizer's, K6 where a
    backward runs."""
    t = time.time()
    records = check_device_events()
    reset_counts()
    out = step_profiler.run("cuda", steps=STEP_PROFILER_STEPS,
                            profile_steps=1)
    launches = read_counts()
    out["profiler_records"] = records
    for name, row in out["variants"].items():
        check_self_profiled(f"30 {name}", {
            "wrappers": row["wrapper_launches"],
            "profiler": row["profiler_launches"]})
        w = row["wrapper_launches"]
        forward = name != "optimizer_step"
        backward = forward and name not in ("forward_eval", "forward_train")
        if (w["assoc_bucket"] > 0) != forward \
                or (w["assoc_grad"] > 0) != backward \
                or w["assoc_univ_v3"] or w["assoc_large"]:
            fail(f"30 {name}: kernel launches {w}")
        if not (np.isfinite(row["median_ms"]) and row["device_busy_ms"] > 0
                and 0 <= row["idle_share"] <= 1):
            fail(f"30 {name}: {row}")
        say(f"[30 profile_train_step] {name}: {row['median_ms']:.1f} ms, "
            f"{row['pairs_per_s']:.1f} pairs/s; busy "
            f"{row['device_busy_ms'] / row['profiled_steps']:.1f} ms a "
            f"step, idle {row['idle_share']:.3f}, "
            f"{row['launches'] / row['profiled_steps']:.0f} launches a "
            f"step; measured in {row['measure_s']:.1f} s")
    say(f"[30 profile_train_step] split (ms): {json.dumps(out['split_ms'])}")
    out["launches"] = launches
    out["phase_s"] = time.time() - t
    return out


def phase_edge_partition_tool():
    """31: scripts.bench_edge_partition at its defaults (n = 512, C = 16,
    seed 0): one device (K3), p = 2 / 4 / 8 ranks (emulated in this process
    on one card), each held to 1e-5 of the one-device result's range, every
    timed call's launches against torch.profiler's."""
    t = time.time()
    reset_counts()
    out = bench_edge_partition.run("cuda")
    launches = read_counts()
    check_self_profiled("31 single", out["single_device_launches"])
    single = out["single_device_launches"]
    if tool_counts(single["wrappers"]) != {
            **{k: 0 for k in TOOL_KERNELS}, "assoc_large": single["calls"]}:
        fail(f"31: each one-device call must be one K3 launch: {single}")
    for p in bench_edge_partition.SHARDS:
        row = out[f"p{p}"]
        check_self_profiled(f"31 p={p}", row["launches"])
        if not (row["max_rel_err_vs_single"] <= 1e-5
                and row["launches"]["wrappers"]["assoc_large"]
                == 2 * p * row["launches"]["calls"]):
            fail(f"31 p={p}: {row}")
        say(f"[31 edge partition] p={p} ({row['mode']}): "
            f"{row['sharded_ms']:.3f} ms against {out['single_device_ms']:.3f}"
            f" ms on one device; halo {row['halo_rows_per_layer']} rows, "
            f"{row['halo_bytes_per_layer']} bytes a layer, fraction "
            f"{row['halo_fraction_vs_replication']:.4f}; error "
            f"{row['max_rel_err_vs_single']:.2e}")
    out["launches"] = launches
    out["phase_s"] = time.time() - t
    return out


def phase_mesh_scaling_tool():
    """32: scripts.bench_cli_mesh_scaling: `python -m
    fpmatch_tpu_torch.cli.train --n-devices N` in a child process on the
    reference script's dataset and flags; N = 1 here (N = 2, 4 where as many
    cards are visible). Its kernels run in the child process, where this
    process's counters and profiler do not reach."""
    t = time.time()
    out = bench_cli_mesh_scaling.run("cuda")
    one = out["runs"].get("1")
    if not one or not (one["pairs_per_s"] > 0
                       and np.isfinite(one["ms_per_step"])):
        fail(f"32: {out}")
    say(f"[32 mesh scaling] {json.dumps(out['runs'])}; left out: "
        f"{json.dumps(out['left_out'])}")
    out["phase_s"] = time.time() - t
    return out


def phase_reports_tools(tmp):
    """33: the reports on phase 17's checkpoint (`ckpt1`, latest
    stage6_last) over a test split with sibling fingers written here:
    cli.evaluate writes scores.csv, scripts.hard_impostor_report reads it;
    scripts.matching_recall_report on the card (K2; its launches against
    torch.profiler's), and its first batch on the card (TF32 off) against
    the port's CPU run: the card's mean recall and precision within 0.02
    of the CPU's (a greedy pick may flip on a rounding tie)."""
    t = time.time()
    root = f"{tmp}/reports/Synthetic"
    generate_synthetic_dataset(root, fingers_per_split=(1, 4, 1),
                               n_pores=60, seed=SEED, size=(320, 280),
                               sessions=2, stances=1, sibling_fraction=0.5)
    ckpt = f"{tmp}/train/ckpt1"
    cli_evaluate.main(["--data-root", root, "--checkpoint-dir", ckpt,
                       "--output-dir", f"{tmp}/reports/eval",
                       "--thread-workers", "--num-viz", "0"])
    hard = hard_impostor_report.report(
        f"{tmp}/reports/eval/scores.csv",
        siblings_json=f"{root}/siblings.json")
    say(f"[33 hard impostors] {json.dumps(hard)}")
    if not (hard["n_sibling_impostors"] > 0
            and np.isfinite(hard["sibling_eer"])):
        fail(f"33: hard-impostor report {hard}")
    argv = ["--data-root", root, "--checkpoint-dir", ckpt, "--node-taps",
            "layer3", "--thread-workers"]
    # the report's one run, under torch.profiler (a window retaken after a
    # dropped record runs it again; the last run's report is kept)
    reps = []
    reset_counts()
    prof = _measure.profiled(
        lambda: reps.append(matching_recall_report.main(argv)), DEV, 1)
    launches = read_counts()
    rec = reps[-1]
    check_self_profiled("33 matching recall", {
        "wrappers": prof["wrapper_launches"],
        "profiler": prof["profiler_launches"]})
    if launches["assoc_bucket"] <= 0 or any(
            v for k, v in tool_counts(launches).items()
            if k != "assoc_bucket"):
        fail(f"33: matching recall launches {launches}")
    with tf32_off():
        card1 = matching_recall_report.main(argv + ["--limit", "1"])
        cpu1 = matching_recall_report.main(argv + ["--limit", "1",
                                                   "--device", "cpu"])
    diff = {k: abs(card1[k] - cpu1[k]) for k in (
        "matching_recall", "matching_precision")}
    same = float(np.mean([a == b for a, b in zip(
        card1["per_pair"]["recall"], cpu1["per_pair"]["recall"])]))
    summary = {k: v for k, v in rec.items() if k != "per_pair"}
    say(f"[33 matching recall] {json.dumps(summary)}")
    say(f"[33 matching recall] first batch, card against CPU (TF32 off): "
        f"{json.dumps(diff)}; pairs with the same recall {same:.3f}")
    if not all(v <= 0.02 for v in diff.values()):
        fail(f"33: card and CPU differ: {diff}")
    out = {"hard_impostors": hard, "matching_recall": rec,
           "card_vs_cpu_first_batch": {"diff": diff, "same_recall": same},
           "launches": launches, "phase_s": time.time() - t}
    return out


def phase_cap_sweep_tool(flush):
    """34: K1's slot-cap sweep (scripts/time_univ_v3.py's `sweep_caps`) at
    caps 8, 16, 24 on its own inputs (n = 600, C = 16, bf16 X): each row
    held to its plain version, one call of each under torch.profiler."""
    t = time.time()
    reset_counts()
    rows = time_univ_v3.sweep_caps([8, 16, 24], DEV, 20, flush)
    launches = read_counts()
    for r in rows:
        check_self_profiled(f"34 cap {r['cap']}", r["launches"])
        say(f"[34 cap sweep] " + json.dumps(r))
    return {"rows": rows, "launches": launches, "phase_s": time.time() - t}


def phase_tools(tmp):
    """30-34; returns their JSON."""
    t = time.time()
    out = {"profile_train_step": phase_profile_train_step_tool(),
           "edge_partition": phase_edge_partition_tool(),
           "mesh_scaling": phase_mesh_scaling_tool(),
           "reports": phase_reports_tools(tmp),
           "cap_sweep": phase_cap_sweep_tool(tune_univ.l2_flush(DEV))}
    out["phase_s"] = time.time() - t
    say(f"[30-34] the tools' phases took {out['phase_s']:.1f} s: " + ", ".join(
        f"{k} {v['phase_s']:.1f}" for k, v in out.items() if k != "phase_s"))
    return out


# --------------------------------------------------------------- 35 sinkhorn
SK_CELLS = ("resnet18.eval-n64", "vgg16bn.eval-n64", "resnet18.train-s3")


def sinkhorn_inputs(B, S, seed=SEED):
    """Scores, an upstream gradient and counts of 40..S valid rows and
    columns (the eval-n64 traffic's crops: both orientations, a live dummy
    band), on the card."""
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(B, S, S, generator=g).to(DEV)
    dy = torch.randn(B, S, S, generator=g).to(DEV)
    n1 = torch.randint(40, S + 1, (B,), generator=g).to(DEV)
    n2 = torch.randint(40, S + 1, (B,), generator=g).to(DEV)
    return s, dy, n1, n2


def sinkhorn_rows(flush):
    """The kernels against the plain ops at the main path's shape (B = 512,
    S = 64, tau 0.01) with 20 and 10 sweeps, forward and backward: errors
    (forward: 2e-5 absolute; backward: 5e-5 of the plain gradient's range,
    tests/test_torch_sinkhorn_kernel.py's limits), CUDA-event medians of 20
    calls behind an L2 flush (the backward through autograd.grad, which
    launches the backward kernel alone), the kernels alone by torch.profiler
    and the bound: each direction reads and writes B S^2 floats (the
    backward reads two arrays)."""
    B, S, tau = 512, 64, 0.01
    s, dy, n1, n2 = sinkhorn_inputs(B, S)
    n = B * S * S
    rows = []
    for iters in (20, 10):
        kw = dict(tau=tau, max_iter=iters)
        x = s.clone().requires_grad_(True)
        xp = s.clone().requires_grad_(True)
        out = k_sk.sinkhorn_kernel(x, n1, n2, **kw)
        want = ops_sk.sinkhorn_batch_plain(xp, n1, n2, **kw)
        bwd = lambda: torch.autograd.grad(out, x, dy, retain_graph=True)[0]
        bwd_plain = lambda: torch.autograd.grad(want, xp, dy,
                                                retain_graph=True)[0]
        cases = (
            ("forward", out.detach(), want.detach(),
             lambda: k_sk.sinkhorn_kernel(s, n1, n2, **kw),
             lambda: ops_sk.sinkhorn_batch_plain(s, n1, n2, **kw),
             "sinkhorn_fwd_kernel", 2 * 4 * n, (5 * iters + 1) * n),
            ("backward", bwd(), bwd_plain(), bwd, bwd_plain,
             "sinkhorn_bwd_kernel", 3 * 4 * n, 10 * iters * n))
        for dirn, got, ref, call, plain, key, nbytes, flops in cases:
            torch.cuda.synchronize()
            r = {"dir": dirn, "B": B, "S": S, "iters": iters, "tau": tau,
                 "max_abs_err": float((got - ref).abs().max()),
                 "err_vs_plain": relerr(got, ref),
                 "ms": time_ms(call, flush=flush),
                 "plain_ms": time_ms(plain, flush=flush),
                 "kernel_ms": tune_univ.profiled_ms(call, key, flush=flush),
                 "library_ms": None, "bytes": nbytes, "flops": flops,
                 **bound(nbytes, flops)}
            say("[35 sinkhorn] " + json.dumps(r))
            if not (r["max_abs_err"] <= 2e-5 if dirn == "forward"
                    else r["err_vs_plain"] <= 5e-5):
                fail(f"35: the Sinkhorn kernel's {dirn} ({iters} sweeps) "
                     f"is off the plain ops: {r}")
            rows.append(r)
    return rows


def sinkhorn_engagement():
    """One batch of each benchmark cell's configuration and traffic (the
    harness's own model, weights and generator, at the cell's batch size):
    an evaluate_loader batch for the eval cells, a train step for the train
    cell. Every Sinkhorn call must launch the forward kernel (and the train
    step the backward one): no plain call."""
    from perfbench import harness
    from perfbench.traffic.generator import make_pool

    rows = {}
    for name in SK_CELLS:
        cell = harness.load_cell(name)
        traffic, B = cell.traffic, cell.spec["batch"]
        cfg = harness.port_config(cell.config, traffic)
        model = build_model(cfg, device="cuda", state_dict=harness.make_weights(
            harness.model_shapes(cfg), SEED, DEV))
        batch = t_ngm.PairBatch(**make_pool(dict(traffic, pool=1), B, SEED,
                                            DEV)[0])
        train = traffic["task"] == "train"
        reset_counts()
        if train:
            stage = default_stages()[traffic["stage"] - 1]
            make_train_step(model, stage)(create_state(model, stage), batch)
        else:
            cli_evaluate.evaluate_loader(model, [batch],
                                         score=traffic["score"],
                                         discretize=traffic["discretize"])
        torch.cuda.synchronize()
        c = read_counts(SINKHORN_COUNTS)
        calls = c["sinkhorn_fwd"] + c["sinkhorn_plain"]
        rows[name] = dict(c, batch=B, engagement_pct=100.0 * c[
            "sinkhorn_fwd"] / max(calls, 1))
        say(f"[35 sinkhorn] {name} (B = {B}): {rows[name]}")
        if not c["sinkhorn_fwd"] or c["sinkhorn_plain"] or (
                train and not c["sinkhorn_bwd"]):
            fail(f"35: {name}: a Sinkhorn call took the plain ops or no "
                 f"kernel ran: {c}")
        del model, batch
        torch.cuda.empty_cache()
    return rows


def phase_sinkhorn():
    """35: returns (timed rows, engagement by cell)."""
    t = time.time()
    saved = read_counts(COUNTS)
    rows = sinkhorn_rows(tune_univ.l2_flush(DEV))
    restore_counts(saved)
    engagement = sinkhorn_engagement()
    say(f"[35 sinkhorn] {time.time() - t:.1f} s")
    return rows, engagement


def kernel_entry(name, source, rows, launches, replaces, pick, shape_keys):
    """One entry of the `kernels` JSON line: the numbers of the timed row
    `pick` selects, the worst errors over all rows (K4's bf16-X rows, held
    to one bf16 ulp of their kept part, apart), every timed shape."""
    timed = [r for r in rows if "ms" in r]
    main = next(r for r in timed if pick(r))
    exact = [r for r in rows if "bf16_cells_off" not in r]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in exact),
        "max_rel_err": max(r["err_vs_plain"] for r in exact),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        **{k: main[k] for k in ("ms_bf16", "bound_ms_bf16",
                                "library_bf16_ms") if k in main},
        "shapes": [{k: r.get(k) for k in shape_keys} for r in timed]}


def sinkhorn_entry(rows, engagement):
    """The Sinkhorn kernels' entry of the `kernels` line: the forward at 20
    sweeps as its main row; launches of one batch (a step) of each
    benchmark cell's configuration, and their engagement."""
    keys = ("dir", "B", "S", "iters", "ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "bytes", "flops")
    entry = kernel_entry("sinkhorn", k_sk.SOURCE, rows,
                         engagement[SK_CELLS[0]]["sinkhorn_fwd"],
                         k_sk.REPLACES, lambda r: (r["dir"], r["iters"]) ==
                         ("forward", 20), keys)
    entry["launches_cells"] = engagement
    return entry


def main():
    profile = "--profile" in sys.argv[1:]
    card = phase_device()
    try:
        import matplotlib
        say(f"[1 device] matplotlib {matplotlib.__version__} (plots of "
            f"cli.evaluate; not on the device path)")
    except ImportError:
        say("[1 device] matplotlib not installed: cli.evaluate's plots "
            "cannot be drawn here (not on the device path)")
    row5 = phase_build()
    if "--only-sinkhorn" in sys.argv[1:]:
        rows35, engagement35 = phase_sinkhorn()
        say(json.dumps({"kernels": [sinkhorn_entry(rows35, engagement35)]}))
        say(card)
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    rows1 = phase_kernels()
    rows23, plan_ms, wide = phase_kernels_bucket()
    rows4 = phase_kernels_univ()

    cfg = cli_config(600, 3840, 600)
    t = time.time()
    model = build_model(cfg, device="cuda", seed=SEED)
    n_par = sum(p.numel() for p in model.parameters())
    say(f"[4 serve univ] full-width model ({n_par / 1e6:.1f} M parameters) "
        f"initialised from seed {SEED} in {time.time() - t:.1f} s")
    launches1, t_univ, req = phase_serve_univ(model)
    if profile:
        phase_profile("one UNIV request",
                      lambda: match_arrays(model, *req))
    phase_parity(model, cfg, req)
    del model
    torch.cuda.empty_cache()
    t_bucket = phase_serve_bucket()

    with tempfile.TemporaryDirectory(prefix="fpm_smoke_") as tmp:
        ecfg = eval_config(8, 64, 384)
        emodel = build_model(ecfg, device="cuda", seed=SEED)
        secs = write_split(f"{tmp}/bucket", fingers=7, n_pores=110)
        say(f"[7 evaluate] synthetic test split (7 fingers x 2 sessions x 2 "
            f"stances, 110 pores) written in {secs:.1f} s")
        launches2, res7, pd = phase_evaluate(emodel, ecfg, f"{tmp}/bucket",
                                             f"{tmp}/index")
        (_, _), batch = phase_evaluate_parity(emodel, ecfg, pd)
        if profile:
            phase_profile("one evaluate batch of 8", lambda: emodel(batch))
        del emodel, batch
        torch.cuda.empty_cache()
        # 320 pores per finger leave 200-256 keypoints inside the
        # standardized 240x320 crop
        secs = write_split(f"{tmp}/large", fingers=2, n_pores=320)
        say(f"[9 evaluate large] synthetic test split (2 fingers x 2 x 2, "
            f"320 pores) written in {secs:.1f} s")
        launches3, res9 = phase_evaluate_large(f"{tmp}/large",
                                               f"{tmp}/index")
        launches4, rows10 = phase_tune()
        phase_native()
        det_rows, dpf_rows, tf32_changed = phase_detect()
        bare = phase_serve_bare(tmp)
        hung_univ, hung_bucket = phase_hungarian()
        launches14, _, wall14 = phase_evaluate_hungarian(ecfg, pd)
        rows15 = phase_backward_kernels()
        parity16 = phase_train_parity()
        if profile:
            profile_train_step()
        train_runs, smoke = phase_train(tmp)
        rows18 = phase_backward_bf16()
        serve19 = phase_serve_bf16(tmp, t_univ, t_bucket)
        eval20 = phase_evaluate_bf16(pd, f"{tmp}/large", f"{tmp}/index",
                                     res7, res9)
        parity21 = phase_train_parity_bf16()
        train21 = phase_train_bf16(tmp, train_runs)
        options = phase_options(tmp)
        mesh27 = phase_mesh()
        poredet28 = phase_train_poredet(tmp)
        qap29 = phase_qap_layers(f"{tmp}/bucket")
        tools = phase_tools(tmp)
        rows35, engagement35 = phase_sinkhorn()
    parent = (phase_parent_timing(Path(sys.argv[sys.argv.index("--parent")
                                                 + 1]).resolve())
              if "--parent" in sys.argv[1:] else None)
    # the sweep times K4's (32, 128) f32 row; phase 3 the rest of that row
    main4 = next(r for r in rows4 if "bound_ms" in r)
    main4.update(next({k: r[k] for k in ("ms", "kernel_ms")}
                      for r in rows10 if (r["r1"], r["r2"], r["prec"])
                      == (main4["r1"], main4["r2"], main4["prec"])))
    # the library call computes the same function whatever the block size
    say(f"[10 tune] rows faster than the library call on the same inputs "
        f"({main4['library_ms']:.4f} ms): "
        f"{sum(r['ms'] < main4['library_ms'] for r in rows10)} of "
        f"{len(rows10)}; slowest row {max(r['ms'] for r in rows10):.4f} ms")

    keys1 = ("C", "N", "E1", "E2", "S1", "S2", "ms", "kernel_ms",
             "ms_warm_l2", "ms_bf16", "plain_ms", "noplan_ms", "library_ms",
             "library_bf16_ms", "bound_ms", "bound_ms_bf16", "bound_by",
             "bytes", "flops")
    keys23 = ("B", "N", "E", "C", "assoc_edges", "ms", "kernel_ms",
              "ms_warm_l2", "ms_bf16", "plain_ms", "ops_ms", "library_ms",
              "library_bf16_ms", "bound_ms", "bound_ms_bf16", "bound_by",
              "bytes", "flops")
    keys3 = keys23 + ("path", "k2_ms", "k2_ms_bf16", "k2_kernel_ms")
    keys4 = ("n", "C", "r1", "r2", "prec", "b1", "b2", "spill1", "spill2",
             "ker_mb", "ms", "kernel_ms", "gather_ms",
             "plain_ms", "k1_ms", "library_ms", "bound_ms", "bound_by",
             "bytes", "flops")
    keys15 = ("B", "N", "E", "C", "assoc_edges", "path", "ms", "kernel_ms",
              "plain_ms", "dX_ms", "dX_kernel_ms", "dX_kernel",
              "dX_bound_ms", "dX_library_ms",
              "library_ms", "library_bf16_ms", "library_nnz", "bound_ms",
              "bound_by", "bytes", "flops")
    keys5 = ("shape", "ms", "plain_ms", "library_ms", "first_ms",
             "second_ms", "bound_ms", "bound_by", "bytes")
    of = lambda name: [r for r in rows23 if r["kernel"] == name]
    kernels = {"kernels": [
        kernel_entry("assoc_univ_v3", k1.SOURCE, rows1,
                     launches1["assoc_univ_v3"], k1.REPLACES,
                     lambda r: r["C"] == 17, keys1),
        # each at the shape its main path gives it
        kernel_entry("assoc_bucket", k23.SOURCE, of("assoc_bucket"),
                     launches2["assoc_bucket"],
                     k23.REPLACES["assoc_bucket"],
                     lambda r: (r["N"], r["C"]) == (64, 17), keys23),
        kernel_entry("assoc_large", k23.SOURCE, of("assoc_large"),
                     launches3["assoc_large"], k23.REPLACES["assoc_large"],
                     lambda r: (r["N"], r["C"]) == (256, 17), keys3),
        # ms: the whole wrapper with KeR given, as tune_univ times it
        kernel_entry("assoc_univ", k4.SOURCE, rows4,
                     launches4["assoc_univ"], k4.REPLACES,
                     lambda r: (r["r1"], r["r2"]) == (32, 128), keys4),
        kernel_entry("inoculate", k5.SOURCE, [row5],
                     launches4["inoculate"], k5.REPLACES, lambda r: True,
                     keys5),
        # K6: launches of the first full-width cli.train run (phase 17)
        kernel_entry("assoc_grad", k6.SOURCE, rows15,
                     train_runs[0][2]["assoc_grad"], k6.REPLACES,
                     lambda r: (r["N"], r["C"]) == (64, 17), keys15),
        # K6's bf16-X instantiation: launches of cli.train --bf16 (phase 21)
        kernel_entry("assoc_grad_bf16", k6.SOURCE, rows18,
                     train21["launches"]["assoc_grad"], k6.REPLACES,
                     lambda r: (r["N"], r["C"]) == (64, 17), keys15)]}
    # the bf16 instantiations of K1 / K2 / K3 on the --bf16 paths: their
    # launches there (phases 19, 20), and the bf16 dX launch of K2 / K3
    ks = kernels["kernels"]
    ks[0]["launches_bf16"] = serve19["univ"]["launches"]["assoc_univ_v3"]
    ks[1]["launches_bf16"] = eval20["assoc_bucket"]["launches"][
        "assoc_bucket"]
    ks[2]["launches_bf16"] = eval20["assoc_large"]["launches"]["assoc_large"]
    # the bf16 dX launch, keyed by its own orientation (the forward's
    # flipped); K3's at N=256 (the forward there is K^T)
    ks[1]["dX_bf16_ms"] = {f"transpose={not r['transpose']}": r["dX_ms"]
                           for r in rows18 if (r["N"], r["C"]) == (64, 17)}
    ks[2]["dX_bf16_ms"] = {f"transpose={not r['transpose']}": r["dX_ms"]
                           for r in rows18 if r["N"] == 256 and "dX_ms" in r}
    for k, n in ((ks[1], 64), (ks[2], 256)):
        k["dX_bf16_bound_ms"], k["dX_bf16_library_ms"] = next(
            (r["dX_bound_ms"], r["dX_library_ms"]) for r in rows18
            if "dX_bound_ms" in r and (r["N"], r["C"]) == (n, 17))
    if parent is not None:
        # the kernels this PR changed, timed with the parent's tree in turns:
        # each parent median beside this tree's median from the same turns
        # (`ms` above is phase 15's, another measurement)
        pick = lambda row, side: float(np.median(parent[row + "/N64/C17"]
                                                 [side]))
        for k, key, row in ((ks[1], "ms", "fwd_f32"),
                            (ks[1], "ms_bf16", "fwd_bf16"),
                            (ks[5], "ms", "k6_f32"),
                            (ks[6], "ms", "k6_bf16")):
            k[key + "_parent"] = pick(row, "parent_ms")
            k[key + "_this_tree"] = pick(row, "ms")
        for side, key in (("parent_ms", "parent"), ("ms", "this_tree")):
            ks[1][f"dX_bf16_ms_{key}"] = {
                "transpose=False": pick("dx_bf16_T", side),
                "transpose=True": pick("dx_bf16_N", side)}
        for k, row in ((ks[1], "fwd_f32"), (ks[5], "k6_f32"),
                       (ks[6], "k6_bf16")):
            t = parent[f"{row}/N64/C17"]
            if None not in t["parent_kernel_ms"] + t["kernel_ms"]:
                k["kernel_ms_parent"] = float(np.median(
                    t["parent_kernel_ms"]))
                k["kernel_ms_this_tree"] = float(np.median(t["kernel_ms"]))
        for k, rows in ((ks[1], ("fwd_f32", "fwd_bf16", "dx_bf16_T",
                                 "dx_bf16_N")), (ks[5], ("k6_f32",)),
                        (ks[6], ("k6_bf16",))):
            k["vs_parent"] = {r: parent[r] for r in parent
                              if r.split("/")[0] in rows}
        same = {r: t["same_bits_as_parent"] for r, t in parent.items()}
        if not all(same.values()):
            fail(f"outputs differ from the parent's bits: {same}")
    # the launches of the matcher's options' paths (phases 22-26)
    ks[1]["launches_options"] = {
        "22_serve": options["serve"]["launches"]["assoc_bucket"],
        "23_evaluate": options["evaluate"]["assoc_bucket"]["launches"][
            "assoc_bucket"],
        "24_train_step": options["train_step"]["launches"]["assoc_bucket"],
        "25_backbones": sum(b["launches"]["assoc_bucket"]
                            for b in options["backbones"].values()),
        "26_overfit": options["overfit"]["launches"]["assoc_bucket"]}
    ks[2]["launches_options"] = {
        "23_evaluate_large": options["evaluate"]["assoc_large"]["launches"][
            "assoc_large"]}
    # the edge-sharded path (phase 27): per rank, the forward of the world
    # size 1 model and its stage-3 step; the emulated ranks' forward and
    # backward at N = 64 (K2, K6) and N = 256 (K3, K6), all p and
    # orientations together
    w1, emu = mesh27["world_1"], mesh27["emulated"]
    for k, name in ((ks[1], "assoc_bucket"), (ks[5], "assoc_grad")):
        k["launches_mesh"] = {
            "27_forward_per_rank": w1["forward_launches"][name],
            "27_train_step_per_rank": w1["step_launches"][name],
            "27_emulated_N64": sum(r["launches_fwd_bwd"].get(name, 0)
                                   for r in emu if r["N"] == 64)}
    ks[5]["launches_mesh"]["27_emulated_N256"] = sum(
        r["launches_fwd_bwd"].get("assoc_grad", 0) for r in emu
        if r["N"] == 256)
    ks[2]["launches_mesh"] = {"27_emulated_N256": sum(
        r["launches_fwd_bwd"].get("assoc_large", 0) for r in emu
        if r["N"] == 256)}
    # the QAP solver's power iteration (phase 29): one launch an iteration
    for k, row in zip(ks[1:3], qap29["qap"]):
        k["launches_qap"] = {f"29_qap_n{row['n']}": row["launches"][
            k["name"]]}
    ks[5]["launches_options"] = {
        "24_train_step": options["train_step"]["launches"]["assoc_grad"],
        "26_overfit": options["overfit"]["launches"]["assoc_grad"]}
    # the port's tools (phases 30-34): K2 / K6 in the train-step profiler,
    # K3 in the edge-partition timer, K2 in the matching-recall report, K1
    # in the cap sweep
    tl = {k: v["launches"] for k, v in tools.items() if k in (
        "profile_train_step", "edge_partition", "reports", "cap_sweep")}
    ks[0]["launches_tools"] = {"34_cap_sweep":
                               tl["cap_sweep"]["assoc_univ_v3"]}
    ks[1]["launches_tools"] = {
        "30_profile_train_step": tl["profile_train_step"]["assoc_bucket"],
        "33_matching_recall": tl["reports"]["assoc_bucket"]}
    ks[2]["launches_tools"] = {"31_edge_partition":
                               tl["edge_partition"]["assoc_large"]}
    ks[5]["launches_tools"] = {"30_profile_train_step":
                               tl["profile_train_step"]["assoc_grad"]}
    # the grouping prologue the bucket wrappers share, once per batch
    for k in kernels["kernels"][1:3]:
        k["plan_ms"] = plan_ms
    # K3 per block_c at its main shape; both kernels on the 4096-column row
    kernels["kernels"][2]["block_c_ms"] = next(
        r["block_c_ms"] for r in of("assoc_large") if "block_c_ms" in r
        and r["N"] == 256)
    for k in kernels["kernels"][1:3]:
        k["wide_row"] = wide[k["name"]]
    kernels["kernels"][3]["sweep"] = [
        {k: r[k] for k in ("r1", "r2", "prec", "b1", "b2", "spill", "ms",
                           "kernel_ms", "edges_per_s", "err_vs_plain")}
        for r in rows10]
    kernels["kernels"].append(sinkhorn_entry(rows35, engagement35))
    say(json.dumps(kernels))
    # the slice of bare-image serving and Hungarian discretization: host
    # work around the kernels above (no kernel of its own)
    say(json.dumps({"bare_image_serving": {
        "detect": det_rows, "dpf": dpf_rows,
        "tf32_changed_detections": tf32_changed, "serve": bare,
        "hungarian_univ": hung_univ, "hungarian_bucket": hung_bucket,
        "evaluate_hungarian": {"launches": launches14, "wall_s": wall14}}}))
    # the training slice: the card against its CPU run, the curriculum's
    # per-stage rows of both full-width runs and of the smoke run
    say(json.dumps({"training": {
        "parity": parity16,
        "runs": [{"stages": rows, "report": report, "launches": launches,
                  "wall_s": wall} for rows, report, launches, wall in
                 train_runs],
        "smoke": {"stages": smoke[0], "launches": smoke[2],
                  "wall_s": smoke[3]}}}))
    # the --bf16 slice: serving, evaluation and training beside f32
    say(json.dumps({"bf16": {
        "serve": serve19, "evaluate": eval20, "train_parity": parity21,
        "train": train21}}))
    # the matcher's options: hyperedge, cls-k, the other backbones, overfit
    say(json.dumps({"options": options}))
    # the edge-sharded path: world size 1 over NCCL, the emulated ranks
    say(json.dumps({"mesh": mesh27}))
    # the detector trained on the card; QAP and the library layers
    say(json.dumps({"poredet_train": poredet28, "qap_layers": qap29}))
    say(f"[28-29] the two phases took {poredet28['phase_s']:.1f} + "
        f"{qap29['phase_s']:.1f} s")
    # the port's tools: the step split and ablations, the halo table, the
    # scaling run, the reports, K1's cap sweep
    say(json.dumps({"tools": tools}))
    say(card)
    say(f"[done] {time.time() - T0:.0f} s in all")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
