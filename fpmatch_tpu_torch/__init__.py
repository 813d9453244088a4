"""fpmatch_tpu_torch — the PyTorch/CUDA port of `fpmatch_tpu`.

Deep graph matching for fingerprint verification over sweat-pore keypoint
graphs, for one NVIDIA Hopper GPU. The JAX package `fpmatch_tpu` beside this
one is the reference; this package imports none of it (and no JAX) and keeps
its own copies of the host-side code it needs. Modules sit at the same paths
as their JAX counterparts:

  core/     typed configs, host-side graph construction, padded graphs
  native/   host C++ (LAPJV, fixed-box NMS) built with g++ at first use
  ops/      batch-native graph-matching math in plain PyTorch (Sinkhorn,
            soft top-k, feature alignment, spline conv, factorized
            association-graph matvec, the QAP power iteration), the host
            Hungarian solve
  kernels/  hand-written CUDA C++ kernels (sources under kernels/csrc/, built
            with nvcc for sm_90a at first use) with a plain PyTorch version
            beside each; the association matvec's backward among them
  models/   nn.Modules: ResNet-18 and VGG16 backbones (and the pathway of
            precomputed keypoint features), spline net, association-graph
            GNN layers (with the triangle hyperedge term), AFA-U
            k-predictor, match classifier, the full NGMNet; the library
            layers (graph convolutions, bilinear affinity, dense-K GNN)
  data/     numpy side: synthetic pairs and datasets, the dataset index and
            pair protocols, augmentation, pair construction, collation, the
            loader
  evaluation/  matching and verification metrics (ROC / EER / FAR / FRR)
  train/    train and eval steps, the losses, the per-stage AdamW over
            parameter partitions, the warmup + plateau scheduler, the
            curriculum loop, checkpoint files (and the JAX package's, as
            .npz)
  parallel/ the data x edge rank grid (torch.distributed, NCCL / gloo): the
            row-sharded association graph with its halo all-to-all, global
            batch statistics and gradient sums (`cli.train --mesh DxE`)
  utils/    match, heatmap and graph drawings, the metrics logger,
            profiling (torch.profiler traces, timing, the roofline)
  poredet/  the pore detector: patch-CNN family, its patch training,
            full-image inference, DPF
  cli/      entry points (single-pair serving: `cli.match`; batched
            verification evaluation: `cli.evaluate`; the training
            curriculum: `cli.train`; one pair overfitted: `cli.overfit`;
            pore detection over an image tree: `cli.detect_pores`; the
            environment check: `cli.verify_setup`; dataset tools:
            `cli.split_dataset`, `cli.combine_dataset`,
            `cli.preview_augmentations`)
  scripts/  the block-size sweep of the blocked UNIV kernel (`tune_univ`),
            kernel timings (K1's with its slot-cap sweep), the pore
            detector's training (`train_poredet`), the train-step profiler,
            the edge-partition and mesh-scaling timers, the matching-recall
            and hard-impostor reports, the fixture regeneration
  convert   Flax variable tree (as numpy) -> state_dict (matcher, detector)

COVERAGE.md maps every public function and class of the JAX package, and
every tool of its `scripts/`, to its counterpart here or to the reason it
has none.

Where the JAX package lifts single-pair functions with vmap, this package is
batch-native: functions take (B, ...) tensors and per-sample counts. Entry
points run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"


def resolve_device(device="cuda"):
    """The torch.device an entry point runs on. `cuda` (the default) raises
    when no GPU is present: entry points never carry on on the CPU unless the
    caller asked for it."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev
