"""Typed configuration tree (host code).

Field-for-field the same tree as the JAX package's `core/config.py`: the
weight converter, the CLIs and the parity tests rely on the names and the
defaults, so a config round-trips between the two packages. `MeshConfig`
is kept for that alone: the rank grid comes from `cli.train`'s `--mesh` /
`--n-devices`, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    """Static shape buckets: every ragged quantity (nodes, edges, triangles)
    is padded to these maxima and accompanied by an integer count."""

    n_max: int = 64          # max keypoints per graph (bucket)
    e_max: int = 384         # max directed edges per graph (Delaunay e ~ 6n)
    t_max: int = 384         # max hyperedge (triangle) slots
    univ_size: int = 600     # AFA-U one-hot embedding width

    @property
    def assoc_nodes(self) -> int:
        return self.n_max * self.n_max


@dataclass(frozen=True)
class BackboneConfig:
    """ResNet-18 split: node features from layer3 (stride 16, 256ch), edge
    features from layer4 (stride 32, 512ch), global feature from a global
    max-pool of layer4."""

    kind: str = "resnet18"   # or "vgg16" / "vgg16_bn" / "none"
    node_channels: int = 256
    edge_channels: int = 512
    dtype: str = "float32"   # or "bfloat16": bf16 convolutions, f32 BatchNorm
    # stages contributing node features; add "layer2" (stride 8, 128ch) and
    # raise NGMConfig.node_feature_dim by 128
    node_taps: Tuple[str, ...] = ("layer3",)
    # width/depth knobs (defaults = ResNet-18; shrink for tests)
    stem_channels: int = 64
    stage_channels: Tuple[int, int, int, int] = (64, 128, 256, 512)
    blocks_per_stage: int = 2
    remat: bool = False


@dataclass(frozen=True)
class NGMConfig:
    """Neural graph matching network."""

    node_feature_dim: int = 768        # 256 + 512
    global_state_dim: int = 1024       # 2 * 512
    gnn_layers: int = 3
    gnn_feat: Tuple[int, ...] = (16, 16, 16)
    spline_layers: int = 2
    sk_emb: int = 1                    # Sinkhorn embedding channels per layer
    sk_tau: float = 0.01
    sk_iter: int = 10                  # final Sinkhorn iterations
    sk_layer_iter: int = 20            # per-GNN-layer Sinkhorn iterations
    sk_epsilon: float = 1e-10
    k_factor: float = 50.0
    first_order: bool = True           # init assoc-node features from vec(Kp)
    positive_edges: bool = True
    regression: bool = True            # learn k via AFA-U
    mean_k: bool = True
    afa_head_num: int = 16
    afa_qkv_dim: int = 16
    afa_ff_hidden: int = 256
    afa_ms_hidden: int = 16
    afa_reg_hidden: int = 8
    # fixed extra soft-top-k iterations, gated per sample by the overshoot
    # predicate
    topk_extra_iter: int = 6
    match_cls_channels: Tuple[int, ...] = (16, 32)
    # k statistics ([k, matched fraction, mean matched score]) appended to
    # the match classifier's pooled vector
    cls_k_features: bool = False
    # third-order (triangle hyperedge) association term
    hyperedge: bool = False
    remat_sinkhorn: bool = True        # training-only knob
    # compute dtype of the graph-side hot path (spline conv, feature
    # alignment, edge features, affinity einsums, assoc-GNN gathers and
    # Dense layers): "bfloat16" halves the memory traffic of the
    # gather/scatter-heavy ops and runs the products on bf16 operands, with
    # f32 master params and f32 accumulation at every reduction (segment
    # sums, normalizations).
    # Sinkhorn / soft-top-k / AFA-U / losses always run f32 (log-space
    # numerics; measured not the cost). bf16 keeps f32's exponent range, so
    # no loss scaling is needed. Pair with backbone.dtype="bfloat16" for the
    # full mixed-precision forward+backward (CLI: --bf16).
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    rescale: Tuple[int, int] = (320, 240)     # (W, H) after standardize
    src_graph_construct: str = "tri"
    tgt_graph_construct: str = "same"
    sym_adjacency: bool = True
    norm_means: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    batch_size: int = 8
    num_workers: int = 6
    worker_processes: bool = False
    # channels shipped per image by collate: 1 = luma only, broadcast to RGB
    # on the device
    image_channels: int = 3
    random_seed: int = 123
    augment_min_points: int = 5
    augment_min_common: int = 4
    augment_max_attempts: int = 5


@dataclass(frozen=True)
class StageConfig:
    """One curriculum stage: what trains, its learning rates and schedule,
    and which loss terms it sums (evaluation reads the loss_* flags too)."""

    name: str = "stage1"
    num_epochs: int = 10
    start_epoch: int = 0
    lr: float = 1e-4
    backbone_lr: float = 1e-5
    k_lr: float = 1e-4
    cls_lr: float = 1e-4
    lr_decay: float = 0.5
    patience: int = 3
    warmup_epochs: int = 1
    train_main: bool = True
    train_k: bool = False
    train_cls: bool = True
    grad_clip: Optional[float] = None
    loss_perm: bool = True
    loss_ks: bool = True
    loss_cls: bool = True


@dataclass(frozen=True)
class TrainConfig:
    stages: Tuple[StageConfig, ...] = ()
    checkpoint_dir: str = "checkpoints"
    eval_every: int = 5
    seed: int = 123
    bn_follows_trainability: bool = True


@dataclass(frozen=True)
class MeshConfig:
    data_axis: int = 1
    edge_axis: int = 1


@dataclass(frozen=True)
class Config:
    shapes: ShapeConfig = field(default_factory=ShapeConfig)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    ngm: NGMConfig = field(default_factory=NGMConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_stages() -> Tuple[StageConfig, ...]:
    """The 6-stage curriculum:
      s1: freeze k head, train everything else (grad clip 1.0)
      s2: only k head
      s3: all params
      s4: only k head
      s5: all but match classifier
      s6: only match classifier
    """
    return (
        StageConfig(name="stage1", train_main=True, train_k=False, train_cls=True,
                    grad_clip=1.0, loss_ks=False),
        StageConfig(name="stage2", train_main=False, train_k=True, train_cls=False),
        StageConfig(name="stage3", train_main=True, train_k=True, train_cls=True),
        StageConfig(name="stage4", train_main=False, train_k=True, train_cls=False),
        StageConfig(name="stage5", train_main=True, train_k=True, train_cls=False),
        StageConfig(name="stage6", train_main=False, train_k=False, train_cls=True,
                    loss_perm=False, loss_ks=False),
    )


def alternative_stages() -> Tuple[StageConfig, ...]:
    """The reference's alternative 3-phase driver (train_new.py): CNN +
    graph matching first, AFA-U warm-up second, joint fine-tune third."""
    return (
        StageConfig(name="phase1_gm", train_main=True, train_k=False,
                    train_cls=True, loss_ks=False, grad_clip=5.0),
        StageConfig(name="phase2_afa", train_main=False, train_k=True,
                    train_cls=False),
        StageConfig(name="phase3_joint", train_main=True, train_k=True,
                    train_cls=True, lr=5e-5, k_lr=5e-5, cls_lr=5e-5),
    )
