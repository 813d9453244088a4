"""The full neural-graph-matching network (inference and training).

  ResNet-18 features -> bilinear alignment at keypoints -> spline-conv message
  passing per fingerprint graph -> global-gated node/edge affinities ->
  factorized Kronecker association graph -> 3 assoc-GNN layers (mean-aggregated
  K^T matvec + embedded Sinkhorn channel) -> Sinkhorn -> AFA-U k-prediction ->
  soft top-k -> greedy discretization -> match classifier.

Everything is fixed-shape (N_MAX / E_MAX / T_MAX buckets) + per-sample
counts; K is never materialized. Two routes of the association GNN are
ported:

  * default (bucket scale): `AssocGNNLayer` aggregates through
    `ops.assoc.assoc_matvec_auto` (the CUDA kernels K2 / K3 on a CUDA device,
    the plain torch ops on the CPU), which is differentiable: the one route
    that trains;
  * `univ_plan` (UNIV-scale single-pair serving): the three aggregations go
    through `kernels.assoc_univ_v3.assoc_matvec_univ_v3` — the CUDA kernel on
    a CUDA device — and feed `AssocGNNLayerBatched`. Inference only, as in
    the JAX package, where no trainer reaches it;
  * `batch.row_plan` (a `parallel.edge_partition.BatchRowPlan`) with a rank
    grid (`grid`, `parallel.distributed.RankGrid`): the three aggregations
    run row-sharded over the grid's edge group
    (`parallel.edge_partition.row_sharded_aggregate`: one halo all_to_all
    per layer, each rank's rows on `assoc_matvec_auto`, the rows
    all-gathered) and feed `AssocGNNLayerBatched`; everything else runs
    alike on the ranks of an edge group. The UNIV route keeps precedence.

Under a rank grid the BatchNorms of the backbone and of the match classifier
take train-mode statistics over the grid's data group (the global batch),
whether or not the batch carries a row plan.

Every configuration of the JAX model is taken:

  * `backbone.kind`: "resnet18", "vgg16" / "vgg16_bn" (`models/vgg.py`), or
    "none", where `batch.features` (B, 2, N, F) replace the images
    (`NoBackbone`; F is given to the constructor as `feature_dim`);
  * `ngm.hyperedge`: triangle affinities `Kt` from the corner-angle cosines
    of `batch.tri` (`ops.spline.hyperedge_angle_attrs`, in f32), and each
    bucket-route GNN layer adds their mean-aggregated third-order term
    (`ops.assoc.assoc_tri_matvec`); with a UNIV plan it raises, as the JAX
    model does;
  * `ngm.cls_k_features`: the match classifier also reads [k, matched
    fraction, mean matched score], detached.

`forward(batch, train=...)` has the JAX model's meaning: `train` puts the
soft top-k on the ground-truth k and, unless `bn_main` / `bn_cls` say
otherwise, the backbone's and the match classifier's BatchNorm in train mode.
Without `train` the forward runs under `torch.inference_mode()`.

Mixed precision (`backbone.dtype` / `ngm.compute_dtype` = "bfloat16", the
CLIs' `--bf16`) is the JAX model's explicit casts, not an autocast: the
images are normalized in f32 and cast to bf16, the backbone's convolutions
run in bf16 and its BatchNorms in f32; the feature maps are normalized in
f32 and cast to the compute dtype, so the alignment, the spline
convolutions, the edge features, the affinities' operands and the assoc-GNN
(its K1 / K2 / K3 aggregations and Dense layers) run in bf16, with f32
affinities and f32 sums; the final classifier and everything after it (the
Sinkhorns, AFA-U, soft top-k, greedy, the match classifier, the losses) stay
f32. Parameters are f32 in both precisions, so one state_dict serves both.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core.config import Config
from ..kernels.assoc_univ_v3 import (UnivPlanDev, UnivPlanV3,
                                     assoc_matvec_univ_v3)
from ..ops.assoc import assoc_degree
from ..ops.feature_align import feature_align, normalize_over_channels
from ..ops.masking import length_mask
from ..ops.sinkhorn import sinkhorn_batch
from ..ops.soft_topk import greedy_perm_batch, soft_topk_batch
from ..ops.spline import edge_pseudo_coords, hyperedge_angle_attrs
from ..parallel.edge_partition import BatchRowPlan, row_sharded_aggregate
from ..utils.profiling import span
from .afau import AFAUEncoder
from .backbone import BatchNorm2d, ResNet18Backbone
from .vgg import NoBackbone, VGG16Backbone
from .layers import (AssocGNNLayer, AssocGNNLayerBatched,
                     InnerProductAffinity, MaskedBatchNorm, MatchClassifier,
                     SplineNet, remat)


class PairBatch(NamedTuple):
    """Batched padded matching problems. Leading axis B; view axis 2. Holds
    numpy arrays on the host side (`data/`) and tensors after `.to(device)`;
    field for field the JAX package's PairBatch."""

    images: object      # (B, 2, H, W, C) float32 or uint8, channels-last
    points: object      # (B, 2, N, 2)
    n_nodes: object     # (B, 2) int32
    src: object         # (B, 2, E) int32
    dst: object         # (B, 2, E) int32
    n_edges: object     # (B, 2) int32
    gt_perm: object     # (B, N, N) float32
    label: object       # (B,) float32 genuine=1/impostor=0
    gt_k: object        # (B,) float32
    # triangle hyperedges (cfg.ngm.hyperedge; None otherwise)
    tri: Optional[object] = None        # (B, 2, T, 3) int32
    n_tris: Optional[object] = None     # (B, 2) int32
    # precomputed per-keypoint features of the non-image pathway
    # (cfg.backbone.kind == "none"; the images are then ignored)
    features: Optional[object] = None   # (B, 2, N, F) float32
    # edge-sharded path: a parallel.edge_partition.BatchRowPlan
    row_plan: Optional[object] = None

    @property
    def batch_size(self):
        return self.images.shape[0]

    def to(self, device) -> "PairBatch":
        """Every array field as a tensor on `device`."""
        def conv(a):
            if isinstance(a, BatchRowPlan):
                return a.to(device)
            if a is None or not isinstance(a, (np.ndarray, torch.Tensor)):
                return a
            if isinstance(a, np.ndarray) and not a.flags.writeable:
                a = a.copy()
            return torch.as_tensor(a).to(device)
        return PairBatch(*(conv(a) for a in self))


class NGMNet(nn.Module):
    """End-to-end matcher. Call with a PairBatch of tensors.

    :param univ_plan: a `kernels.assoc_univ_v3` plan (host UnivPlanV3 or
        device UnivPlanDev) of the single pair to serve; it can also be given
        per call (`forward(batch, univ_plan=...)`), which is how a server
        that keeps one model answers pair after pair.
    :param univ_bf16: run the kernel's gather/multiply from bf16 association
        features (Ke, accumulation and result stay f32); implied by
        `ngm.compute_dtype == "bfloat16"`, as in the JAX model.
    :param feature_dim: width F of `batch.features`, needed (only) by
        `backbone.kind == "none"`, whose projection it sizes.
    :param grid: this rank's `parallel.distributed.RankGrid` (the JAX
        model's `mesh`, `edge_axis` and `batch_axis`): needed by a batch
        with a `row_plan`, and makes the train-mode BatchNorm statistics
        those of the grid's data group.
    """

    def __init__(self, cfg: Config, univ_plan=None, univ_bf16: bool = False,
                 feature_dim: Optional[int] = None, grid=None):
        super().__init__()
        ngm, bb = cfg.ngm, cfg.backbone
        if bb.kind not in ("resnet18", "vgg16", "vgg16_bn", "none"):
            raise ValueError(f"unknown backbone kind: {bb.kind!r}")
        if bb.kind == "none" and feature_dim is None:
            raise ValueError("backbone kind 'none' needs feature_dim, the "
                             "width of batch.features")
        self.cfg = cfg
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if {ngm.compute_dtype, bb.dtype} - set(dtypes):
            raise ValueError(f"compute_dtype / backbone.dtype must be one of "
                             f"{sorted(dtypes)}, got {ngm.compute_dtype!r} / "
                             f"{bb.dtype!r}")
        self.compute_dtype = dtypes[ngm.compute_dtype]
        self.backbone_dtype = dtypes[bb.dtype]
        self.univ_plan = univ_plan
        self.univ_bf16 = univ_bf16

        F = ngm.node_feature_dim
        if bb.kind == "none":
            self.backbone = NoBackbone(feature_dim, out_dim=F,
                                       global_dim=ngm.global_state_dim // 2)
            gdim = 2 * (ngm.global_state_dim // 2)
        elif bb.kind == "resnet18":
            self.backbone = ResNet18Backbone(
                node_taps=bb.node_taps, stem_channels=bb.stem_channels,
                stage_channels=bb.stage_channels,
                blocks_per_stage=bb.blocks_per_stage,
                dtype=self.backbone_dtype)
            gdim = 2 * bb.stage_channels[3]
        else:
            self.backbone = VGG16Backbone(batch_norm=bb.kind == "vgg16_bn",
                                          dtype=self.backbone_dtype)
            gdim = 2 * VGG16Backbone.OUT_CHANNELS
        self.spline = SplineNet(features=F, num_layers=ngm.spline_layers)
        self.vertex_aff = InnerProductAffinity(F, gdim)
        self.edge_aff = InnerProductAffinity(F, gdim)
        if ngm.hyperedge:
            self.tri_aff = InnerProductAffinity(3, gdim)
        c_in = 1
        for i in range(ngm.gnn_layers):
            # AssocGNNLayer also serves the univ route through its base
            # class's forward: one set of parameters for both routes
            self.add_module(f"gnn_{i}", AssocGNNLayer(
                c_in, out_features=ngm.gnn_feat[i], sk_channel=ngm.sk_emb,
                sk_iter=ngm.sk_layer_iter, sk_tau=ngm.sk_tau,
                dtype=self.compute_dtype, hyperedge=ngm.hyperedge))
            c_in = ngm.gnn_feat[i] + ngm.sk_emb
        self.classifier = nn.Linear(c_in, 1)
        if ngm.regression:
            self.afau = AFAUEncoder(univ_size=cfg.shapes.univ_size,
                                    reg_hidden=ngm.afa_reg_hidden)
        self.match_cls = MatchClassifier(
            channels=ngm.match_cls_channels,
            extra_features=3 if ngm.cls_k_features else 0)
        # the rank grid: its data group gives the train-mode BatchNorms the
        # global batch's statistics
        self.grid = grid
        for m in self.modules():
            if isinstance(m, (BatchNorm2d, MaskedBatchNorm)):
                m.group = None if grid is None else grid.data_group
        self.register_buffer("norm_means", torch.tensor(
            cfg.data.norm_means, dtype=torch.float32), persistent=False)
        self.register_buffer("norm_std", torch.tensor(
            cfg.data.norm_std, dtype=torch.float32), persistent=False)
        self.eval()

    def forward(self, batch: PairBatch, train: bool = False,
                hungarian_mask: Optional[torch.Tensor] = None,
                univ_plan=None, bn_main: Optional[bool] = None,
                bn_cls: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """:param train: training forward: the soft top-k targets
            `batch.gt_k`, and autograd records the graph of whatever requires
            a gradient (the module's own `training` flag is not read)
        :param bn_main / bn_cls: BatchNorm mode of the backbone / match
            classifier, set independently of `train` (default: `train`);
            the curriculum's frozen partitions keep theirs on the running
            statistics
        :param hungarian_mask: optional 0/1 (B, N, N) that ranks the greedy
            fill (`hungarian_mask * ds_mat`)
        :param univ_plan: the UNIV route's plan (inference only)"""
        train = bool(train)
        bn_main = train if bn_main is None else bool(bn_main)
        bn_cls = train if bn_cls is None else bool(bn_cls)
        plan = univ_plan if univ_plan is not None else self.univ_plan
        if train and plan is not None:
            raise ValueError("the UNIV route (univ_plan) is inference only")
        if train or bn_main or bn_cls:
            return self._forward(batch, train, hungarian_mask, plan, bn_main,
                                 bn_cls)
        with torch.inference_mode():
            return self._forward(batch, False, hungarian_mask, plan, False,
                                 False)

    def _forward(self, batch: PairBatch, train: bool, hungarian_mask, plan,
                 bn_main: bool, bn_cls: bool) -> Dict[str, torch.Tensor]:
        # every device launch lies in one stage span (`utils.profiling`):
        # ngm.input, ngm.backbone, ngm.align, ngm.spline, ngm.affinity,
        # ngm.gnn_{i}, ngm.assignment (around ngm.afau), ngm.match_cls,
        # ngm.losses
        cfg = self.cfg.ngm
        cdt = self.compute_dtype
        B, two, H, W, C_in = batch.images.shape
        N = batch.points.shape[2]
        E = batch.src.shape[2]
        dev = batch.points.device
        rescale_max = float(max(self.cfg.data.rescale))
        none = self.cfg.backbone.kind == "none"

        # ---- masks, points, images ---------------------------------------
        with span("ngm.input"):
            node_mask = length_mask(batch.n_nodes.reshape(B * 2), N)
            edge_mask = length_mask(batch.n_edges.reshape(B * 2), E)
            pts = batch.points.reshape(B * 2, N, 2)
            if none:
                # non-image pathway: precomputed keypoint features
                feats = batch.features.reshape(B * 2, N, -1)
                present = node_mask.to(feats.dtype)
            else:
                imgs = batch.images.reshape(B * 2, H, W, C_in)
                if imgs.dtype == torch.uint8:
                    # raw uint8, possibly single-channel luma: normalize
                    # here; a (..., 1) input broadcasts against the
                    # per-channel stats
                    imgs = (imgs.float() / 255.0 - self.norm_means) \
                        / self.norm_std
                elif C_in == 1:
                    imgs = imgs.expand(-1, -1, -1, 3)
                imgs = imgs.float().to(self.backbone_dtype)

        # ---- backbone over all images at once ----------------------------
        with span("ngm.backbone"):
            if none:
                node_feat, global_feat = self.backbone(feats, present)
            else:
                node_maps, edges_map, global_feat = self.backbone(imgs,
                                                                  bn_main)

        # ---- bilinear alignment at keypoints -----------------------------
        with span("ngm.align"):
            if not none:
                # channel-normalize in f32, then drop to the compute dtype
                # for the alignment and everything graph-side
                node_maps = [normalize_over_channels(m.float()).to(cdt)
                             for m in node_maps]
                edges_map = normalize_over_channels(edges_map.float()).to(cdt)
                global_feat = global_feat.float()
                rescale = self.cfg.data.rescale
                aligned = [feature_align(m, pts, rescale) for m in node_maps]
                aligned.append(feature_align(edges_map, pts, rescale))
                node_feat = torch.cat(aligned, dim=-1)
            node_feat = node_feat.to(cdt) * node_mask[..., None]
            src = batch.src.reshape(B * 2, E)
            dst = batch.dst.reshape(B * 2, E)
            pseudo = edge_pseudo_coords(pts, src, dst, rescale_max)

        # ---- spline-conv message passing per graph -----------------------
        with span("ngm.spline"):
            x = self.spline(node_feat, src, dst, pseudo, edge_mask, node_mask)

        with span("ngm.affinity"):
            # ---- edge features + global weights --------------------------
            Fd = x.shape[-1]
            take = lambda idx: torch.gather(
                x, 1, idx.long()[..., None].expand(-1, -1, Fd))
            edge_feat = (take(src) - take(dst)) * edge_mask[..., None]

            g = global_feat.reshape(B, 2, -1)
            global_w = normalize_over_channels(
                torch.cat([g[:, 0], g[:, 1]], dim=-1))

            x = x.reshape(B, 2, N, -1)
            edge_feat = edge_feat.reshape(B, 2, E, -1)
            node_mask = node_mask.reshape(B, 2, N)
            edge_mask = edge_mask.reshape(B, 2, E)
            n1, n2 = batch.n_nodes[:, 0], batch.n_nodes[:, 1]

            vmask = node_mask[:, 0, :, None] & node_mask[:, 1, None, :]
            emask = edge_mask[:, 0, :, None] & edge_mask[:, 1, None, :]

            # ---- affinities -----------------------------------------------
            Kp = self.vertex_aff(x[:, 0], x[:, 1], global_w, mask=vmask)
            Ke = 0.5 * self.edge_aff(edge_feat[:, 0], edge_feat[:, 1],
                                     global_w, mask=emask)

            # ---- third-order (triangle) affinities -----------------------
            tri_extra = ()
            if cfg.hyperedge:
                T = batch.tri.shape[2]
                tri_mask = length_mask(batch.n_tris.reshape(B * 2), T)
                # angle cosines in f32 whatever the compute dtype
                tri_attr = hyperedge_angle_attrs(
                    x.reshape(B * 2, N, -1).float(),
                    batch.tri.reshape(B * 2, T, 3),
                    tri_mask.float()).reshape(B, 2, T, 3)
                tri_mask = tri_mask.reshape(B, 2, T)
                tmask = tri_mask[:, 0, :, None] & tri_mask[:, 1, None, :]
                Kt = 0.5 * self.tri_aff(tri_attr[:, 0], tri_attr[:, 1],
                                        global_w, mask=tmask.to(x.dtype))
                tri_extra = (Kt, batch.tri[:, 0], batch.tri[:, 1],
                             tri_mask[:, 0], tri_mask[:, 1])

            emb = Kp[..., None] if cfg.first_order else torch.ones(
                (B, N, N, 1), dtype=Kp.dtype, device=dev)
            kp_present = vmask.to(Kp.dtype)

            # (B, N, N, 1) rownnz(K^T), at least 1: the routes that
            # aggregate outside `AssocGNNLayer` divide by it
            if plan is not None or batch.row_plan is not None:
                deg = torch.clamp(assoc_degree(
                    kp_present, edge_mask[:, 0], edge_mask[:, 1],
                    batch.src[:, 0], batch.dst[:, 0], batch.src[:, 1],
                    batch.dst[:, 1], N, N, transpose=True), min=1.0)[..., None]
            if plan is not None and (isinstance(plan, UnivPlanV3) or (
                    isinstance(plan, UnivPlanDev)
                    and plan.in1_slot.device != dev)):
                plan = plan.to(dev)

        # ---- association-graph GNN ---------------------------------------
        if plan is not None:
            # ---- UNIV-scale single-pair serving route ---------------------
            if B != 1:
                raise ValueError("univ_plan is a single-pair path (B == 1)")
            if cfg.hyperedge:
                raise NotImplementedError("hyperedge + univ kernel")
            kernel_bf16 = self.univ_bf16 or cdt == torch.bfloat16
            for i in range(cfg.gnn_layers):
                with span(f"ngm.gnn_{i}"):
                    xin = emb[0].bfloat16() if kernel_bf16 else emb[0]
                    y = assoc_matvec_univ_v3(xin, Kp[0], Ke[0], plan)
                    layer = getattr(self, f"gnn_{i}")
                    emb = AssocGNNLayerBatched.forward(
                        layer, emb, y[None] / deg, kp_present, n1, n2)
        elif batch.row_plan is not None:
            # ---- edge-sharded route over the grid's edge group ------------
            if self.grid is None:
                raise ValueError("batch.row_plan set but NGMNet has no rank "
                                 "grid")
            if cfg.hyperedge:
                raise NotImplementedError(
                    "hyperedge + edge sharding not combined")
            for i in range(cfg.gnn_layers):
                with span(f"ngm.gnn_{i}"):
                    xin = emb.to(cdt)
                    agg = row_sharded_aggregate(
                        xin, Kp, Ke, batch.row_plan, batch.src[:, 1],
                        batch.dst[:, 1], self.grid, e1_mask=edge_mask[:, 0],
                        e2_mask=edge_mask[:, 1]) / deg
                    emb = AssocGNNLayerBatched.forward(
                        getattr(self, f"gnn_{i}"), xin, agg, kp_present, n1,
                        n2)
        else:
            for i in range(cfg.gnn_layers):
                with span(f"ngm.gnn_{i}"):
                    emb = getattr(self, f"gnn_{i}")(
                        emb, Kp, Ke, batch.src[:, 0], batch.dst[:, 0],
                        batch.src[:, 1], batch.dst[:, 1], kp_present,
                        edge_mask[:, 0], edge_mask[:, 1], n1, n2, *tri_extra)

        # the two Sinkhorn chains are recomputed in the backward when
        # cfg.remat_sinkhorn (memory, not numbers), as the JAX model's
        # jax.checkpoint
        rm = remat if cfg.remat_sinkhorn else (lambda fn, *a: fn(*a))
        with span("ngm.assignment"):
            # ---- scores + Sinkhorn ---------------------------------------
            # f32 (Flax promotes a bf16 input against its f32 parameters)
            s = self.classifier(emb.float())[..., 0]            # (B, N, N)
            ss = rm(lambda x: sinkhorn_batch(x, n1, n2, tau=cfg.sk_tau,
                                             max_iter=cfg.sk_iter,
                                             dummy_row=True), s)
            min_pts = torch.minimum(n1, n2).float()
            supervised_ks = batch.gt_k / torch.clamp(min_pts, min=1.0)

        # ---- k prediction (AFA-U), on the detached Sinkhorn map ----------
        if cfg.regression:
            with span("ngm.afau"):
                ks = self.afau(ss.detach(), n1, n2)
        else:
            ks = supervised_ks

        with span("ngm.assignment"):
            # ---- soft top-k + discretization -----------------------------
            topk_target = batch.gt_k if train else ks * min_pts
            ss_out = rm(lambda x: soft_topk_batch(
                x, topk_target, n1, n2, tau=cfg.sk_tau, max_iter=cfg.sk_iter,
                extra_iter=cfg.topk_extra_iter), ss)
            rank = ss_out if hungarian_mask is None \
                else hungarian_mask * ss_out
            x_perm = greedy_perm_batch(rank.detach(), ks.detach() * min_pts,
                                       n1, n2).detach()

        # ---- match classification ----------------------------------------
        with span("ngm.match_cls"):
            matched_sim = s * x_perm
            extra = None
            if cfg.cls_k_features:
                # k statistics beside the map; detached: the classifier's
                # stage trains alone
                n_matched = x_perm.sum(dim=(1, 2))
                sum_sim = matched_sim.sum(dim=(1, 2))
                extra = torch.stack(
                    [ks, n_matched / torch.clamp(min_pts, min=1.0),
                     sum_sim / torch.clamp(n_matched, min=1.0)],
                    dim=-1).detach()
            cls_logits = self.match_cls(matched_sim, n1, n2, train=bn_cls,
                                        extra_features=extra)
            cls_prob = torch.sigmoid(cls_logits)

        # ---- auxiliary losses --------------------------------------------
        with span("ngm.losses"):
            label = batch.label
            cls_loss = torch.mean(
                torch.clamp(cls_logits, min=0) - cls_logits * label
                + torch.log1p(torch.exp(-torch.abs(cls_logits))))
            if cfg.regression:
                ks_loss = torch.mean((ks - supervised_ks) ** 2) * cfg.k_factor
                ks_error = torch.mean(torch.abs(ks * min_pts - batch.gt_k))
            else:
                ks_loss = torch.zeros((), device=dev)
                ks_error = torch.zeros((), device=dev)

        return {
            "ds_mat": ss_out,
            "raw_scores": s,
            "sinkhorn": ss,
            "perm_mat": x_perm,
            "Kp": Kp,
            "ks_loss": ks_loss,
            "ks_error": ks_error,
            "cls_loss": cls_loss,
            "cls_logits": cls_logits,
            "cls_prob": cls_prob,
            "k_prob": ks,
        }


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Re-initialise every parameter from a seeded torch.Generator, with the
    distributions the JAX package's modules use at init: fan-in-scaled normal
    for Linear/Conv weights, fan-in-scaled uniform for the spline kernels,
    U(-10, 10) for the AFA-U score-mixing MLPs, zero biases, unit norm
    scales, fresh BatchNorm statistics."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def fill(p, sample):
        with torch.no_grad():
            p.copy_(sample(torch.empty(p.shape, dtype=torch.float32)))

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("mix"):
            fill(p, lambda t: t.uniform_(-10.0, 10.0, generator=gen))
        elif leaf.endswith("_scale") or (leaf == "weight" and p.dim() == 1):
            nn.init.ones_(p)
        elif leaf == "bias" or leaf.endswith("_bias"):
            nn.init.zeros_(p)
        elif leaf.startswith("conv") and leaf.endswith(("_weight", "_root")):
            fan_in = p.shape[-2] * (p.shape[0] if p.dim() == 3 else 1)
            lim = (1.0 / fan_in) ** 0.5
            fill(p, lambda t: t.uniform_(-lim, lim, generator=gen))
        else:                                   # Linear / Conv2d weight
            fan_in = p[0].numel()
            std = (1.0 / fan_in) ** 0.5
            fill(p, lambda t: t.normal_(0.0, std, generator=gen))
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
    return model


def build_model(cfg: Config, device="cuda", seed: int = 0, state_dict=None,
                univ_plan=None, univ_bf16: bool = False,
                feature_dim: Optional[int] = None, grid=None) -> NGMNet:
    """An NGMNet on `device` (default `cuda`; raises when that is asked for
    and there is no GPU), with weights from `state_dict` or, without one,
    initialised from `seed`. `feature_dim` (backbone kind "none") is read
    from `state_dict` when it is not given; `grid` is NGMNet's."""
    from .. import resolve_device

    dev = resolve_device(device)
    if feature_dim is None and state_dict is not None \
            and "backbone.proj.weight" in state_dict:
        feature_dim = state_dict["backbone.proj.weight"].shape[1]
    model = NGMNet(cfg, univ_plan=univ_plan, univ_bf16=univ_bf16,
                   feature_dim=feature_dim, grid=grid)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_weights(model, seed)
    return model.to(dev)
