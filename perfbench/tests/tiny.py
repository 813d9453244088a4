"""A tiny cell for the CPU tests: the benchmark's cells with their
configuration cut to test widths (micro ResNet-18 8/16 wide with one block
a stage, 32-wide graph features, few Sinkhorn iterations, AFA-U 16 wide)
and small images, batches and buckets. Not a benchmark cell."""
from __future__ import annotations

import copy

from perfbench import harness

TINY_TRAFFIC = {"n_max": 12, "e_max": 64, "n_range": [6, 12],
                "image_hw": [32, 48], "pool": 3, "trace_batches": 2,
                "trace_steps": 2}


def tiny_config(config: dict) -> dict:
    cfg = copy.deepcopy(config)
    if cfg["backbone"]["kind"] == "resnet18":
        cfg["backbone"].update(stem_channels=8, stage_channels=[8, 8, 16, 16],
                               blocks_per_stage=1)
        cfg["ngm"]["node_feature_dim"] = 32
    cfg["ngm"].update(global_state_dim=32, gnn_feat=[8, 8, 8], sk_iter=4,
                      sk_layer_iter=4, topk_extra_iter=2, afa_reg_hidden=4)
    cfg["shapes"]["univ_size"] = 16
    cfg["data"]["rescale"] = [48, 32]
    return cfg


def tiny_cell(name: str, batch: int = 3, limits=None) -> harness.Cell:
    """The named benchmark cell at test size; `limits` replace its own."""
    cell = harness.load_cell(name)
    cell.config = tiny_config(cell.config)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    cell.spec = dict(cell.spec, batch=batch, reference_block=2,
                     reference_pairs=batch)
    if limits is not None:
        cell.spec["limits"] = limits
    return cell
