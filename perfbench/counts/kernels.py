"""Bytes and operations of the hand-written association kernels, counted
over the valid work of a batch (its real node and edge counts), and the
least time they bound.

A kernel reads each input byte once and writes each output byte once
(float32, int32 indices); padded cells and edge slots are not counted.
Operations: 2 C (e1 e2 + n1 n2) per pair, a multiply-add per association
edge and channel and per diagonal cell. The bound is the larger of bytes /
HBM bandwidth and operations / the float32 peak outside the tensor cores
(`perfbench/peaks.json`).

  * K2 (`assoc_bucket_kernel`, the forward K^T vec(X) at bucket scale):
    Ke (e1 e2), X and Y (n1 n2 C each), Kp (n1 n2), and for each graph its
    edges' two endpoints;
  * K6 (`assoc_grad_kernel`, dKe and dKp of the same product): dY and X
    read (n1 n2 C each), dKe (e1 e2) and dKp (n1 n2) written, each graph's
    edge endpoints read and its edge mask (1 byte an edge slot) read, the
    terms of `chip_smoke.py`'s formula on valid counts.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json")
                   .read_text())


def _sums(n_nodes, n_edges):
    cells = sum(int(a[0]) * int(a[1]) for a in n_nodes)
    assoc = sum(int(b[0]) * int(b[1]) for b in n_edges)
    edges = sum(int(b[0]) + int(b[1]) for b in n_edges)
    return cells, assoc, edges


def k2_work(n_nodes, n_edges, C: int):
    """(bytes, operations) of one K2 launch over a batch at C channels."""
    cells, assoc, edges = _sums(n_nodes, n_edges)
    nbytes = 4 * (assoc + 2 * cells * C + cells) + 4 * 2 * edges
    return nbytes, 2.0 * C * (assoc + cells)


def k6_work(n_nodes, n_edges, C: int):
    """(bytes, operations) of one K6 launch over a batch at C channels."""
    cells, assoc, edges = _sums(n_nodes, n_edges)
    nbytes = 4 * (2 * cells * C + assoc + cells) + 4 * 2 * edges + edges
    return nbytes, 2.0 * C * (assoc + cells)


def bound_s(nbytes: float, ops: float) -> float:
    """The least time for `nbytes` moved and `ops` done on one card."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["f32_flops_per_s"])


def layer_channels(cfg: dict):
    """The channel count C of each association-GNN layer's input."""
    ngm = cfg["ngm"]
    return [1] + [f + ngm["sk_emb"] for f in ngm["gnn_feat"][:-1]]
