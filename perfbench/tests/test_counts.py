"""The FLOP and byte counts against hand-worked small cases."""
import pytest

from perfbench.counts import kernels, model


def tiny_resnet():
    return {"backbone": {"kind": "resnet18", "stem_channels": 2,
                         "stage_channels": [2, 2, 2, 2],
                         "blocks_per_stage": 1}}


def test_resnet_backbone_flops_by_hand():
    # 8 x 8 image: stem 7x7/2 -> 4x4 (3 -> 2 channels): 16*3*2*49*2;
    # pool -> 2x2; layer1 2x2 two 3x3 convs 2->2: 2 * 4*2*2*9*2; layers
    # 2-4 stride 2 -> 1x1: conv 3x3 2->2 (1 cell) + 3x3 + 1x1 downsample
    stem = 16 * 3 * 2 * 49 * 2
    l1 = 2 * (4 * 2 * 2 * 9 * 2)
    deeper = 3 * (2 * 2 * 9 * 2 + 2 * 2 * 9 * 2 + 2 * 2 * 1 * 2)
    assert model.backbone_flops(tiny_resnet(), (8, 8)) == stem + l1 + deeper


def test_vgg_backbone_flops_at_240x320():
    cfg = {"backbone": {"kind": "vgg16_bn"}}
    macs = (76800 * 9 * (3 * 64 + 64 * 64) + 19200 * 9 * (64 * 128 + 128 * 128)
            + 4800 * 9 * (128 * 256 + 2 * 256 * 256)
            + 1200 * 9 * (256 * 512 + 2 * 512 * 512) + 300 * 9 * 3 * 512 * 512)
    assert model.backbone_flops(cfg, (240, 320)) == 2 * macs


def tiny_graph(hyperedge=None):
    cfg = {"backbone": {"kind": "resnet18", "stage_channels": [1, 1, 1, 1]},
           "shapes": {"univ_size": 1},
           "ngm": {"node_feature_dim": 1, "spline_layers": 1,
                   "gnn_feat": [1], "sk_emb": 1, "afa_head_num": 1,
                   "afa_qkv_dim": 1, "afa_ff_hidden": 1, "afa_ms_hidden": 1,
                   "afa_reg_hidden": 1, "match_cls_channels": [1, 1]}}
    if hyperedge is not None:
        cfg["ngm"]["hyperedge"] = hyperedge
    return cfg


def test_graph_flops_by_hand():
    cfg = tiny_graph()
    n1 = n2 = 2
    e1 = e2 = 2
    spline = 2 * 2.0 * (4 * 2 + 2)          # per graph 2 F F (4 e + n)
    gates = 2 * 2.0 * 2 * 1                 # gdim 2 (2 x the last stage)
    aff = 2.0 * (4 + 4)
    gnn = 2.0 * 1 * (4 + 4) + 2.0 * 4 * (3 + 1 + 1)
    final = 2.0 * 4 * 2
    afa = 2 * (2.0 * (2 + 4) + 2 * 2.0 * 4 + 2.0 * 4 * 3 + 2.0 * 2
               + 2 * 2.0 * 2) + 2 * 2.0
    cls = 2.0 * 9 * 4 + 2.0 * 9 * 1
    assert model.graph_flops(cfg, n1, n2, e1, e2) == pytest.approx(
        spline + gates + aff + gnn + final + afa + cls)


def test_batch_flops_with_and_without_triangles_by_hand():
    cfg = tiny_graph()
    cfg["backbone"].update(stem_channels=1, blocks_per_stage=1)
    # 8 x 8 image, one channel a stage: stem 16*3*1*49*2, layer1 two 3x3
    # convs on 2x2, layers 2-4 on 1x1 two 3x3 convs and a 1x1 downsample
    bb = 16 * 3 * 49 * 2 + 2 * (4 * 9 * 2) + 3 * (9 * 2 + 9 * 2 + 2)
    assert model.backbone_flops(cfg, (8, 8)) == bb
    pair = 358.0                # test_graph_flops_by_hand's sum
    n_nodes, n_edges, n_tris = [[2, 2], [2, 2]], [[2, 2], [2, 2]], \
        [[3, 2], [1, 0]]
    for hyperedge in (None, False):
        cfg = dict(cfg, ngm=dict(tiny_graph(hyperedge)["ngm"]))
        assert model.batch_flops(cfg, (8, 8), n_nodes, n_edges) == \
            pytest.approx(2 * (2 * bb + pair))
        assert model.batch_flops(cfg, (8, 8), n_nodes, n_edges, n_tris) \
            == model.batch_flops(cfg, (8, 8), n_nodes, n_edges)

    def tri_terms(t1, t2):
        # F = 1, gdim 2, one layer of C = 1 input and 1 output channel over
        # 4 cells: cosines 12 F (t1 + t2); gate 2 gdim 3 and product
        # 2 3 t1 t2; contraction 9 C t1 t2; lin_t 2 cells C out
        return (12.0 * (t1 + t2) + 2.0 * 2 * 3 + 2.0 * 3 * t1 * t2
                + 9.0 * t1 * t2 + 2.0 * 4)
    cfg["ngm"]["hyperedge"] = True
    assert model.batch_flops(cfg, (8, 8), n_nodes, n_edges, n_tris) == \
        pytest.approx(2 * (2 * bb + pair) + tri_terms(3, 2)
                      + tri_terms(1, 0))
    # two layers, C 1 then 3 + sk_emb; 2 x 3 cells, t1 t2 = 20
    cfg["ngm"]["gnn_feat"] = [3, 5]
    base = model.graph_flops(dict(cfg, ngm=dict(cfg["ngm"], hyperedge=False)),
                             2, 3, 2, 2, 4, 5)
    assert model.graph_flops(cfg, 2, 3, 2, 2, 4, 5) == pytest.approx(
        base + 12.0 * 9 + 2.0 * 2 * 3 + 2.0 * 3 * 20
        + 9.0 * 1 * 20 + 2.0 * 6 * 1 * 3
        + 9.0 * 4 * 20 + 2.0 * 6 * 4 * 5)


def test_kernel_bytes_and_bound_by_hand():
    n_nodes = [[2, 3]]
    n_edges = [[4, 5]]
    # Ke 20, X and Y 6 cells x 2 channels each, Kp 6; edge endpoints 2 x 9
    assert kernels.k2_work(n_nodes, n_edges, 2) == (
        4 * (20 + 2 * 6 * 2 + 6) + 4 * 2 * 9, 2.0 * 2 * (20 + 6))
    # K3: K2's valid work, whatever implements it
    assert kernels.k3_work(n_nodes, n_edges, 2) == (
        4 * (20 + 2 * 6 * 2 + 6) + 4 * 2 * 9, 2.0 * 2 * (20 + 6))
    assert kernels.k3_work([[2, 3], [1, 1]], [[4, 5], [0, 0]], 3) == (
        4 * (20 + 2 * 7 * 3 + 7) + 4 * 2 * 9, 2.0 * 3 * (20 + 7))
    # K6: dY and X read, dKe and dKp written, endpoints, one mask byte
    assert kernels.k6_work(n_nodes, n_edges, 2) == (
        4 * (2 * 6 * 2 + 20 + 6) + 4 * 2 * 9 + 9, 2.0 * 2 * (20 + 6))
    b, f = 3.35e12, 67e12
    assert kernels.bound_s(b, 1.0) == pytest.approx(1.0)
    assert kernels.bound_s(1.0, f) == pytest.approx(1.0)
    assert kernels.layer_channels({"ngm": {"gnn_feat": [16, 16, 16],
                                           "sk_emb": 1}}) == [1, 17, 17]
