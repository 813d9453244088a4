"""The plain reference against the program on the CPU at test widths: the
same weights and batch give the same maps, scores and gradients."""
import pytest
import torch

from perfbench import harness
from perfbench.reference import model as ref
from perfbench.tests.tiny import tiny_cell
from perfbench.traffic.generator import make_pool


def setup(name, batch=3, image_hw=(32, 48)):
    from fpmatch_tpu_torch.models.ngm import PairBatch, build_model

    cell = tiny_cell(name, batch=batch)
    cell.traffic["image_hw"] = list(image_hw)
    cfg = harness.port_config(cell.config, cell.traffic)
    weights = harness.make_weights(harness.model_shapes(cfg), 11, "cpu")
    model = build_model(cfg, device="cpu", state_dict=weights)
    pool = make_pool(cell.traffic, batch, 5, "cpu")
    return cell, model, weights, pool[0], PairBatch(**pool[0])


@pytest.mark.parametrize("name", ["resnet18.eval-n64", "vgg16bn.eval-n64"])
def test_forward_matches_the_program(name):
    cell, model, weights, batch, pb = setup(
        name, batch=2 if "vgg" in name else 3)
    out = model(pb)
    with torch.no_grad():
        r = ref.forward(weights, cell.config, batch,
                        given_perm=out["perm_mat"])
    # Sinkhorn at tau 0.01 scales the scores' rounding by 100 in log space
    for key, atol in (("raw_scores", 1e-5), ("sinkhorn", 1e-3),
                      ("k_prob", 1e-4), ("cls_prob", 1e-5)):
        torch.testing.assert_close(r[key], out[key], rtol=0, atol=atol,
                                   msg=key)
    with torch.no_grad():
        at_k = ref.forward(weights, cell.config, batch,
                           given_k=out["k_prob"])
    torch.testing.assert_close(at_k["ds_mat"], out["ds_mat"], rtol=0,
                               atol=1e-3)


def test_gradients_match_the_program():
    from fpmatch_tpu_torch.train.losses import permutation_loss

    cell, model, weights, batch, pb = setup("resnet18.eval-n64")
    out = model(pb, train=True)
    n1, n2 = batch["n_nodes"][:, 0], batch["n_nodes"][:, 1]
    loss = (permutation_loss(out["ds_mat"], pb.gt_perm, n1, n2)
            + out["ks_loss"] + out["cls_loss"])
    loss.backward()
    params = {n: weights[n].clone().requires_grad_(True)
              for n, _ in model.named_parameters()}
    r = ref.forward({**weights, **params}, cell.config, batch, train=True)
    total = (ref.permutation_loss(r["ds_mat"], batch["gt_perm"], n1, n2)
             + r["ks_loss"] + r["cls_loss"])
    torch.testing.assert_close(total, loss, rtol=1e-4, atol=0)
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    norms = sorted(float(p.grad.norm()) for _, p in model.named_parameters())
    scale = norms[len(norms) // 2]
    # through Sinkhorn at tau 0.01 the rounding of two summation orders
    # reaches 1e-3 of a leaf's gradient
    for (name, p), g in zip(model.named_parameters(), grads):
        g = torch.zeros_like(p) if g is None else g
        assert float((g - p.grad).norm()) <= 1e-2 * max(
            float(p.grad.norm()), scale), name


def test_greedy_and_sinkhorn_by_hand():
    m = torch.tensor([[[0.9, 0.8, 0.1], [0.85, 0.2, 0.0], [0.0, 0.0, 0.0]]])
    n = torch.tensor([2])
    picks = ref.greedy(m, torch.tensor([2.0]), n, n)
    assert picks[0, 0, 0] == 1 and picks[0, 1, 1] == 1 and picks.sum() == 2
    s = ref.sinkhorn(torch.randn(1, 4, 4), torch.tensor([3]),
                     torch.tensor([3]), 1.0, 20)
    torch.testing.assert_close(s[0, :3, :3].sum(0), torch.ones(3))
    assert float(s[0, 3].abs().sum() + s[0, :, 3].abs().sum()) == 0.0
