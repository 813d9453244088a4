"""Pore-detector training in the port (`poredet.train`,
`scripts.train_poredet`) against the JAX package's on the CPU:

  * one Adam step of net13nomax at features 8 from converted Flax weights
    (random BatchNorm statistics) on the same patch batch: every parameter
    and batch statistic within 1e-5 of the JAX step's (train-mode
    BatchNorm with Flax's biased variance and momentum 0.9, the clipped
    centre BCE, optax's Adam);
  * Flax's default initialisers (`architectures.lecun_init_`), the
    state_dict <-> Flax-variables conversion both ways, gabriel's dropout;
  * `python -m fpmatch_tpu_torch.scripts.train_poredet --device cpu` at a
    tiny size: its `.npz` loads in the JAX package's `load_variables`, and
    the JAX detector with those variables finds the port's detections.

`make_patch_bank` is held equal to the JAX one in
`test_torch_poredet.py::test_patch_helpers_and_training_that_waits`.
"""
import csv

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fpmatch_tpu.poredet import architectures as ja
from fpmatch_tpu.poredet import inference as ji
from fpmatch_tpu.poredet import train as jt
from fpmatch_tpu_torch.convert import (pore_variables_to_state_dict,
                                       state_dict_to_pore_variables)
from fpmatch_tpu_torch.poredet import architectures as ta
from fpmatch_tpu_torch.poredet import inference as ti
from fpmatch_tpu_torch.poredet import train as tt
from fpmatch_tpu_torch.scripts import train_poredet
from test_torch_utils import flax_init, np_tree, randomize_batch_stats

STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _step_of(model, lr=1e-3):
    """One step of the JAX package's `train_pore_detector` (its `step`,
    dropout-free) for `model`, jitted: (variables, xb, yb) -> (params,
    batch_stats, loss)."""
    tx = optax.adam(lr)

    def step(variables, xb, yb):
        def loss_fn(p):
            out, mut = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, xb,
                train=True, mutable=["batch_stats"])
            lp = jnp.clip(out[:, 0, 0, 0], 1e-6, 1 - 1e-6)
            loss = -jnp.mean(yb * jnp.log(lp) + (1 - yb) * jnp.log(1 - lp))
            return loss, mut["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        updates, _ = tx.update(grads, tx.init(variables["params"]),
                               variables["params"])
        return optax.apply_updates(variables["params"], updates), stats, loss

    return jax.jit(step)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("arch", ["net13nomax"])
def test_one_adam_step_matches_jax(arch):
    """A window-sized patch gives a (1, 1) map: the centre output."""
    win = ta.receptive_field(arch)
    rng = np.random.default_rng(0)
    xb = rng.uniform(size=(32, win, win, 1)).astype(np.float32)
    yb = (rng.uniform(size=(32,)) < 0.5).astype(np.float32)
    jm = ja.make_architecture(arch, features=8)
    v = randomize_batch_stats(flax_init(jm, xb[:1], train=False))
    params, stats, loss = _step_of(jm)(v, jnp.asarray(xb), jnp.asarray(yb))

    tm = ta.make_architecture(arch, features=8)
    tm.load_state_dict(pore_variables_to_state_dict(v))
    opt = tt.make_optimizer(tm, 1e-3)
    got_loss = tt.train_step(tm, opt, torch.from_numpy(xb).permute(0, 3, 1, 2),
                             torch.from_numpy(yb))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    got = dict(_flat(state_dict_to_pore_variables(tm.state_dict())))
    want = dict(_flat(np_tree({"params": params, "batch_stats": stats})))
    assert set(got) == set(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEP_TOL)
        moved += not np.array_equal(want[k], dict(_flat(np_tree(v)))[k])
    assert moved == len(want)            # every tensor took the step


def test_flax_initialisers_and_conversion_round_trip():
    m = ta.lecun_init_(ta.make_architecture("net17nomax", features=16),
                      torch.Generator().manual_seed(3))
    w = m.LayerBlock_3.Conv_0.weight
    std = np.sqrt(1.0 / (16 * 9))
    assert float(w.detach().abs().max()) <= 2 * std / .87962566103423978 + 1e-7
    assert abs(float(w.detach().std()) - std) < 0.1 * std
    assert float(m.Conv_0.bias.detach().abs().max()) == 0.0
    bn = m.LayerBlock_0.BatchNorm_0
    assert torch.equal(bn.weight, torch.ones(16))
    assert torch.equal(bn.running_var, torch.ones(16))
    again = ta.lecun_init_(ta.make_architecture("net17nomax", features=16),
                          torch.Generator().manual_seed(3))
    assert torch.equal(again.LayerBlock_3.Conv_0.weight, w)
    # state_dict -> Flax variables -> state_dict, and the Flax tree's
    # shapes (from jax.eval_shape, values drawn from numpy)
    jm = ja.make_architecture("gabriel", features=4)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                              train=False),
                            np.zeros((1, 17, 17, 1), np.float32))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), shapes)
    tm = ta.make_architecture("gabriel", features=4)
    tm.load_state_dict(pore_variables_to_state_dict(v))
    back = state_dict_to_pore_variables(tm.state_dict())
    want = dict(_flat(v))
    got = dict(_flat(back))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(
            got[k], want[k]), k
    sd = pore_variables_to_state_dict(back)
    assert all(torch.equal(sd[k], t) for k, t in tm.state_dict().items())


def test_gabriel_dropout_in_train_mode_only():
    m = ta.make_architecture("gabriel", features=4)
    x = torch.rand(6, 1, 17, 17)
    with torch.no_grad():
        ev = [m(x) for _ in range(2)]
        m.train()
        m.dropout_generator = torch.Generator().manual_seed(0)
        a = m(x)
        m.dropout_generator = torch.Generator().manual_seed(0)
        b = m(x)
        c = m(x)
    assert torch.equal(ev[0], ev[1])
    assert torch.equal(a, b) and not torch.equal(b, c)


def test_script_trains_and_jax_reads_its_detector(tmp_path):
    """The CLI at a tiny size on the CPU: the .npz loads in the JAX
    package's `load_variables`; the JAX detector with those variables, and
    the port's `load_detector`, find the trained model's detections on a
    test image; metrics.csv holds the DPF, TEST and grid rows."""
    seen = []
    res = train_poredet.main(
        ["--arch", "net13nomax", "--out", str(tmp_path), "--train-n", "3",
         "--val-n", "1", "--test-n", "1", "--epochs", "2",
         "--device", "cpu"], log_fn=seen.append)
    npz = tmp_path / "net13nomax.npz"
    assert res["npz"] == str(npz) and npz.exists()
    tr = res["train"]
    assert tr["n_patches"] > 256 and len(tr["losses"]) == 2
    assert all(np.isfinite(tr["losses"])) and tr["epoch"] in (0, 1)
    assert any("TEST_II" in s for s in seen if isinstance(s, str))
    with open(tmp_path / "metrics.csv") as f:
        rows = {r["detector"]: r for r in csv.DictReader(f)}
    assert set(rows) == {"dpf_compact", "dpf_lemes", "net13nomax:TEST_I",
                         "net13nomax:TEST_II", "net13nomax:val_grid"}
    img = train_poredet.render_set(9800, 1)[0][0]
    grid = res["grid"]
    kw = dict(probability=grid["probability"], nms_iou=grid["nms_iou"],
              window=13)
    mine, _ = ti.detect_pores_in_image(res["model"], img, **kw)
    jv = jt.load_variables(str(npz))
    want, _ = ji.detect_pores_in_image(ja.make_architecture("net13nomax"),
                                       jv, img, **kw)
    back, _ = ti.detect_pores_in_image(
        tt.load_detector("net13nomax", npz, device="cpu"), img, **kw)
    assert len(mine) > 0
    assert np.array_equal(mine, want) and np.array_equal(back, mine)
