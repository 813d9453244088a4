"""A matcher trained by the JAX package, brought into the port
(`train.checkpoints.import_flax_npz` / `restore_params`) on the CPU: an
orbax checkpoint written by the JAX package's `save_checkpoint`, read back
as host numpy by its `restore_loose` and written as a flat `.npz` by its
`poredet.train.save_variables` (the two JAX lines the README gives), then
imported by the port without orbax. The port's forward with the imported
weights agrees with the JAX forward (jitted) at test_torch_ngm's
tolerances (perm_mat identical, 1e-4, AFA-U outputs 1e-3); the weights are
drawn from numpy into the tree of the Flax init (its shapes from
`jax.eval_shape`: the compiled init would take most of the file's time); `cli.match`'s model loader
finds the `.npz` by `--checkpoint-dir` through `checkpoint.json`'s
`latest`.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax

from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu.poredet.train import save_variables
from fpmatch_tpu.train.checkpoints import restore_loose, save_checkpoint
from fpmatch_tpu_torch.cli import match as t_match
from fpmatch_tpu_torch.models.ngm import build_model
from fpmatch_tpu_torch.train import checkpoints as tck
from test_torch_ngm import _compare, _mixed_batch, _torch_batch
from test_torch_utils import np_tree, tiny_jax_config, to_torch_config


def random_variables(model, batch, seed=0):
    """The tree of `model.init` (its shapes from `jax.eval_shape`, no
    compiled init) filled from numpy: kernels normal with std
    1/sqrt(fan_in), BatchNorm scales and variances U(0.5, 1.5), means and
    biases small normals."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(0), b, train=False), batch)

    def fill(path, s):
        leaf = path[-1].key
        if leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, s.shape)
        elif len(s.shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        else:
            a = rng.normal(0, 0.05, s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX side: tiny model, orbax checkpoint `stage6_best` (step 7),
    its `.npz`; and the JAX forward of a mixed batch."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = tiny_jax_config(sk_tau=0.05)
    batch = _mixed_batch(jcfg, seed=3)
    model = JNet(jcfg)
    v = random_variables(model, batch)
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"], step=7)
    save_checkpoint(str(d), "stage6_best", state, extra={"stage": 6})
    save_variables(str(d / "stage6_best.npz"),
                   restore_loose(str(d), "stage6_best"))
    want = jax.jit(lambda v, b: model.apply(v, b, train=False))(v, batch)
    return d, jcfg, batch, np_tree(want)


def test_import_flax_npz_forward_matches_jax(exported):
    d, jcfg, batch, want = exported
    tcfg = to_torch_config(jcfg)
    sd = tck.import_flax_npz(d / "stage6_best.npz", tcfg)
    net = build_model(tcfg, device="cpu", state_dict=sd)
    _compare(want, net(_torch_batch(batch).to("cpu")), 1e-4)
    # without a config: converted by name, every tensor but the counters,
    # which warm_start keeps from the model
    loose = tck.import_flax_npz(d / "stage6_best.npz")
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == \
        set(loose)
    assert all(torch.equal(loose[k], sd[k]) for k in loose)
    kept = tck.warm_start(net.state_dict(), loose)[1]
    assert kept == len(loose)
    wider = to_torch_config(tiny_jax_config(n_max=12))
    wider = dataclasses.replace(wider, ngm=dataclasses.replace(
        wider.ngm, node_feature_dim=48))
    with pytest.raises(ValueError, match="does not match NGMNet"):
        tck.import_flax_npz(d / "stage6_best.npz", wider)


def test_restore_params_and_cli_loader_take_the_npz(exported):
    d, jcfg, batch, want = exported
    tcfg = to_torch_config(jcfg)
    assert tck.read_meta(d)["latest"] == "stage6_best"
    sd = tck.restore_params(str(d), "stage6_best", tcfg)
    args = types.SimpleNamespace(checkpoint=None, checkpoint_dir=str(d),
                                 device="cpu", seed=0)
    model, name = t_match.load_model(tcfg, args)
    assert name == "stage6_best"
    got = model.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    _compare(want, model(_torch_batch(batch).to("cpu")), 1e-4)
    # the port's own .pt wins where both files are there
    tck.save_checkpoint(str(d), "stage6_best", {k: v + 1 for k, v in
                                                sd.items()
                                                if v.is_floating_point()})
    assert torch.equal(tck.restore_params(str(d), "stage6_best")[
        "backbone.conv1.weight"], sd["backbone.conv1.weight"] + 1)
