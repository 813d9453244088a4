"""The JAX package's last public functions without a counterpart until the
coverage map was drawn, held against it on the CPU on the same numpy inputs:
SimGNN's AFA-I modules, the alternative curriculum, `make_grids`, the
torchvision ResNet-18 loader, `param_labels` and `native.available`."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.core import build_graphs as j_bg
from fpmatch_tpu.core import config as j_config
from fpmatch_tpu.models import afau as j_afau
from fpmatch_tpu.models import backbone as j_bb
from fpmatch_tpu.train import state as j_state
from fpmatch_tpu_torch import native
from fpmatch_tpu_torch.convert import flax_tree_to_state_dict
from fpmatch_tpu_torch.core import build_graphs as t_bg
from fpmatch_tpu_torch.core import config as t_config
from fpmatch_tpu_torch.models import afau as t_afau
from fpmatch_tpu_torch.models import backbone as t_bb
from fpmatch_tpu_torch.models.ngm import NGMNet
from fpmatch_tpu_torch.train import state as t_state
from test_torch_utils import np_tree, t2n, tiny_jax_config, to_torch_config

FILTERS = 12
AFAI_TOL = dict(rtol=1e-6, atol=1e-6)


def afai_pair(j_cls, t_cls, *args, **kw):
    """A Flax module initialised under jit and the port's module with its
    parameters (carried across by `convert.flax_tree_to_state_dict`)."""
    jm = j_cls(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"]
    tm = t_cls(**kw)
    tm.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    return jm, params, tm


def test_tensor_network_module_matches_flax(rng):
    e1, e2 = (rng.normal(size=(5, FILTERS)).astype(np.float32)
              for _ in range(2))
    jm, params, tm = afai_pair(j_afau.TensorNetworkModule,
                               t_afau.TensorNetworkModule, e1, e2,
                               filters=FILTERS, tensor_neurons=6)
    assert dict(tm.named_parameters()).keys() == {
        "weight_matrix", "weight_matrix_block", "bias"}
    want = np.asarray(jm.apply({"params": params}, e1, e2))
    got = t2n(tm(torch.from_numpy(e1), torch.from_numpy(e2)))
    np.testing.assert_allclose(got, want, **AFAI_TOL)
    assert (want > 0).any() and (want == 0).any()   # relu on both sides


@pytest.mark.parametrize("masked", [False, True])
def test_dense_attention_module_matches_flax(rng, masked):
    """Masked: a padded sample of no valid node takes the max(count, 1)
    path (its mean is 0, its output 0)."""
    x = rng.normal(size=(4, 9, FILTERS)).astype(np.float32)
    mask = None
    if masked:
        n = np.array([9, 5, 1, 0])
        mask = (np.arange(9)[None] < n[:, None]).astype(np.float32)
    jm, params, tm = afai_pair(j_afau.DenseAttentionModule,
                               t_afau.DenseAttentionModule, x, mask,
                               filters=FILTERS)
    want = np.asarray(jm.apply({"params": params}, x, mask))
    got = t2n(tm(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, **AFAI_TOL)
    if masked:
        assert not got[3].any()


def test_alternative_stages_equal_the_jax_ones():
    want = [dataclasses.asdict(s) for s in j_config.alternative_stages()]
    got = [dataclasses.asdict(s) for s in t_config.alternative_stages()]
    assert got == want and len(got) == 3


@pytest.mark.parametrize("start,stop,num", [
    ((0.0, 0.0), (1.0, 2.0), (3, 5)),
    ((-1.0, 0.5, 2.0), (1.0, 1.5, 3.0), (2, 4, 3))])
def test_make_grids_equals_the_jax_one(start, stop, num):
    got = t_bg.make_grids(start, stop, num)
    want = j_bg.make_grids(start, stop, num)
    assert got.dtype == np.float32 and got.shape == (np.prod(num), len(num))
    np.testing.assert_array_equal(got, want)


def torchvision_resnet18_state_dict(rng):
    """Random arrays in torchvision's ResNet-18 layout (fc included, as in
    the file torchvision writes)."""
    sd = {}

    def bn(p, c):
        sd[p + ".weight"] = rng.uniform(0.5, 1.5, c)
        sd[p + ".bias"] = rng.normal(size=c)
        sd[p + ".running_mean"] = rng.normal(size=c)
        sd[p + ".running_var"] = rng.uniform(0.5, 1.5, c)
        sd[p + ".num_batches_tracked"] = np.array(7)

    sd["conv1.weight"] = rng.normal(size=(64, 3, 7, 7))
    bn("bn1", 64)
    prev = 64
    for layer, ch in zip(range(1, 5), (64, 128, 256, 512)):
        for blk in range(2):
            t = f"layer{layer}.{blk}"
            cin = prev if blk == 0 else ch
            sd[t + ".conv1.weight"] = rng.normal(size=(ch, cin, 3, 3))
            bn(t + ".bn1", ch)
            sd[t + ".conv2.weight"] = rng.normal(size=(ch, ch, 3, 3))
            bn(t + ".bn2", ch)
            if blk == 0 and cin != ch:
                sd[t + ".downsample.0.weight"] = rng.normal(
                    size=(ch, cin, 1, 1))
                bn(t + ".downsample.1", ch)
        prev = ch
    sd["fc.weight"] = rng.normal(size=(1000, 512))
    sd["fc.bias"] = rng.normal(size=1000)
    return {k: np.asarray(v, np.float32 if v.ndim or "num_" not in k
                          else np.int64) for k, v in sd.items()}


def test_load_torch_resnet18_equals_the_flax_loader_converted(rng):
    """The port's loader against the JAX loader's Flax trees carried across
    by the converter: the same tensors, exactly; the result loads into the
    port's backbone at the default widths with no key left over."""
    sd = torchvision_resnet18_state_dict(rng)
    got = t_bb.load_torch_resnet18(sd)
    want = flax_tree_to_state_dict(*(np_tree(v) for v in
                                     j_bb.load_torch_resnet18(sd).values()))
    assert set(got) - set(want) == {k for k in got
                                    if k.endswith("num_batches_tracked")}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert all(int(got[k]) == 7 for k in got
               if k.endswith("num_batches_tracked"))
    t_bb.ResNet18Backbone().load_state_dict(got, strict=True)


def test_param_labels_equal_the_jax_labels():
    """Every parameter of the port's model against the JAX labels of the
    same names (the JAX function reads only the top-level module name, so
    a tree of the port's names stands in for its parameters)."""
    model = NGMNet(to_torch_config(tiny_jax_config()))
    got = t_state.param_labels(model)
    tree = {}
    for name in got:
        *mods, leaf = name.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.zeros(())
    flat = jax.tree_util.tree_flatten_with_path(j_state.param_labels(tree))[0]
    want = {".".join(k.key for k in path): v for path, v in flat}
    assert got == want
    assert set(got.values()) == set(t_state.PARTITIONS)


def test_native_available_reports_a_failed_build(monkeypatch):
    assert native.available()

    def broken():
        raise RuntimeError("native build failed: no compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    assert not native.available()
    with pytest.raises(RuntimeError):
        native.get_lib()
