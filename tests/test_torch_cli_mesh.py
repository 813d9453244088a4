"""`cli.train --mesh DxE` / `--n-devices N` of the port on the CPU (gloo
ranks spawned by the CLI itself), mirroring the JAX package's
test_cli_mesh: one epoch of stage 1 at tiny widths (the ranks build their
model with test_torch_mesh_worker.tiny_build_model) on a mesh of two ranks
against the one-device run of the same flags; the final test report's loss
within rtol 2e-3 and its accuracy equal; the mesh run's checkpoint loads into
a one-device model. Plus `parse_mesh_spec` and the refusals.
"""
import numpy as np
import pytest
import torch

from fpmatch_tpu.cli.train import parse_mesh_spec as j_parse_mesh_spec
from fpmatch_tpu_torch.cli import train as t_cli_train
from fpmatch_tpu_torch.core.config import Config, ShapeConfig
from fpmatch_tpu_torch.data.generator import generate_synthetic_dataset
from fpmatch_tpu_torch.models.ngm import build_model
from fpmatch_tpu_torch.train import checkpoints as t_ckpt
from test_torch_mesh_worker import tiny_build_model, tiny_widths


def test_parse_mesh_spec_defaults():
    # 0/1 = one device (no mesh); DxE parses both axes
    parse = t_cli_train.parse_mesh_spec
    assert parse("dp", 0) == (1, 1)
    assert parse("dp", 1) == (1, 1)
    assert parse("dp", 2) == (2, 1)
    assert parse("2x4", 0) == (2, 4)
    assert parse("dp", -1) == (max(torch.cuda.device_count(), 1), 1)
    with pytest.raises(ValueError):
        parse("ring", 0)
    for spec, n in (("dp", 0), ("dp", 3), ("1x2", 0), ("2x2", 5)):
        assert parse(spec, n) == j_parse_mesh_spec(spec, n)


@pytest.fixture(scope="module")
def common(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh") / "Synthetic")
    generate_synthetic_dataset(root, fingers_per_split=(4, 2, 2),
                               n_pores=40, seed=0, size=(320, 280))
    return ["--data-root", root, "--stages", "1", "--epochs", "1",
            "--passes", "1", "--length", "4", "--batch-size", "2",
            "--test-length", "4", "--n-max", "16", "--e-max", "96",
            "--univ", "24", "--thread-workers", "--device", "cpu"]


@pytest.fixture(scope="module")
def single(common, tmp_path_factory):
    return t_cli_train.main(common + [
        "--checkpoint-dir", str(tmp_path_factory.mktemp("c1"))],
        model_factory=tiny_build_model)


@pytest.mark.parametrize("flags", [["--mesh", "2x1"], ["--mesh", "1x2"],
                                   ["--n-devices", "2"]],
                         ids=["2x1", "1x2", "n2"])
def test_cli_train_mesh_matches_one_device(common, single, flags, tmp_path):
    r = t_cli_train.main(common + flags + [
        "--checkpoint-dir", str(tmp_path / "c")],
        model_factory=tiny_build_model)
    assert np.isfinite(r["loss"]) and np.isfinite(r["total_loss"])
    np.testing.assert_allclose(r["loss"], single["loss"], rtol=2e-3)
    np.testing.assert_allclose(r["accuracy"], single["accuracy"])
    assert r["n_pairs"] == single["n_pairs"]
    sd = t_ckpt.restore_params(tmp_path / "c", "stage1_last")
    assert not any(k.startswith("module.") for k in sd)
    cfg = tiny_widths(Config(shapes=ShapeConfig(n_max=16, e_max=96,
                                                univ_size=24)))
    build_model(cfg, device="cpu", state_dict=sd)


@pytest.mark.parametrize("flags,msg", [
    (["--mesh", "2x1", "--batch-size", "3"], "not divisible by data axis"),
    (["--mesh", "1x3", "--n-max", "16"], "not divisible by edge axis"),
], ids=["batch", "n-max"])
def test_cli_train_mesh_refusals(common, flags, msg, tmp_path):
    with pytest.raises(SystemExit, match=msg):
        t_cli_train.main(common + flags + ["--checkpoint-dir",
                                           str(tmp_path)])
