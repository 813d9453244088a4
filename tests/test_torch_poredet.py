"""The port's pore detector (`fpmatch_tpu_torch.poredet`, `cli.detect_pores`)
on the CPU against the JAX package's, on the same numpy inputs:

  * every architecture family (plain / res, max / nomax, gabriel, su): Flax's
    init (random BatchNorm statistics) carried across by
    `convert.pore_variables_to_state_dict`, probability map within 1e-5;
  * the trained `results/poredet/net17nomax.npz` on the eight PolyU fixture
    test images: identical coordinates, map within 1e-5;
  * both DPF detectors on a generator impression: identical coordinates;
  * full-image validation, the threshold grid search and the final test
    phases: equal scores;
  * the weight files, the reference state dict import, the patch helpers,
    the patch bank and `cli.detect_pores` (the same .txt files as the JAX
    CLI).
"""
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.cli import detect_pores as j_cli
from fpmatch_tpu.data import generator as j_generator
from fpmatch_tpu.poredet import architectures as ja
from fpmatch_tpu.poredet import dpf as j_dpf
from fpmatch_tpu.poredet import inference as ji
from fpmatch_tpu.poredet import patches as j_patches
from fpmatch_tpu.poredet import train as jt
from fpmatch_tpu.poredet.convert import convert_pore_state_dict as j_convert
from fpmatch_tpu_torch.cli import detect_pores as t_cli
from fpmatch_tpu_torch.convert import pore_variables_to_state_dict
from fpmatch_tpu_torch.data import generator as t_generator
from fpmatch_tpu_torch.poredet import architectures as ta
from fpmatch_tpu_torch.poredet import convert as t_convert
from fpmatch_tpu_torch.poredet import dpf as t_dpf
from fpmatch_tpu_torch.poredet import inference as ti
from fpmatch_tpu_torch.poredet import patches as t_patches
from fpmatch_tpu_torch.poredet import train as tt
from test_torch_utils import np_tree, randomize_batch_stats

REPO = Path(__file__).resolve().parents[1]
WEIGHTS = REPO / "results" / "poredet" / "net17nomax.npz"
FIXTURE = REPO / "tests" / "fixtures" / "PolyU-mini" / "DBII" / "test"
MAP_TOL = 1e-5


def _flax_pair(name, features, hw, seed=0):
    """Flax-initialised variant `name` (random BatchNorm statistics), its
    port with the variables converted, and an input batch of 2."""
    jm = ja.make_architecture(name, features=features)
    x = np.random.default_rng(seed).uniform(size=(2, *hw, 1)).astype(
        np.float32)
    v = jm.init({"params": jax.random.PRNGKey(seed),
                 "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x),
                train=False)
    v = randomize_batch_stats(v, seed)
    tm = ta.make_architecture(name, features=features)
    tm.load_state_dict(pore_variables_to_state_dict(v))
    return jm, v, tm, x


@pytest.mark.parametrize("name,hw", [
    ("net13max", (40, 36)), ("net17nomax", (30, 26)),
    ("resnet15max", (44, 40)), ("resnet19nomax", (30, 28)),
    ("gabriel", (34, 30)), ("su", (21, 19))])
def test_architecture_maps_match_flax(name, hw):
    jm, v, tm, x = _flax_pair(name, 8, hw)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape and want.shape[1] > 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MAP_TOL)


def test_all_18_architectures_and_receptive_fields():
    assert ta.ARCHITECTURES == ja.ARCHITECTURES and len(ta.ARCHITECTURES) == 18
    for name in ta.ARCHITECTURES:
        rf = ta.receptive_field(name)
        assert rf == ja.receptive_field(name)
        m = ta.make_architecture(name, features=4)
        assert not m.training
        win = rf if "max" not in name or "nomax" in name else rf * 2 + 7
        with torch.inference_mode():
            out = m(torch.rand(2, 1, win, win))
        assert out.shape[:2] == (2, 1)
        assert 0 <= float(out.min()) and float(out.max()) <= 1
        if "nomax" in name or name == "su":
            assert out.shape[2] == out.shape[3] == win - rf + 1
    with pytest.raises(ValueError):
        ta.make_architecture("net21nomax")


# ------------------------------------------------------------ trained weights

def _fixture_images():
    import cv2

    out = []
    for png in sorted(FIXTURE.glob("*.png")):
        gt = np.loadtxt(png.with_suffix(".tsv"), skiprows=1,
                        usecols=(1, 2)).reshape(-1, 2).astype(np.float32)
        out.append((png, cv2.imread(str(png), cv2.IMREAD_GRAYSCALE), gt))
    assert len(out) == 8
    return out


@pytest.fixture(scope="module")
def trained():
    jm = ja.make_architecture("net17nomax")
    jv = jt.load_variables(str(WEIGHTS))
    tm = tt.load_detector("net17nomax", WEIGHTS, device="cpu")
    return jm, jv, tm, _fixture_images()


def test_trained_detector_on_the_fixture_images(trained):
    jm, jv, tm, images = trained
    total = 0
    for png, img, _ in images:
        want, wmap = ji.detect_pores_in_image(jm, jv, img)
        got, gmap = ti.detect_pores_in_image(tm, img)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want), png.name
        np.testing.assert_allclose(gmap, wmap, rtol=0, atol=MAP_TOL)
        total += len(got)
    assert total > 100                   # 20-25 pores per 96x96 image


def test_full_image_validation_and_threshold_search(trained):
    jm, jv, tm, images = trained
    imgs = [img for _, img, _ in images]
    gts = [gt for *_, gt in images]
    kw = dict(window=17, probability=0.65, nms_iou=0.2)
    want = jt.validate_full_images(jm, jv, imgs, gts, **kw)
    got = tt.validate_full_images(tm, imgs, gts, **kw)
    assert got == want and got["n_images"] == 8 and got["f_score"] > 0.3
    quiet = dict(log_fn=lambda *a: None)
    assert tt.grid_search_thresholds(
        tm, imgs[:4], gts[:4], window=17, **quiet) == \
        jt.grid_search_thresholds(jm, jv, imgs[:4], gts[:4], window=17,
                                  **quiet)
    sets = {"test_i": (imgs[:4], gts[:4]), "test_ii": (imgs[4:], gts[4:]),
            "empty": ([], [])}
    assert tt.final_test_phases(tm, sets, **kw, **quiet) == \
        jt.final_test_phases(jm, jv, sets, **kw, **quiet)


def test_weight_files_round_trip(tmp_path):
    v = tt.load_variables(WEIGHTS)
    with np.load(WEIGHTS) as z:
        assert len(z.files) == 37
        assert np.array_equal(v["params"]["LayerBlock_3"]["Conv_0"]["kernel"],
                              z["params/LayerBlock_3/Conv_0/kernel"])
    p = tmp_path / "w.npz"
    tt.save_variables(p, v)
    back = np_tree(jt.load_variables(str(p)))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [k for k, _ in flat(back)] == [k for k, _ in flat(v)]
    for (_, a), (_, b) in zip(flat(back), flat(v)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="msgpack"):
        tt.load_detector("net17nomax", tmp_path / "w.msgpack", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tt.load_detector("net17nomax", WEIGHTS)      # default: cuda


def test_reference_state_dict_loads_into_plain_net(tmp_path):
    """A state dict in the reference's layout (net.{i}.block.{0,2}, head
    net.{L-1}) through the JAX converter + Flax and straight into the
    port's PlainPoreNet: the same map."""
    rng = np.random.default_rng(3)
    L, f = 6, 8
    sd = {}
    for i in range(L - 1):
        cin = 1 if i == 0 else f
        sd[f"net.{i}.block.0.weight"] = rng.normal(0, 0.3, (f, cin, 3, 3))
        sd[f"net.{i}.block.2.weight"] = rng.uniform(0.5, 1.5, f)
        sd[f"net.{i}.block.2.bias"] = rng.normal(0, 0.1, f)
        sd[f"net.{i}.block.2.running_mean"] = rng.normal(0, 0.1, f)
        sd[f"net.{i}.block.2.running_var"] = rng.uniform(0.5, 1.5, f)
    sd[f"net.{L - 1}.weight"] = rng.normal(0, 0.3, (1, f, 3, 3))
    sd[f"net.{L - 1}.bias"] = rng.normal(0, 0.1, 1)
    sd = {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}
    path = tmp_path / "40"
    torch.save(sd, path)
    x = rng.uniform(size=(1, 24, 22, 1)).astype(np.float32)
    jm = ja.PlainPoreNet(features=f, num_layers=L)
    want = np.asarray(jm.apply(j_convert(sd, num_layers=L), jnp.asarray(x),
                               train=False))
    tm = t_convert.load_reference_detector(str(path), features=f,
                                           num_layers=L, device="cpu")
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MAP_TOL)


def test_patch_helpers_and_training_that_waits():
    """The patch helpers, and the patch bank of the training that no longer
    waits: the same arrays as the JAX package's, one default_rng(seed)
    stream across the images."""
    img, pores = j_generator.render_fingerprint(5, size=(120, 100),
                                                n_pores=30)
    for soft in (False, True):
        assert np.array_equal(
            t_patches.rasterize_pores(img.shape, pores, radius=2, soft=soft),
            j_patches.rasterize_pores(img.shape, pores, radius=2, soft=soft))
    want = j_patches.extract_balanced_patches(
        img, pores, window=17, rng=np.random.default_rng(0))
    got = t_patches.extract_balanced_patches(
        img, pores, window=17, rng=np.random.default_rng(0))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    img2, pores2 = j_generator.render_fingerprint(6, size=(100, 120),
                                                  n_pores=25)
    for window, seed in ((17, 0), (13, 4)):
        want = jt.make_patch_bank([img, img2], [pores, pores2], window, seed)
        got = tt.make_patch_bank([img, img2], [pores, pores2], window, seed)
        assert got[0].shape == want[0].shape and got[0].shape[1] == window
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, want))


# ----------------------------------------------------------------------- DPF

@pytest.fixture(scope="module")
def impressions():
    """Two 480x400 impressions of the port's generator (equal to the JAX
    generator's), each detector run once per image and package."""
    out = []
    for seed in (1, 2):
        img = t_generator.render_impression(3, seed)[0]
        assert np.array_equal(img, j_generator.render_impression(3, seed)[0])
        out.append({
            "img": img,
            "lemes": (t_dpf.detect_pores_lemes(img),
                      j_dpf.detect_pores_lemes(img)),
            "dpf": (t_dpf.detect_pores_dpf(img),
                    j_dpf.detect_pores_dpf(img))})
    return out


@pytest.mark.parametrize("method", ["lemes", "dpf"])
def test_dpf_detectors_identical(impressions, method):
    for case in impressions:
        got, want = case[method]
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert sum(len(c[method][0]) for c in impressions) > 50


# ----------------------------------------------------------- the dataset CLI

@pytest.fixture(scope="module")
def jpg_tree(tmp_path_factory):
    """The fixture's test images written as .jpg in a two-level tree (the
    CLIs glob *.jpg only)."""
    import cv2

    root = tmp_path_factory.mktemp("jpg")
    for png, img, _ in _fixture_images():
        sub = root / png.stem[:2]
        sub.mkdir(exist_ok=True)
        cv2.imwrite(str(sub / f"{png.stem}.jpg"), img)
    (root / "ignored.png").write_bytes(b"")
    return root


def _same_tree(a: Path, b: Path):
    fa = sorted(p.relative_to(a) for p in a.rglob("*.txt"))
    fb = sorted(p.relative_to(b) for p in b.rglob("*.txt"))
    assert fa == fb and len(fa) == 8
    for rel in fa:
        assert filecmp.cmp(a / rel, b / rel, shallow=False), rel


@pytest.mark.parametrize("method", ["dpf", "cnn"])
def test_cli_detect_pores_writes_the_jax_cli_files(jpg_tree, tmp_path,
                                                    method, capsys):
    from flax import serialization

    argv = ["--images", str(jpg_tree), "--method", method]
    jargv, targv = list(argv), list(argv)
    if method == "cnn":
        mp = tmp_path / "net17nomax.msgpack"
        mp.write_bytes(serialization.to_bytes(jt.load_variables(
            str(WEIGHTS))))
        jargv += ["--checkpoint", str(mp)]
        targv += ["--checkpoint", str(WEIGHTS), "--device", "cpu"]
    j_cli.main(jargv + ["--out", str(tmp_path / "j")])
    n = t_cli.main(targv + ["--out", str(tmp_path / "t"), "--copy-into",
                            str(tmp_path / "beside")])
    assert n == 8 and "8 images" in capsys.readouterr().out
    _same_tree(tmp_path / "j", tmp_path / "t")
    _same_tree(tmp_path / "t", tmp_path / "beside")
    if method == "cnn":
        with pytest.raises(ValueError, match="msgpack"):
            t_cli.main(targv[:-4] + ["--checkpoint", str(mp), "--device",
                                     "cpu", "--out", str(tmp_path / "x")])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                t_cli.main(targv[:-2] + ["--out", str(tmp_path / "y")])


def test_detect_dataset_matches_jax(trained, jpg_tree, tmp_path):
    jm, jv, tm, _ = trained
    assert ti.detect_dataset(tm, str(jpg_tree), str(tmp_path / "t")) == 8
    assert ji.detect_dataset(jm, jv, str(jpg_tree), str(tmp_path / "j")) == 8
    _same_tree(tmp_path / "j", tmp_path / "t")
