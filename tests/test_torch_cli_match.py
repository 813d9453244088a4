"""The port's serving CLI (`fpmatch_tpu_torch.cli.match`) on the CPU against
the JAX package's, on two written images + .tsv keypoint files, with the
Flax-initialised weights carried across as a checkpoint file. Also: package
hygiene (the port and chip_smoke.py import no JAX and nothing of the JAX
package)."""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from fpmatch_tpu.cli import match as j_match
from fpmatch_tpu.models.ngm import NGMNet as JNet, PairBatch as JPairBatch
from fpmatch_tpu_torch.cli import match as t_match
from fpmatch_tpu_torch.cli import model_config_from_args
from fpmatch_tpu_torch.convert import from_flax_variables
from fpmatch_tpu_torch.data import pipeline as t_pipeline
from test_torch_utils import np_tree

REPO = Path(__file__).resolve().parents[1]
SHAPE_FLAGS = ["--n-max", "24", "--e-max", "160", "--univ", "32"]


def _write_tsv(path, pts):
    with open(path, "w") as f:
        f.write("x\ty\n")
        for x, y in pts:
            f.write(f"{x:.3f}\t{y:.3f}\n")


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """Two 300x280 grayscale-as-RGB fingerprint-like images (so the resize
    + centre crop of `standardize` does real work) with 20 / 17 keypoints;
    a few keypoints fall outside the crop and must be dropped."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:280, 0:300]
    files = []
    base = rng.uniform([10, 10], [290, 270], size=(20, 2))
    for i, n in enumerate((20, 17)):
        ridges = 127 + 100 * np.sin(0.35 * xx + 0.2 * yy * (i + 1))
        img = np.clip(ridges + rng.normal(0, 12, ridges.shape), 0,
                      255).astype(np.uint8)
        png = str(d / f"f{i}.png")
        cv2.imwrite(png, np.stack([img] * 3, -1))
        pts = base[:n] + rng.normal(0, 1.0, (n, 2))
        tsv = str(d / f"f{i}.tsv")
        _write_tsv(tsv, pts)
        files += [png, tsv]
    return d, files


def _argv(files, extra=()):
    png1, tsv1, png2, tsv2 = files
    return [png1, png2, "--kpts1", tsv1, "--kpts2", tsv2, *SHAPE_FLAGS,
            *extra]


@pytest.fixture(scope="module")
def flax0(pair_files):
    """The weights the JAX CLI scores with when it finds no checkpoint
    (`model.init(PRNGKey(0), batch, train=False)` of the same model on a
    batch of the same buckets), from one jitted init (Flax's eager init of
    the full-width model takes minutes on the CPU)."""
    d, files = pair_files
    args = t_match.build_parser().parse_args(_argv(files))
    tcfg = model_config_from_args(args)
    (i1, P1), (i2, P2) = t_match.read_pair(args)
    batch, _ = t_match.build_request(i1, P1, i2, P2, tcfg)
    jargs = j_match.argparse.Namespace(**vars(args))
    from fpmatch_tpu.cli import model_config_from_args as j_cfg_from_args
    jcfg = j_cfg_from_args(jargs)
    init = jax.jit(functools.partial(JNet(jcfg).init, train=False))
    return tcfg, init(jax.random.PRNGKey(0), JPairBatch(*batch[:9]))


class _InitGiven:
    """The JAX CLI's NGMNet with `init` answered by the variables `flax0`
    computed (the same model, key and buckets); every other attribute is the
    module's own, so the CLI's reading, eval step and JSON are its own."""

    def __init__(self, variables, *args, **kw):
        self._module = JNet(*args, **kw)
        self._variables = variables

    def init(self, *args, **kw):
        return self._variables

    def __getattr__(self, name):
        return getattr(self._module, name)


@pytest.fixture(scope="module")
def converted_checkpoint(pair_files, flax0):
    """`flax0` carried across into the port's checkpoint format:
    `<dir>/<name>.pt` + checkpoint.json."""
    d, _ = pair_files
    tcfg, v = flax0
    ckpt = d / "ckpt"
    ckpt.mkdir()
    torch.save(from_flax_variables(np_tree(v), tcfg), ckpt / "flax0.pt")
    (ckpt / "checkpoint.json").write_text(json.dumps({"latest": "flax0"}))
    return str(ckpt)


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.fixture
def jax_cli_given_init(flax0, monkeypatch):
    """The JAX CLI's init answered with `flax0`'s variables (the same model
    and key: the CLI's shape flags are SHAPE_FLAGS in every test that runs
    it), one full-width init for the file instead of one per JAX CLI run."""
    from fpmatch_tpu.models import ngm as j_ngm     # the CLI imports it late
    monkeypatch.setattr(j_ngm, "NGMNet",
                        functools.partial(_InitGiven, flax0[1]))


def test_cli_match_same_json_as_jax_cli(pair_files, converted_checkpoint,
                                        jax_cli_given_init, capsys):
    """Full model width, bucket route, greedy discretization, CPU. Flax's
    own init keeps AFA-U's U(-10, 10) score mixing and tau = 0.01 (see
    test_torch_ngm), so the probabilities are held to 5e-3 and the match
    list to the pairs both runs rank well apart; keys, counts and kinds are
    exact."""
    d, files = pair_files
    rc_j, want = _run(j_match.main, _argv(files, [
        "--checkpoint-dir", str(d / "no_such_dir"), "--threshold", "0.3"]),
        capsys)
    rc_t, got = _run(t_match.main, _argv(files, [
        "--checkpoint-dir", converted_checkpoint, "--threshold", "0.3",
        "--device", "cpu"]), capsys)
    assert rc_j == rc_t == 0
    assert list(got) == list(want)              # same keys, same order
    assert got["checkpoint"] == "flax0" and want["checkpoint"] is None
    for k in ("score_kind", "n_kpts", "threshold", "genuine"):
        assert got[k] == want[k], k
    assert got["n_kpts"][0] < 20            # the crop dropped keypoints
    for k in ("score", "cls_prob", "k_prob"):
        assert abs(got[k] - want[k]) <= 5e-3, (k, got[k], want[k])
    assert abs(got["k_pred"] - want["k_pred"]) <= 5e-3 * min(got["n_kpts"])
    assert abs(got["n_matched"] - want["n_matched"]) <= 1
    assert got["n_matched"] == len(got["matches"])
    common = {tuple(m) for m in got["matches"]} & {tuple(m) for m in
                                                   want["matches"]}
    assert len(common) >= want["n_matched"] - 2


def test_cli_match_univ_route_and_options(pair_files, converted_checkpoint,
                                          capsys):
    """`--univ-kernel` sends the aggregations through kernels.assoc_univ_v3
    (its plain version on the CPU): same verdict as the bucket route of the
    same weights. `--score` picks the score, a named checkpoint is reported.
    """
    d, files = pair_files
    common = ["--checkpoint-dir", converted_checkpoint, "--device", "cpu"]
    _, base = _run(t_match.main, _argv(files, common), capsys)
    rc, univ = _run(t_match.main, _argv(files, common + [
        "--univ-kernel", "--checkpoint", "flax0", "--score", "k"]), capsys)
    assert rc == 0 and univ["checkpoint"] == "flax0"
    assert univ["score_kind"] == "k" and univ["score"] == univ["k_prob"]
    assert "genuine" not in univ
    for k in ("cls_prob", "k_prob"):
        assert abs(univ[k] - base[k]) <= 5e-3, k
    assert abs(univ["n_matched"] - base["n_matched"]) <= 1
    assert abs(base["score"] - base["cls_prob"] * base["k_prob"]) <= 2e-6


def test_cli_match_seeded_init_without_checkpoint(pair_files, capsys):
    d, files = pair_files
    argv = _argv(files, ["--checkpoint-dir", str(d / "none"), "--device",
                         "cpu", "--seed", "5"])
    _, a = _run(t_match.main, argv, capsys)
    _, b = _run(t_match.main, argv, capsys)
    assert a == b and a["checkpoint"] is None
    assert 0.0 <= a["k_prob"] <= 1.0 and 0.0 <= a["cls_prob"] <= 1.0
    assert a["n_matched"] == min(round(a["k_prob"] * min(a["n_kpts"])),
                                 min(a["n_kpts"]))


def test_cli_match_hyperedge_cls_k_and_viz_on_the_cpu(pair_files, tmp_path,
                                                       monkeypatch, capsys):
    """`--hyperedge --cls-k-features --viz` at tiny widths
    (test_torch_utils.build_tiny): the model carries both options, the
    request its Delaunay triangles, the JSON the JAX CLI's keys and the
    drawing's path. A request on the UNIV route (`--univ-kernel`) raises
    the JAX model's "hyperedge + univ kernel"."""
    from test_torch_utils import build_tiny

    d, files = pair_files
    built = build_tiny(monkeypatch)
    seen = []
    real = t_match.build_request
    monkeypatch.setattr(t_match, "build_request", lambda *a, **k: seen.append(
        real(*a, **k)) or seen[-1])
    viz = str(tmp_path / "hyper.png")
    flags = ["--device", "cpu", "--checkpoint-dir", str(d / "none"),
             "--hyperedge", "--cls-k-features"]
    rc, out = _run(t_match.main, _argv(files, flags + ["--viz", viz]),
                   capsys)
    cfg, model, _ = built[0]
    assert rc == 0 and cfg.ngm.hyperedge and cfg.ngm.cls_k_features
    assert hasattr(model, "tri_aff")
    assert model.match_cls.fc.in_features == \
        cfg.ngm.match_cls_channels[-1] + 3
    batch, plan = seen[0]
    assert plan is None and batch.n_tris.min() > 0
    assert batch.tri.shape == (1, 2, cfg.shapes.t_max, 3)
    assert list(out) == ["score", "score_kind", "cls_prob", "k_prob",
                         "k_pred", "n_kpts", "n_matched", "matches",
                         "checkpoint", "viz"]
    assert out["n_matched"] == len(out["matches"])
    assert os.path.getsize(viz) > 0
    with pytest.raises(NotImplementedError, match="hyperedge \\+ univ"):
        t_match.main(_argv(files, flags + ["--univ-kernel"]))


def test_cli_match_errors(pair_files, tmp_path, capsys):
    d, files = pair_files
    png1, tsv1, png2, tsv2 = files
    cpu = ["--device", "cpu", *SHAPE_FLAGS]
    # every keypoint outside the 240x320 crop -> error JSON, exit code 2
    far = str(tmp_path / "far.tsv")
    _write_tsv(far, [(150.0, 2.0), (140.0, 278.0)])
    rc, out = _run(t_match.main, [png1, png2, "--kpts1", far, "--kpts2",
                                  tsv2, *cpu], capsys)
    assert rc == 2 and "error" in out and out["n_kpts"][0] == 0
    empty = str(tmp_path / "empty.tsv")
    _write_tsv(empty, [])
    rc, out = _run(t_match.main, [png1, png2, "--kpts1", empty, "--kpts2",
                                  tsv2, *cpu], capsys)
    assert rc == 2 and out["error"] == "no keypoints found"
    # --viz draws the pair with its matches, as the JAX CLI: a PNG of the
    # two 240x320 crops side by side, its path in the JSON
    viz = str(tmp_path / "pair.png")
    rc, out = _run(t_match.main, [png1, png2, "--kpts1", tsv1, "--kpts2",
                                  tsv2, "--viz", viz, *cpu], capsys)
    cv2 = pytest.importorskip("cv2")
    assert rc == 0 and out["viz"] == viz and list(out)[-1] == "viz"
    assert cv2.imread(viz).shape == (240, 640, 3)
    with pytest.raises(FileNotFoundError):
        t_match.main([str(tmp_path / "nope.png"), png2, "--kpts1", tsv1,
                      "--kpts2", tsv2, *cpu])
    # the CNN detector needs its weights
    with pytest.raises(ValueError, match="--detector-checkpoint"):
        t_match.main([png1, png2, "--kpts1", tsv1, "--detector", "cnn",
                      *cpu])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_match.main([png1, png2, "--kpts1", tsv1, "--kpts2", tsv2,
                          *SHAPE_FLAGS])          # default device is cuda


# ------------------------------------------------ bare images and hungarian

WEIGHTS = REPO / "results" / "poredet" / "net17nomax.npz"


@pytest.fixture(scope="module")
def bare_images(tmp_path_factory):
    """Two impressions of one finger from the port's generator (480x400),
    written as PNG with no keypoint files."""
    cv2 = pytest.importorskip("cv2")
    from fpmatch_tpu_torch.data.generator import render_impression

    d = tmp_path_factory.mktemp("bare")
    out = []
    for s in (1, 2):
        img = render_impression(3, s)[0]
        out.append(str(d / f"imp{s}.png"))
        cv2.imwrite(out[-1], np.stack([img] * 3, -1))
    return out


def _same_json(got, want, exact_kpts=True):
    """The JSON of the two CLIs: keys, counts and kinds exact; probabilities
    to 5e-3 and the match lists up to the pairs both runs rank well apart
    (random weights at tau = 0.01, see test_cli_match_same_json_as_jax_cli).
    """
    assert list(got) == list(want)
    for k in ("score_kind", "n_kpts") if exact_kpts else ("score_kind",):
        assert got[k] == want[k], k
    for k in ("score", "cls_prob", "k_prob"):
        assert abs(got[k] - want[k]) <= 5e-3, (k, got[k], want[k])
    assert abs(got["k_pred"] - want["k_pred"]) <= 5e-3 * min(got["n_kpts"])
    assert abs(got["n_matched"] - want["n_matched"]) <= 1
    assert got["n_matched"] == len(got["matches"])
    common = {tuple(m) for m in got["matches"]} & {tuple(m) for m in
                                                   want["matches"]}
    assert len(common) >= want["n_matched"] - 2


@pytest.mark.parametrize("extra", [
    ["--discretize", "hungarian"],
    ["--detector", "cnn", "--detector-checkpoint", str(WEIGHTS)]],
    ids=["dpf-hungarian", "cnn-greedy"])
def test_cli_match_bare_images_same_json_as_jax_cli(
        bare_images, converted_checkpoint, jax_cli_given_init, capsys,
        extra):
    """Two images and no keypoint files on both CLIs: the Lemes DPF detector
    (the JAX CLI's default) with the full Hungarian discretization (host
    LAPJV between two forwards), and the trained CNN detector with the
    greedy one."""
    d = Path(converted_checkpoint).parent
    flags = [*bare_images, *SHAPE_FLAGS, *extra]
    rc_j, want = _run(j_match.main, flags + [
        "--checkpoint-dir", str(d / "no_such_dir")], capsys)
    rc_t, got = _run(t_match.main, flags + [
        "--checkpoint-dir", converted_checkpoint, "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert got["n_kpts"] == want["n_kpts"] and min(got["n_kpts"]) >= 10
    _same_json({**got, "checkpoint": None}, want)


@pytest.mark.parametrize("detector", ["dpf", "cnn"])
def test_detector_route_gives_the_jax_cli_keypoints(bare_images, detector):
    """`read_pair` without keypoint files against the JAX CLI's
    `_load_annos` + standardize: the same gray image (float32 luma, then a
    truncating cast), the same detections, the same keypoints after the
    crop, bit for bit."""
    from fpmatch_tpu.data.augmentation import standardize as j_standardize
    from fpmatch_tpu.data.pipeline import _load_image as j_load

    flags = [*bare_images, "--n-max", "600", "--detector", detector,
             "--device", "cpu"]
    if detector == "cnn":
        flags += ["--detector-checkpoint", str(WEIGHTS)]
    args = t_match.build_parser().parse_args(flags)
    got = t_match.read_pair(args)
    det = {"arch": args.detector_arch,
           "checkpoint": args.detector_checkpoint,
           "probability": args.detector_probability,
           "nms_iou": args.detector_nms_iou}
    for (img_t, P_t), path, prefix in zip(got, bare_images, ("q1", "q2")):
        img = j_load(path)
        assert np.array_equal(t_match.gray_for_detector(img), np.asarray(
            img[..., :3] @ [0.299, 0.587, 0.114], np.float32).astype(
                np.uint8))
        im, an = j_standardize(img, j_match._load_annos(img, None, prefix,
                                                        detector, det))
        want = np.array([[x, y] for _, x, y in an[:600]], np.float32)
        assert np.array_equal(img_t, im)
        assert len(P_t) >= 10 and np.array_equal(P_t, want)


def test_cli_match_cnn_detector_and_hungarian_on_both_routes(
        bare_images, converted_checkpoint, capsys):
    """`--detector cnn` with the trained net17nomax weights serves the bare
    pair; `--discretize hungarian` on the UNIV route (`--univ-kernel`, the
    plan carried into the masked pass) gives the bucket route's verdict."""
    common = [*bare_images, *SHAPE_FLAGS, "--checkpoint-dir",
              converted_checkpoint, "--device", "cpu", "--detector", "cnn",
              "--detector-checkpoint", str(WEIGHTS)]
    rc, greedy = _run(t_match.main, common, capsys)
    assert rc == 0 and min(greedy["n_kpts"]) >= 10
    _, bucket = _run(t_match.main, common + ["--discretize", "hungarian"],
                     capsys)
    _, univ = _run(t_match.main, common + ["--discretize", "hungarian",
                                           "--univ-kernel"], capsys)
    for res in (bucket, univ):
        assert res["n_matched"] == min(round(res["k_pred"]),
                                       min(res["n_kpts"]))
    _same_json(univ, bucket)


def test_match_arrays_hungarian_matches_lie_in_the_lapjv_mask(
        pair_files, converted_checkpoint):
    """Below the files: the first forward's ds_mat, its host LAPJV mask, and
    the second (masked) pass of `match_arrays(discretize="hungarian")`:
    every match is a cell of the mask, `n_matched == round(k_pred)`, on the
    bucket and the UNIV route."""
    from fpmatch_tpu_torch.ops.hungarian import hungarian_host

    d, files = pair_files
    args = t_match.build_parser().parse_args(_argv(files, [
        "--checkpoint-dir", converted_checkpoint, "--device", "cpu"]))
    cfg = model_config_from_args(args)
    (i1, P1), (i2, P2) = t_match.read_pair(args)
    model, _ = t_match.load_model(cfg, args)
    for univ in (None, True):
        batch, plan = t_match.build_request(i1, P1, i2, P2, cfg, univ)
        assert (plan is None) == (univ is None)
        first = model(batch.to("cpu"), univ_plan=plan)
        mask = hungarian_host(first["ds_mat"], batch.n_nodes[:, 0],
                              batch.n_nodes[:, 1])[0]
        res, out = t_match.match_arrays(model, i1, P1, i2, P2,
                                        univ_kernel=univ,
                                        discretize="hungarian",
                                        return_outputs=True)
        perm = out["perm_mat"][0].numpy()
        assert set(out) == {"cls_prob", "k_prob", "perm_mat", "ds_mat"}
        assert perm.sum() == res["n_matched"] > 0
        assert (perm <= mask).all()
        assert res["n_matched"] == min(round(res["k_pred"]), min(res[
            "n_kpts"]))
    with pytest.raises(ValueError, match="discretize"):
        t_match.match_arrays(model, i1, P1, i2, P2, discretize="exact")


def test_read_keypoints_formats(tmp_path):
    from fpmatch_tpu.data.dataset import read_keypoints as j_read
    from fpmatch_tpu_torch.data.dataset import read_keypoints as t_read

    (tmp_path / "a.tsv").write_text("x\ty\tid\n1.5\t2\t4\n3\t4\t-2\nbad\t1\t0\n")
    (tmp_path / "b.csv").write_text("x,y\n1,2\n3.25,4\n")
    (tmp_path / "c.txt").write_text("1,2\n\nnot a point\n5,6.5\n")
    for name in ("a.tsv", "b.csv", "c.txt"):
        assert t_read(tmp_path / name, "q", "u") == \
            j_read(tmp_path / name, "q", "u")


def test_collate_and_gray_conversion_match_jax_pipeline(rng):
    """Collation needs no cv2 in the port: its RGB -> luma arithmetic equals
    cv2's, and the padded batch equals the JAX package's field by field."""
    cv2 = pytest.importorskip("cv2")
    from fpmatch_tpu.core.config import Config as JConfig, DataConfig as JData
    from fpmatch_tpu.data import pipeline as j_pipeline
    from fpmatch_tpu_torch.core.config import Config, DataConfig

    img = rng.integers(0, 256, size=(240, 320, 3), dtype=np.uint8)
    assert np.array_equal(t_pipeline.rgb_to_gray(img),
                          cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    P1 = rng.uniform(10, 200, size=(9, 2)).astype(np.float32)
    P2 = rng.uniform(10, 200, size=(7, 2)).astype(np.float32)
    e = (np.array([0, 1, 2], np.int32), np.array([1, 2, 0], np.int32))
    kw = dict(images=(img, img[::-1].copy()), points=(P1, P2), edges=(e, e),
              perm=np.eye(9, 7, dtype=np.float32), label=1.0, cls=("a", "b"))
    for ch in (1, 3):
        want = j_pipeline.collate([j_pipeline.PairSample(**kw)],
                                  JConfig(data=JData(image_channels=ch)))
        got = t_pipeline.collate([t_pipeline.PairSample(**kw)],
                                 Config(data=DataConfig(image_channels=ch)))
        for name, a, b in zip(want._fields, want, got):
            if a is None:
                assert b is None
            else:
                assert np.array_equal(a, b) and a.dtype == b.dtype, name
    gray2d = t_pipeline.collate(
        [t_pipeline.PairSample(**{**kw, "images": (img[..., 0],
                                                    img[..., 1])})],
        Config(data=DataConfig(image_channels=1)))
    assert gray2d.images.shape == (1, 2, 240, 320, 1)


# ----------------------------------------------------------------- hygiene

def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of fpmatch_tpu_torch, imported in a fresh interpreter,
    leaves jax / flax / optax / orbax / fpmatch_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fpmatch_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'fpmatch_tpu'))\n"
        "new = ['cli.evaluate', 'data.benchmark', 'data.generator', "
        "'evaluation.metrics', 'kernels.assoc_bucket', 'kernels.assoc_univ', "
        "'kernels.inoculate', 'scripts.tune_univ', 'train.checkpoints', "
        "'train.losses', 'train.step', 'utils.visualize', 'native', "
        "'ops.hungarian', 'poredet.architectures', 'poredet.convert', "
        "'poredet.dpf', 'poredet.evaluate', 'poredet.inference', "
        "'poredet.patches', 'poredet.train', 'cli.detect_pores', "
        "'ops.qap', 'models.gcn', 'core.graph', 'utils.profiling', "
        "'cli.verify_setup', 'cli.split_dataset', 'cli.combine_dataset', "
        "'cli.preview_augmentations', 'scripts.train_poredet']\n"
        "missing = [n for n in new if p.__name__ + '.' + n not in names]\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 30 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_loader_workers_import_no_torch():
    """What a spawned loader worker imports to unpickle its dataset and build
    samples (the `data` modules and the host-side graph code) pulls in no
    `torch`: a worker can never create a CUDA context."""
    code = (
        "import sys\n"
        "import fpmatch_tpu_torch.data.pipeline, "
        "fpmatch_tpu_torch.data.benchmark, fpmatch_tpu_torch.data.dataset, "
        "fpmatch_tpu_torch.data.generator, "
        "fpmatch_tpu_torch.data.augmentation\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'fpmatch_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_name_no_jax():
    """No source line of the port or of chip_smoke.py imports jax, flax,
    optax, orbax or the JAX package."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|optax|orbax|fpmatch_tpu)"
                     r"(\.|\s|$)", re.M)
    files = list((REPO / "fpmatch_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f
    smoke = (REPO / "chip_smoke.py").read_text()
    assert "jax" not in smoke.lower() and "flax" not in smoke.lower()
    assert not re.search(r"fpmatch_tpu(?!_torch)", smoke)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=str(REPO), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
