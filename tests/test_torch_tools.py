"""The port's host tools against the JAX package's on the CPU:

  * `cli.verify_setup` (the card's edition) on `--device cpu`: every check
    passes with a dataset, exits 1 with a FAIL line without one, and on the
    default `cuda` without a GPU;
  * `cli.split_dataset`, `cli.combine_dataset`, `cli.preview_augmentations`:
    the same files, byte for byte (the preview's pixels), as the JAX CLIs
    with the same flags;
  * `utils.profiling`: `assoc_roofline` the JAX formula (the H100's HBM
    peak by default), `time_fn`, `trace` writing a TensorBoard trace;
  * `utils.visualize`: the heatmap and graph drawings, the same pixels as
    the JAX package's.
"""
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from fpmatch_tpu.cli import combine_dataset as j_combine
from fpmatch_tpu.cli import preview_augmentations as j_preview
from fpmatch_tpu.cli import split_dataset as j_split
from fpmatch_tpu.core.build_graphs import build_edges
from fpmatch_tpu.utils import profiling as j_prof
from fpmatch_tpu.utils import visualize as j_vis
from fpmatch_tpu_torch.cli import combine_dataset as t_combine
from fpmatch_tpu_torch.cli import preview_augmentations as t_preview
from fpmatch_tpu_torch.cli import split_dataset as t_split
from fpmatch_tpu_torch.cli import verify_setup as t_verify
from fpmatch_tpu_torch.utils import profiling as t_prof
from fpmatch_tpu_torch.utils import visualize as t_vis


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _same_trees(a: Path, b: Path):
    files = _tree(a)
    assert files and files == _tree(b)
    for f in files:
        assert filecmp.cmp(a / f, b / f, shallow=False), f


def _pixels(path):
    import cv2
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def test_verify_setup_on_the_cpu(tmp_path, capsys):
    data = tmp_path / "Synthetic"
    data.mkdir()
    (data / "a.txt").write_text("1,2\n")
    assert t_verify.main(["--device", "cpu", "--data-root", str(data)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out] == [
        ["PASS", n] for n in ("devices", "imports", "native", "kernels",
                              "dataset", "sinkhorn")]
    assert t_verify.main(["--device", "cpu", "--data-root",
                          str(tmp_path / "missing")]) == 1
    assert "FAIL  dataset" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert t_verify.main(["--data-root", str(data)]) == 1
        assert "FAIL  devices" in capsys.readouterr().out


def test_split_and_combine_write_the_jax_clis_files(tmp_path):
    import cv2

    flat = tmp_path / "flat"
    flat.mkdir()
    rng = np.random.default_rng(0)
    for person in range(7):
        for k in range(2):
            stem = f"p{person}_{k}"
            cv2.imwrite(str(flat / f"{stem}.png"),
                        rng.integers(0, 255, (8, 8), dtype=np.uint8))
            (flat / f"{stem}.tsv").write_text(f"id\tx\ty\n0\t{k}\t{person}\n")
    for mod, out in ((j_split, "jax"), (t_split, "port")):
        mod.main(["--source", str(flat), "--dest", str(tmp_path / out),
                  "--seed", "5"])
    _same_trees(tmp_path / "jax", tmp_path / "port")
    assert {p.name for p in (tmp_path / "port").iterdir()} == {
        "R1", "R2", "R3", "R4", "R5"}

    imgs, annos = tmp_path / "images", tmp_path / "annos"
    for folder in ("R1", "R2"):
        (imgs / folder).mkdir(parents=True)
        (annos / folder).mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(imgs / folder / f"{i}.jpg"),
                        np.full((4, 4), 40 * i, np.uint8))
            if i < 2:                        # one image without annotation
                (annos / folder / f"{i}.tsv").write_text(f"{folder} {i}\n")
    for mod, out in ((j_combine, "jax_c"), (t_combine, "port_c")):
        mod.main(["--image-root", str(imgs), "--anno-root", str(annos),
                  "--target", str(tmp_path / out), "--folders", "R1,R2"])
    _same_trees(tmp_path / "jax_c", tmp_path / "port_c")
    assert t_combine.combine_items(imgs, annos, tmp_path / "again",
                                   ["R1", "R2"]) == 4


def test_preview_augmentations_draws_the_jax_clis_tiles(tmp_path):
    for mod, name in ((j_preview, "jax.png"), (t_preview, "port.png")):
        mod.main(["--out", str(tmp_path / name), "--seed", "3"])
    want, got = _pixels(tmp_path / "jax.png"), _pixels(tmp_path / "port.png")
    assert got.shape == want.shape == (480, 4 * 320, 3)
    assert np.array_equal(got, want)


def test_profiling_helpers(tmp_path):
    args = (2.5e-5, 8, 64, 64, 384, 384, 17)
    want = j_prof.assoc_roofline(*args, hbm_bytes_per_s=3.35e12)
    got = t_prof.assoc_roofline(*args)
    assert t_prof.HBM_BYTES_PER_S == 3.35e12
    assert t_prof.PEAK_DEVICE == "NVIDIA H100 80GB HBM3"
    for k in ("seconds", "nnz", "bytes_moved", "achieved_edges_per_s",
              "lightspeed_edges_per_s", "efficiency"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-12)
    assert got.bytes_moved == 8 * 4 * (384 * 384 + 2 * 64 * 64 * 17)
    calls = []
    s = t_prof.time_fn(lambda a: calls.append(a) or a * 2, 3, iters=5,
                       warmup=2)
    assert s >= 0 and calls == [3] * 7
    with t_prof.trace(str(tmp_path / "tb")) as prof:
        torch.ones(4).sum()
    assert prof is not None
    assert list((tmp_path / "tb").rglob("*.json"))


def test_heatmap_and_graph_drawings_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    sim = rng.normal(size=(10, 12)).astype(np.float32)
    j_vis.similarity_heatmap(sim, 8, 9, path=str(tmp_path / "j_heat.png"))
    assert t_vis.similarity_heatmap(sim, 8, 9,
                                    path=str(tmp_path / "t_heat.png")) is None
    assert np.array_equal(_pixels(tmp_path / "t_heat.png"),
                          _pixels(tmp_path / "j_heat.png"))
    fig = t_vis.similarity_heatmap(sim, 8, 9)
    assert fig is not None

    pts = np.zeros((2, 16, 2), np.float32)
    src = np.zeros((2, 48), np.int32)
    dst = np.zeros((2, 48), np.int32)
    ns, ne = np.zeros(2, np.int32), np.zeros(2, np.int32)
    for b, n in enumerate((12, 16)):
        P = rng.uniform(0, 200, size=(n, 2)).astype(np.float32)
        _, s, d = build_edges(P)
        pts[b, :n], ns[b], ne[b] = P, n, min(len(s), 48)
        src[b, :ne[b]], dst[b, :ne[b]] = s[:48], d[:48]
    for layout in ("spatial", "spring"):
        jp = j_vis.draw_graph_batch(pts, src, dst, ns, ne,
                                    str(tmp_path / f"j_{layout}"), layout)
        tp = t_vis.draw_graph_batch(pts, src, dst, ns, ne,
                                    str(tmp_path / f"t_{layout}"), layout)
        assert [Path(p).name[2:] for p in tp] == \
            [Path(p).name[2:] for p in jp]
        for a, b in zip(tp, jp):
            assert np.array_equal(_pixels(a), _pixels(b))
