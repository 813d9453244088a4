"""The port's tools (`fpmatch_tpu_torch/scripts/`) on the CPU, at tiny
widths (`test_torch_utils.build_tiny`) and small sizes: each runs end to
end and prints one JSON line of the documented keys, and where a JAX tool
gives the same numbers, they are held against it:

  * `profile_train_step`, `bench_edge_partition` (emulated ranks, and two
    real gloo ranks), `bench_cli_mesh_scaling` (N = 1 through a child
    process), `matching_recall_report` on a checkpoint written here;
  * `hard_impostor_report` against the JAX script's JSON on the same
    `scores.csv`, with and without a `siblings.json`;
  * `extend_polyu_mini` against the committed fixture (pixels and TSV
    text), `scripts/make_synthetic_v2_torch.sh` against the JAX recipe.

On the card `chip_smoke.py` runs them at their real sizes (phases 30-34).
"""
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fpmatch_tpu_torch.core.config import Config
from fpmatch_tpu_torch.data.generator import generate_synthetic_dataset
from fpmatch_tpu_torch.models.ngm import build_model
from fpmatch_tpu_torch.ops.assoc import assoc_matvec_auto
from fpmatch_tpu_torch.scripts import (bench_cli_mesh_scaling,
                                       bench_edge_partition,
                                       extend_polyu_mini,
                                       hard_impostor_report,
                                       matching_recall_report,
                                       profile_train_step)
from fpmatch_tpu_torch.train.checkpoints import save_checkpoint
from test_torch_utils import (build_tiny, tiny_jax_config, tiny_widths,
                              to_torch_config)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "PolyU-mini" / "DBII" / "val"
KERNELS = {"assoc_univ_v3", "assoc_bucket", "assoc_large", "assoc_grad"}


def last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_profile_train_step_on_the_cpu(monkeypatch, capsys):
    """Every variant, and the ablations each on a fresh model (two of them
    run here; the list is the JAX profiler's): host times of the CPU and no
    device number."""
    abl = profile_train_step.ablations(Config())
    assert list(abl) == ["no remat_sinkhorn", "sk_iter ->5",
                         "sk_layer_iter ->5", "topk_extra_iter ->2",
                         "no AFA-U (regression off)", "backbone bf16"]
    base = Config()
    assert not abl["no remat_sinkhorn"].ngm.remat_sinkhorn
    assert abl["sk_iter ->5"] == base.replace(
        ngm=dataclasses.replace(base.ngm, sk_iter=5))
    assert not abl["no AFA-U (regression off)"].ngm.regression
    assert abl["backbone bf16"].backbone.dtype == "bfloat16"
    monkeypatch.setattr(profile_train_step, "ablations",
                        lambda cfg: dict(list(abl.items())[:2]))
    built = build_tiny(monkeypatch)
    real = profile_train_step.run
    monkeypatch.setattr(profile_train_step, "run",
                        lambda *a: real(*a, batch_size=1))
    out = profile_train_step.main(["--device", "cpu", "--steps", "1",
                                   "--profile-steps", "1"])
    assert last_json(capsys) == json.loads(json.dumps(out))
    assert len(built) == 3
    assert list(out["variants"]) == [
        "forward_eval", "forward_train", "forward_backward",
        "optimizer_step", "train_step", "train_step [no remat_sinkhorn]",
        "train_step [sk_iter ->5]"]
    for row in out["variants"].values():
        assert len(row["ms"]) == 1 and row["median_ms"] > 0
        assert row["pairs_per_s"] == pytest.approx(1e3 / row["median_ms"])
        assert row["device_busy_ms"] is None and row["idle_share"] is None
        assert set(row["wrapper_launches"]) == KERNELS
        assert not any(row["wrapper_launches"].values())  # plain on the CPU
    assert out["stage"] == "stage3" and out["card"] is None
    v = {k: r["median_ms"] for k, r in out["variants"].items()}
    assert out["split_ms"] == {
        "forward": v["forward_train"],
        "backward": v["forward_backward"] - v["forward_train"],
        "optimizer": v["optimizer_step"]}


def test_bench_edge_partition_emulated_on_the_cpu(monkeypatch, capsys):
    real = bench_edge_partition.run
    monkeypatch.setattr(bench_edge_partition, "run",
                        lambda device, reps: real(device, 48, 4, reps))
    out = bench_edge_partition.main(["--device", "cpu", "--reps", "1"])
    assert last_json(capsys)["assoc_edges"] == out["e1"] * out["e2"] + 48 ** 2
    for p in (2, 4, 8):
        row = out[f"p{p}"]
        assert row["mode"] == "emulated" and len(row["rank_ms"]) == p
        assert row["max_rel_err_vs_single"] <= 1e-5
        assert 0 < row["halo_fraction_vs_replication"] < 1
        assert row["halo_bytes_per_layer"] == \
            row["halo_rows_per_layer"] * 48 * 4 * 4
        assert set(row["overlap_proxy"]) == {
            "t_full_ms", "t_exchange_only_ms", "t_local_plus_zero_halo_ms",
            "overlap_evidence"}
    with pytest.raises(ValueError):
        real("cpu", 44, 4, 1)


def test_bench_edge_partition_over_two_gloo_ranks():
    """The real-rank path (spawned ranks, one halo all_to_all each) on the
    CPU, against one device: `row_sharded_matvec` with its tight plan
    (p s_max < the rows a rank owns), and a result larger than a pipe's
    buffer handed back from rank 0."""
    n, c = 48, 16
    row, y = bench_edge_partition.ranks_case(2, "cpu", n, c, 1)
    assert n * n * c * 4 > 2 ** 16  # more than a pipe's buffer holds
    assert row["mode"] == "ranks" and len(row["rank_ms"]) == 2
    X, Kp, Ke, s1, d1, s2, d2 = bench_edge_partition.make_inputs(n, c)
    plan = bench_edge_partition.ep.plan_row_shards(n, s1, d1, 2,
                                                   transpose=True)
    assert 2 * plan.s_max < plan.rows_per
    want = assoc_matvec_auto(*(torch.as_tensor(a)[None] for a in
                               (X, Kp, Ke, s1, d1, s2, d2)),
                             transpose=True)[0]
    assert bench_edge_partition.relerr(torch.as_tensor(y), want) <= 1e-5


# cli.train in a child process with the model at tiny widths, on two
# threads (the test workers share the host's cores)
SHIM = """
import dataclasses, sys
import torch
torch.set_num_threads(2)
from fpmatch_tpu_torch.models import ngm
real = ngm.build_model
def tiny(cfg, *a, **k):
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, **{backbone!r}),
        ngm=dataclasses.replace(cfg.ngm, **{ngm!r}))
    return real(cfg, *a, **k)
ngm.build_model = tiny
from fpmatch_tpu_torch.cli.train import main
main(sys.argv[1:])
"""


def test_bench_cli_mesh_scaling_on_the_cpu(capsys):
    tiny = to_torch_config(tiny_jax_config())
    keep = ("dtype", "node_taps", "kind", "remat", "node_channels",
            "edge_channels")
    shim = SHIM.format(
        backbone={k: v for k, v in dataclasses.asdict(tiny.backbone).items()
                  if k not in keep},
        ngm={k: v for k, v in dataclasses.asdict(tiny.ngm).items()
             if k in ("node_feature_dim", "global_state_dim", "gnn_feat",
                      "sk_iter", "sk_layer_iter", "topk_extra_iter",
                      "afa_reg_hidden")})
    out = bench_cli_mesh_scaling.main(["--device", "cpu"],
                                      command=[sys.executable, "-c", shim])
    assert last_json(capsys) == out
    assert list(out["runs"]) == ["1"] and set(out["left_out"]) == {"2", "4"}
    one = out["runs"]["1"]
    assert one["pairs_per_s"] > 0 and one["ms_per_step"] > 0
    assert one["speedup"] == one["efficiency"] == 1.0


def test_matching_recall_report_on_the_cpu(tmp_path, monkeypatch, capsys):
    """A checkpoint in the port's format, a small split, every genuine
    test pair counted once, the means of the per-pair values."""
    root = tmp_path / "Synthetic"
    generate_synthetic_dataset(str(root), fingers_per_split=(2, 3, 2),
                               n_pores=30, seed=0, size=(200, 180))
    args = matching_recall_report.build_parser().parse_args(
        ["--node-taps", "layer3"])
    model = build_model(tiny_widths(matching_recall_report.model_config(
        args)), device="cpu", seed=1)
    save_checkpoint(str(tmp_path / "ckpt"), "stage6_last", model)
    built = build_tiny(monkeypatch)
    out = matching_recall_report.main(
        ["--data-root", str(root), "--checkpoint-dir",
         str(tmp_path / "ckpt"), "--node-taps", "layer3",
         "--thread-workers", "--device", "cpu"])
    assert last_json(capsys) == out
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in built[0][1].state_dict().items())
    r, p = (np.asarray(out["per_pair"][k]) for k in ("recall", "precision"))
    assert out["n_genuine_pairs"] == len(r) == len(p) > 0
    assert out["matching_recall"] == pytest.approx(r.mean())
    assert out["matching_precision"] == pytest.approx(p.mean())
    assert ((0 <= r) & (r <= 1)).all() and ((0 <= p) & (p <= 1)).all()
    assert out["checkpoint"].endswith(":stage6_last")


def jax_hard_impostor_main():
    spec = importlib.util.spec_from_file_location(
        "jax_hard_impostor_report", ROOT / "scripts" /
        "hard_impostor_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("sidecar", [False, True])
def test_hard_impostor_report_matches_the_jax_script(tmp_path, monkeypatch,
                                                     capsys, sidecar):
    """Genuine pairs, sibling-partner impostors (f0300..f0302 of f0100..
    f0102 by the offset rule; in the sidecar case only two of them are
    listed) and other impostors, scores from a seed."""
    rng = np.random.default_rng(4)
    rows = []
    for p in range(100, 106):
        rows.append((f"R4/f{p:04d}_1_1", f"R4/f{p:04d}_2_1", 1,
                     rng.uniform(0.4, 1.0)))
        rows.append((f"R4/f{p:04d}_1_1", f"R4/f{p + 1:04d}_1_1", 0,
                     rng.uniform(0.0, 0.6)))
        if p < 103:
            rows.append((f"R4/f{p:04d}_1_2", f"R4/f{p + 200:04d}_2_2", 0,
                         rng.uniform(0.2, 0.9)))
    csv = tmp_path / "scores.csv"
    csv.write_text("id_a,id_b,label,score,cls_prob,k_prob\n" + "".join(
        f"{a},{b},{lab},{s:.6f},0.5,0.5\n" for a, b, lab, s in rows))
    side = tmp_path / "siblings.json"
    if sidecar:
        side.write_text(json.dumps({"f0300": "f0100", "f0301": "f0101"}))
    argv = [str(csv), "--siblings-json", str(side)]
    monkeypatch.setattr(sys, "argv", ["hard_impostor_report.py", *argv])
    jax_hard_impostor_main()()
    want = last_json(capsys)
    got = hard_impostor_report.main(argv)
    assert last_json(capsys) == got == want
    assert got["n_sibling_impostors"] == (2 if sidecar else 3)


def test_extend_polyu_mini_writes_the_committed_fixture(tmp_path, capsys):
    import cv2

    out = extend_polyu_mini.main(["--out", str(tmp_path)])
    assert last_json(capsys) == out and len(out["pores"]) == 4
    for name in out["pores"]:
        got = cv2.imread(str(tmp_path / f"{name}.png"), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(FIXTURE / f"{name}.png"), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint8 and got.shape == (96, 96)
        assert np.array_equal(got, want), name
        assert (tmp_path / f"{name}.tsv").read_text() == \
            (FIXTURE / f"{name}.tsv").read_text()
    default = extend_polyu_mini.main([])
    assert "fixtures" not in default["out"]


def test_make_synthetic_v2_torch_runs_the_jax_recipe_on_the_port():
    """The same three generator calls, through the port's generator."""
    def calls(name, module):
        text = (ROOT / "scripts" / name).read_text().replace("\\\n", " ")
        return [re.sub(r"\s+", " ", line.split(module, 1)[1]).strip()
                for line in text.splitlines() if module in line]

    jax = calls("make_synthetic_v2.sh", "python -m fpmatch_tpu.data.generator")
    port = calls("make_synthetic_v2_torch.sh",
                 "python -m fpmatch_tpu_torch.data.generator")
    assert len(port) == 3 and port == jax
