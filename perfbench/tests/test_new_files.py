"""A configuration that arrives as new files only: its own plain reference
(`reference/<config>.py`), traffic with `t_max`, a cell and a metric
reader, written into a copy of the manifest under a temporary directory
(the harness's paths pointed there) and run at test widths on the CPU. No
file of `perfbench/` is touched for it."""
import json

import pytest

from perfbench import harness, run
from perfbench.tests.tiny import TINY_TRAFFIC, tiny_cell, tiny_config

SEED = 2 ** 31 + 23
CONFIG, TRAFFIC, CELL = "ngm-tiny-tri", "eval-tri", "tiny-tri.eval"
METRIC = "eval.triangles_per_pair"

# the configuration's own reference: model.py's functions, its forward
# marking each call (and what the batch held) in a file beside it
OWN_REFERENCE = '''
import json
from pathlib import Path

from perfbench.reference.model import *  # noqa: F401,F403
from perfbench.reference import model as _model

MARK = Path(__file__).with_suffix(".calls")


def forward(weights, cfg, batch, *args, **kw):
    with MARK.open("a") as f:
        f.write(json.dumps(sorted(batch)) + "\\n")
    out = _model.forward(weights, cfg, batch, *args, **kw)
    return dict(out, k_prob=out["k_prob"] + {shift!r})
'''

# a reader with its own count: the valid triangles of the window's pairs
READER = '''
LAYER = "graph"
MOVES = "pairs_per_s"
UNIT = "tris/pair"


def read(ctx):
    batches = ctx["work"].get("batches")
    if not ctx.get("trace") or not batches or "n_tris" not in batches[0]:
        return None
    tris = sum(b["runs"] * int(b["n_tris"].sum()) for b in batches)
    pairs = sum(b["runs"] * len(b["n_tris"]) for b in batches)
    return tris / pairs
'''


def write(path, text):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A checkout's manifest and benchmark files under `tmp_path` with the
    new configuration's files added; `tree(shift)` writes its reference
    (its k_prob moved by `shift`)."""
    base = harness.load_cell("resnet18.eval-n64")
    bench = tmp_path / "perfbench"
    man = harness.manifest()
    man["configs"].append({"name": CONFIG, "source": "https://example.org",
                           "file": f"perfbench/configs/{CONFIG}.json",
                           "reduced": [], "why": "test widths"})
    man["workloads"].append({"name": CELL, "config": CONFIG,
                             "traffic": TRAFFIC, "chips": 1,
                             "why": "test widths"})
    next(m for m in man["end_to_end"]
         if m["name"] == "pairs_per_s")["workloads"].append(CELL)
    man["per_layer"].append({"name": METRIC, "unit": "tris/pair",
                             "better": "higher", "source": "program_counter",
                             "layer": "graph", "moves": "pairs_per_s",
                             "workloads": [CELL]})
    write(tmp_path / "BENCHMARK.json", json.dumps(man))
    write(bench / "configs" / f"{CONFIG}.json",
          json.dumps(dict(tiny_config(base.config), name=CONFIG)))
    write(bench / "traffic" / f"{TRAFFIC}.json",
          json.dumps(dict(base.traffic, **TINY_TRAFFIC, t_max=24)))
    write(bench / "workloads" / f"{CELL}.json",
          json.dumps(dict(base.spec, batch=3, reference_pairs=3,
                          reference_block=2)))
    write(bench / "metrics" / f"{METRIC}.py", READER)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", bench)
    # the program is the real checkout's, not the temporary tree's
    monkeypatch.setattr(harness, "check_program", lambda: None)

    def with_reference(shift):
        write(bench / "reference" / f"{CONFIG}.py",
              OWN_REFERENCE.format(shift=shift))
        return bench / "reference" / f"{CONFIG}.calls"
    return with_reference


def test_cells_without_their_own_file_take_model_py():
    from perfbench.reference import model

    for name in ("resnet18.eval-n64", "vgg16bn.eval-n64",
                 "resnet18.train-s3"):
        assert harness.reference_module(harness.load_cell(name)) is model


def test_new_files_run_judged_by_their_own_reference(tree, monkeypatch):
    """The new cell runs and is correct, its reference is its own file,
    the program's forward gets the triangles, and the new reader counts
    them from `work["batches"]`."""
    from fpmatch_tpu_torch.models.ngm import NGMNet
    from perfbench.tasks import evaluate

    calls = tree(0.0)
    tris = []
    real_forward = NGMNet.forward

    def forward(self, batch, *args, **kw):
        tris.append((batch.tri.shape, batch.n_tris.clone()))
        return real_forward(self, batch, *args, **kw)
    monkeypatch.setattr(NGMNet, "forward", forward)
    works = []
    real_run = evaluate.run

    def task_run(*args, **kw):
        out = real_run(*args, **kw)
        works.append(out["work"])
        return out
    monkeypatch.setattr(evaluate, "run", task_run)

    line = run.run_once(CELL, SEED, 0.5, False, device="cpu")
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}
    marks = calls.read_text().splitlines()
    assert marks and all("tri" in json.loads(m) and "n_tris" in json.loads(m)
                         for m in marks)
    assert tris and all(shape == (3, 2, 24, 3) and int(n.min()) > 0
                        for shape, n in tris)

    reader = harness.metric_reader(METRIC)
    per_pair = reader.read({"trace": {"window_s": 1.0}, "work": works[0]})
    batches = works[0]["batches"]
    assert sum(b["runs"] for b in batches) * 3 == works[0]["pairs"]
    assert per_pair == pytest.approx(
        sum(b["runs"] * b["n_tris"].sum() for b in batches)
        / works[0]["pairs"])
    assert reader.read({"trace": None, "work": {}}) is None


def test_a_cell_is_judged_by_its_configurations_reference(tree):
    """The same cell under a reference whose k_prob is off by 0.5 comes
    out not correct: the file, not model.py, judged it."""
    calls = tree(0.5)
    line = run.run_once(CELL, SEED, 0.5, False, device="cpu")
    assert calls.is_file()
    assert line["correct"] is False
    assert line["checks"]["k_gap"]["value"] > 0.4


def test_the_eval_work_lists_the_windows_batches():
    """`work["batches"]` of an eval run without triangles: each pool
    slot's runs and counts, no `n_tris`."""
    from perfbench.tasks import evaluate

    cell = tiny_cell("resnet18.eval-n64")
    out = evaluate.run(cell, SEED, 0.3, False, device="cpu")
    batches = out["work"]["batches"]
    assert len(batches) == cell.traffic["pool"]
    assert sum(b["runs"] for b in batches) * 3 == out["work"]["pairs"]
    for b in batches:
        assert set(b) == {"runs", "n_nodes", "n_edges"}
        assert b["n_nodes"].shape == (3, 2)
    assert set(out["work"]["kernel_bound_s"]) == {"assoc_bucket_kernel",
                                                  "assoc_large_kernel"}
