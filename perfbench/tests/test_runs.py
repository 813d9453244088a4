"""Whole runs of the benchmark's cells at test widths on the CPU (the look
for a card skipped): the result line's shape, and `correct` coming out
false under the control and under each fault the cells can have, planted
in the program underneath the timed path."""
import json

import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 17


def run_cell(name, control=None, **kw):
    return run.run_once(name, SEED, 0.5, False, control=control,
                        device="cpu", cell=tiny_cell(name, **kw))


@pytest.mark.parametrize("name", ["resnet18.eval-n64", "resnet18.train-s3"])
def test_result_line(name):
    line = run_cell(name)
    line.pop("_numbers"), line.pop("_setup_s")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    e2e = "pairs_per_s" if "eval" in name else "train_pairs_per_s"
    assert set(line["metrics"]) == {e2e, "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line)


@pytest.mark.parametrize("name", ["resnet18.eval-n64", "resnet18.train-s3"])
def test_control_is_not_correct(name):
    """The program's own bfloat16 path in place of float32."""
    line = run_cell(name, control="bf16")
    assert line["correct"] is False, line["checks"]


def altered_eval_step(monkeypatch, how):
    from fpmatch_tpu_torch.train import step as step_mod

    real = step_mod.make_eval_step

    def make(model, stage, **kw):
        inner = real(model, stage, **kw)

        def eval_step(batch):
            if how == "half":
                # half of the batch left out: its outputs are the other
                # half's
                half = batch.batch_size // 2 or 1
                sub = type(batch)(*(a[:half] if torch.is_tensor(a) else a
                                    for a in batch))
                metrics, out = inner(sub)
                reps = -(-batch.batch_size // half)
                return metrics, {k: v.repeat(reps, *([1] * (v.dim() - 1)))
                                 [:batch.batch_size] for k, v in out.items()}
            metrics, out = inner(batch)
            out = dict(out)
            if how == "pick":
                # every pair's picks shifted by a row: still one a row and
                # a column, each on another entry
                p = out["perm_mat"].clone()
                for b in range(p.shape[0]):
                    rows = p[b].sum(1).nonzero().flatten()
                    cols = p[b][rows].argmax(1)
                    p[b][rows] = 0
                    p[b][rows, cols.roll(1)] = 1
                out["perm_mat"] = p
                return metrics, out
            out["k_prob"] = out["k_prob"].clone()
            out["k_prob"][0] = 1.0 - out["k_prob"][0]   # one answer altered
            return metrics, out
        return eval_step
    monkeypatch.setattr(step_mod, "make_eval_step", make)


@pytest.mark.parametrize("how", ["altered", "half", "pick"])
def test_eval_faults_are_not_correct(monkeypatch, how):
    altered_eval_step(monkeypatch, how)
    line = run_cell("resnet18.eval-n64", batch=4)
    assert line["correct"] is False, line["checks"]
    if how == "pick":
        pick = line["checks"]["pick_gap_p99"]
        assert pick["value"] > pick["limit"], pick


def test_train_state_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    line = run_cell("resnet18.train-s3")
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["change_gap_median"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct(monkeypatch):
    from fpmatch_tpu_torch.train import step as step_mod

    real = step_mod.loss_and_metrics

    def half(model, batch, stage, **kw):
        h = batch.batch_size // 2
        sub = type(batch)(*(a[:h] if torch.is_tensor(a) else a
                            for a in batch))
        return real(model, sub, stage, **kw)
    monkeypatch.setattr(step_mod, "loss_and_metrics", half)
    line = run_cell("resnet18.train-s3", batch=4)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("how", ["no-update", "stale-batch"])
def test_train_window_faults_are_not_correct(monkeypatch, how):
    """A step that goes wrong only once warmed up (as a step captured after
    its first calls could): from the fifth call on it updates nothing, or
    trains on the batch it last saw at set-up."""
    from fpmatch_tpu_torch.train import step as step_mod

    real = step_mod.make_train_step

    def make(model, stage, **kw):
        inner = real(model, stage, **kw)
        calls = []

        def train_step(state, batch):
            calls.append(batch)
            if len(calls) <= 4:
                return inner(state, batch)
            if how == "stale-batch":
                return inner(state, calls[3])
            real_step = state.optimizer.step
            state.optimizer.step = lambda closure=None: None
            try:
                return inner(state, batch)
            finally:
                state.optimizer.step = real_step
        return train_step
    monkeypatch.setattr(step_mod, "make_train_step", make)
    line = run_cell("resnet18.train-s3")
    assert line["correct"] is False, line["checks"]
    assert all(line["checks"][k]["value"] <= line["checks"][k]["limit"]
               for k in ("loss_gap", "grad_gap_median", "change_gap_median"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["resnet18.eval-n64", "vgg16bn.eval-n64",
                                  "resnet18.train-s3"])
def test_cells_on_the_card(card, name):
    """The real cells at their own size: correct as they are, not correct
    under the program's bfloat16 path and, in the eval cells, under its
    float32 matmuls in TF32 (on some seeds the training cell's numbers read
    as far from the configuration's own TF32 convolutions: `PERF.md` §6)."""
    ok = run.run_once(name, SEED, 3.0, False, device=card)
    assert ok["correct"] is True, ok["checks"]
    controls = ("bf16", "tf32") if "eval" in name else ("bf16",)
    for i, control in enumerate(controls, start=1):
        ctl = run.run_once(name, SEED + i, 3.0, False, control=control,
                           device=card)
        assert ctl["correct"] is False, (control, ctl["checks"])
