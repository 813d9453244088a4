"""The port's own spans (`fpmatch_tpu_torch/utils/profiling.span`) on a tiny
CPU model under `torch.profiler` (CPU activity): which spans the eval loop,
the train step and `NGMNet._forward` open, how they nest, their `args`, the
`.backward` suffix inside a backward, that nothing of the profiler is
touched while no profiler records, and the benchmark's four idle-share
readers that read the spans' gaps."""
import itertools
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fpmatch_tpu_torch.cli.evaluate import evaluate_loader
from fpmatch_tpu_torch.core.config import default_stages
from fpmatch_tpu_torch.models.ngm import PairBatch, build_model
from fpmatch_tpu_torch.train.state import create_state
from fpmatch_tpu_torch.train.step import make_train_step
from fpmatch_tpu_torch.utils import profiling
from perfbench import harness
from perfbench.tests.tiny import tiny_cell
from perfbench.traffic.generator import make_pool

LAYERS = ("evaluate.", "train_step", "step.", "ngm.", "op.")
STAGES = ("ngm.input", "ngm.backbone", "ngm.align", "ngm.spline",
          "ngm.affinity", "ngm.gnn_0", "ngm.gnn_1", "ngm.gnn_2",
          "ngm.assignment", "ngm.afau", "ngm.assignment", "ngm.match_cls",
          "ngm.losses")
FORWARD = list(STAGES) + ["step.loss"]


@pytest.fixture(scope="module")
def tiny():
    """A tiny ResNet-18 NGM on the CPU and two batches of three pairs."""
    cell = tiny_cell("resnet18.train-s3", batch=3)
    cfg = harness.port_config(cell.config, cell.traffic)
    weights = harness.make_weights(harness.model_shapes(cfg), 11, "cpu")
    pool = make_pool(dict(cell.traffic, pool=2), 3, 11, "cpu")
    return cfg, weights, [PairBatch(**b) for b in pool]


def fresh(tiny):
    cfg, weights, batches = tiny
    return build_model(cfg, device="cpu", state_dict=weights), batches


@pytest.fixture
def args_of(monkeypatch):
    """Every (name, args) a span or backward_spans asks of the profiler."""
    seen = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return seen


def ours(name):
    return name.startswith(LAYERS)


def tree(prof):
    """[(depth among the program's spans, name)] of the program's spans, in
    the order they opened (one thread: the CPU's backward runs on the
    calling thread)."""
    events = sorted((e for e in prof.events() if ours(e.name)),
                    key=lambda e: e.time_range.start)
    out = []
    for e in events:
        depth, p = 0, e.cpu_parent
        while p is not None:
            depth += ours(p.name)
            p = p.cpu_parent
        out.append((depth, e.name))
    return out


def children(rows, at):
    """Names of the direct children of the span at index `at` of `rows`."""
    depth, out = rows[at][0], []
    for d, name in rows[at + 1:]:
        if d <= depth:
            break
        if d == depth + 1:
            out.append(name)
    return out


@pytest.mark.parametrize("discretize", ["greedy", "hungarian"])
def test_evaluate_loader_spans(tiny, args_of, discretize):
    model, batches = fresh(tiny)
    kept = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = evaluate_loader(model, batches, discretize=discretize,
                              on_batch=lambda bi, b, out: kept.append(bi))
    assert kept == [0, 1] and len(res["batch_seconds"]) == 2
    rows = tree(prof)
    top = [(i, name) for i, (d, name) in enumerate(rows) if d == 0]
    per_batch = ["evaluate.load", "evaluate.step"] + (
        ["evaluate.hungarian"] if discretize == "hungarian" else []) + [
        "evaluate.on_batch", "evaluate.fetch"]
    assert [name for _, name in top] == 2 * per_batch + [
        "evaluate.load", "evaluate.report"]
    for i, name in top:
        if name in ("evaluate.step", "evaluate.hungarian"):
            assert children(rows, i) == FORWARD
        else:
            assert children(rows, i) == []
    # the batch index is every per-batch span's argument
    got = [(n, a) for n, a in args_of if n.startswith("evaluate.")]
    want = [(n, str(bi)) for bi in (0, 1) for n in per_batch] + [
        ("evaluate.load", "2"), ("evaluate.report", None)]
    assert got == want


def test_train_step_spans(tiny, args_of):
    model, batches = fresh(tiny)
    stage = default_stages()[0]             # remat Sinkhorns, clipping
    assert model.cfg.ngm.remat_sinkhorn and stage.grad_clip is not None
    state = create_state(model, stage)
    state.step = 41
    step = make_train_step(model, stage)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, batches[0])
    assert state.step == 42
    rows = tree(prof)
    assert rows[0] == (0, "train_step")
    assert all(d >= 1 for d, _ in rows[1:])
    assert children(rows, 0) == FORWARD + [
        "train_step.backward", "train_step.clip", "train_step.optimizer"]
    assert ("train_step", "41") in args_of
    back = next(i for i, r in enumerate(rows)
                if r[1] == "train_step.backward")
    inside = [name for d, name in rows[back + 1:] if d > rows[back][0]]
    assert inside and all(n.endswith(".backward") for n in inside)
    # remat's recompute of the final Sinkhorn and of the soft top-k, and the
    # association's dX and K6, each inside the backward
    for name in ("op.sinkhorn.backward", "op.soft_topk.backward",
                 "op.assoc.backward", "op.assoc_grad.backward"):
        assert name in inside, name
    # after the backward, no suffix
    assert profiling._suffix == ""
    assert not any(n.endswith(".backward") for _, n in rows[:back])


@pytest.mark.parametrize("train", [False, True])
def test_every_forward_op_lies_in_one_stage(tiny, train):
    model, batches = fresh(tiny)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.forward"):
            model(batches[0], train=train)
    ops = 0
    for e in prof.events():
        if e.name == "test.forward" or ours(e.name):
            continue
        names, p = [], e.cpu_parent
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        if "test.forward" not in names:
            continue
        ops += 1
        stages = [n for n in names if n.startswith("ngm.")]
        assert len(stages) == 1, (e.name, names)
    assert ops > 100


def test_nothing_of_the_profiler_without_one(tiny, monkeypatch):
    """With no profiler recording, neither a span nor the backward's hook
    reaches the profiler: a forward, a train step and evaluate_loader run
    with `record_function` and `register_hook` raising."""
    model, batches = fresh(tiny)
    stage = default_stages()[0]
    state = create_state(model, stage)
    step = make_train_step(model, stage)

    def boom(*a, **k):
        raise AssertionError("the profiler was touched")

    # the program's route to the profiler (torch's optimizers open their
    # own ranges through `torch.autograd.profiler`, which stays)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.Tensor, "register_hook", boom)
    assert profiling.span("ngm.input") is profiling.span("op.greedy", "1")
    model(batches[0])
    step(state, batches[0])
    evaluate_loader(model, batches[:1])


def test_backward_spans_opens_on_the_engine_thread(monkeypatch):
    """Where the engine runs the backward on a thread of its own (a CUDA
    graph), the hook on the root opens the span there and the engine's
    final callback closes it. The CPU's engine runs on the calling thread,
    so the test makes the hook see another thread id."""
    ids = itertools.count()
    monkeypatch.setattr(profiling, "threading",
                        types.SimpleNamespace(get_ident=lambda: next(ids)))
    x = torch.randn(64, requires_grad=True)
    total = (x.exp() * 2).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.backward_spans(total, "t.backward"):
            with profiling.span("op.x"):
                total.backward()
    spans = [e for e in prof.events() if e.name in ("t.backward",
                                                    "op.x.backward")]
    assert sorted(e.name for e in spans) == ["op.x.backward", "t.backward",
                                             "t.backward"]
    outer, inner = sorted((e for e in spans if e.name == "t.backward"),
                          key=lambda e: e.time_range.start)
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert inner.time_range.end > inner.time_range.start
    assert torch.allclose(x.grad, 2 * x.exp())


def trace_ctx(gaps, by_range=None, window_s=2.0):
    return {"trace": {"gaps": gaps, "by_range": by_range or {},
                      "window_s": window_s, "busy_s": 1.0}, "work": {}}


@pytest.mark.parametrize("metric,gaps,want", [
    ("eval.batch_boundary_idle_share",
     {"evaluate.load": 0.01, "evaluate.on_batch": 0.02,
      "evaluate.fetch": 0.03, "evaluate.report": 0.04, "ngm.input": 0.1,
      "op.sinkhorn": 0.5, "perfbench.window": 0.3}, 10.0),
    ("eval.loop_idle_share",
     {"op.sinkhorn": 0.1, "op.soft_topk": 0.2, "op.greedy": 0.3,
      "op.sinkhorn.backward": 0.4, "ngm.input": 0.5}, 30.0),
    ("train.step_glue_idle_share",
     {"train_step": 0.1, "step.loss": 0.2, "train_step.clip": 0.3,
      "train_step.grad_sync": 0.4, "train_step.backward": 0.5}, 50.0),
    ("train.backward_idle_share",
     {"train_step.backward": 0.1, "op.sinkhorn.backward": 0.2,
      "op.assoc_grad.backward": 0.3, "autograd backward (other thread)": 0.2,
      "train_step": 0.5, "op.sinkhorn": 0.7}, 40.0),
])
def test_idle_share_readers(metric, gaps, want):
    reader = harness.metric_reader(metric)
    assert (reader.LAYER, reader.UNIT) == ("host dispatch", "%")
    assert reader.read(trace_ctx(gaps)) == pytest.approx(want)
    # a span with device work but no gap reads 0, not None
    only = {n: 1.0 for n in gaps if n.startswith(("evaluate.", "op.",
                                                  "train_step"))}
    assert reader.read(trace_ctx({}, by_range=only)) == 0.0
    # no trace, or a program without the spans (the benchmark's own
    # names only): no reading
    assert reader.read({"trace": None, "work": {}}) is None
    assert reader.read(trace_ctx({"perfbench.window": 0.3,
                                  "ngm.forward": 0.2,
                                  "autograd backward (other thread)": 0.1},
                                 {"ngm.backbone": 1.0})) is None
