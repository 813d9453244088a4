"""What every run shares: the manifest and a cell's files, the program's
configuration, the weights made from the seed, the guards, and the result
line.

A cell is found by name: `BENCHMARK.json`'s `workloads` entry names its
configuration (`configs/<config>.json`) and traffic (`traffic/<traffic>.json`),
and `workloads/<cell>.json` holds what is the cell's own (its batch, the
limits of its comparison). The traffic's `task` picks the driver in
`tasks/`. Per-layer metrics are read by `metrics/<metric>.py`.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fpmatch_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a file missing)."""


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # the BENCHMARK.json workloads entry
    spec: dict            # workloads/<cell>.json
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # names of the end-to-end metrics it reports
    per_layer: list       # names of the per-layer metrics it reports


def reports(metric: dict, cell: str, man: dict) -> bool:
    """Whether `cell` reports `metric`: it is listed, or the metric lists
    no cells (an end-to-end metric: every cell; a per-layer metric: every
    cell that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in man["end_to_end"]
                     if m["name"] == metric["moves"])
        return reports(moved, cell, man)
    return True


def load_cell(name: str, man: dict = None) -> Cell:
    man = man or manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next((c for c in man["configs"] if c["name"] == entry["config"]),
               None)
    if cfg is None:
        raise BenchError(f"no config {entry['config']!r} in BENCHMARK.json")
    return Cell(
        name=name, entry=entry,
        spec=read_json(HERE / "workloads" / f"{name}.json"),
        config=read_json(ROOT / cfg["file"]),
        traffic=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m["name"] for m in man["end_to_end"]
                    if reports(m, name, man)],
        per_layer=[m["name"] for m in man["per_layer"]
                   if reports(m, name, man)])


def metric_reader(name: str):
    """The module `metrics/<name>.py` (file names keep the metric's dots)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(config: dict, traffic: dict):
    """The program's `Config` for a configuration file and a traffic file
    (the shape buckets are the traffic's)."""
    from fpmatch_tpu_torch.core.config import (BackboneConfig, Config,
                                               DataConfig, NGMConfig,
                                               ShapeConfig)

    def make(cls, values):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in values.items() if k in names})

    return Config(
        shapes=make(ShapeConfig, dict(config["shapes"],
                                      n_max=traffic["n_max"],
                                      e_max=traffic["e_max"])),
        backbone=make(BackboneConfig, config["backbone"]),
        ngm=make(NGMConfig, config["ngm"]),
        data=make(DataConfig, config["data"]))


def make_weights(shapes, seed: int, device) -> dict:
    """Every tensor of the model's `state_dict` from `seed`, made on
    `device` in three draws (normal, uniform, uniform(-10, 10) for AFA-U's
    score-mixing MLPs) and scaled per tensor by the JAX package's init:
    fan-in-scaled normal weights, fan-in-scaled uniform spline kernels, zero
    biases, unit scales, fresh batch-norm statistics. `shapes`: an ordered
    {name: shape} of the state_dict."""
    import torch

    kinds, sizes = {}, {"normal": 0, "spline": 0, "mix": 0}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        numel = math.prod(shape)
        if leaf.startswith("mix"):
            kind = "mix"
        elif leaf in ("running_mean", "num_batches_tracked") \
                or leaf == "bias" or leaf.endswith("_bias"):
            kind = "zeros"
        elif leaf == "running_var" or leaf.endswith("_scale") \
                or (leaf == "weight" and len(shape) == 1):
            kind = "ones"
        elif leaf.startswith("conv") and leaf.endswith(("_weight", "_root")):
            kind = "spline"
        else:
            kind = "normal"
        kinds[name] = kind
        if kind in sizes:
            sizes[kind] += numel
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    draws = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "spline": torch.rand(sizes["spline"], generator=gen,
                                  device=device) * 2 - 1,
             "mix": torch.rand(sizes["mix"], generator=gen,
                               device=device) * 20 - 10}
    offs = {k: 0 for k in draws}
    out = {}
    for name, shape in shapes.items():
        kind = kinds[name]
        if kind == "zeros":
            dtype = torch.long if name.endswith("num_batches_tracked") \
                else torch.float32
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
            continue
        n = math.prod(shape)
        t = draws[kind][offs[kind]:offs[kind] + n].view(shape)
        offs[kind] += n
        if kind == "normal":
            t = t * (1.0 / math.prod(shape[1:])) ** 0.5
        elif kind == "spline":
            fan_in = shape[-2] * (shape[0] if len(shape) == 3 else 1)
            t = t * (1.0 / fan_in) ** 0.5
        out[name] = t.clone()
    return out


def model_shapes(cfg) -> dict:
    """{name: shape} of the program's model state_dict, built on the meta
    device (no memory, no init)."""
    import torch
    from fpmatch_tpu_torch.models.ngm import NGMNet

    with torch.device("meta"):
        model = NGMNet(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_program() -> None:
    """The program measured is the checkout's own `fpmatch_tpu_torch`."""
    try:
        import fpmatch_tpu_torch
    except ImportError as e:
        raise BenchError(f"the program is not in the checkout: {e}")
    if ROOT not in Path(fpmatch_tpu_torch.__file__).resolve().parents:
        raise BenchError(f"fpmatch_tpu_torch imported from "
                         f"{fpmatch_tpu_torch.__file__}, not from {ROOT}")


def check_device(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is False: the benchmark "
                         "runs on a CUDA card only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} card(s), "
                         f"{torch.cuda.device_count()} visible")


def device_record(trace: dict = None) -> dict:
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    if trace is not None:
        rec.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return rec


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card (for the log)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
