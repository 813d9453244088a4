"""What a run loads: no JAX and no module of the JAX package (top-level
names compared whole), and a reference that imports nothing of the
program."""
import subprocess
import sys

from perfbench import harness

CHECK = """
import sys
sys.path.insert(0, {root!r})
sys.argv = ["run.py"]
import runpy
mod = runpy.run_path({run!r}, run_name="perfbench_run")
import perfbench.tasks.evaluate, perfbench.tasks.train, perfbench.trace
import perfbench.reference.model, perfbench.counts.model
import fpmatch_tpu_torch.cli.evaluate, fpmatch_tpu_torch.models.ngm
import fpmatch_tpu_torch.train.step, fpmatch_tpu_torch.train.state
import fpmatch_tpu_torch.kernels.assoc_bucket
import fpmatch_tpu_torch.kernels.assoc_grad
from perfbench import harness
for name in {metrics!r}:
    harness.metric_reader(name)
print(",".join(harness.forbidden_modules()))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import perfbench.reference.model
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] == "fpmatch_tpu_torch")))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


def test_a_run_loads_no_jax():
    metrics = [m["name"] for m in harness.manifest()["per_layer"]]
    found = _run(CHECK.format(root=str(harness.ROOT),
                              run=str(harness.HERE / "run.py"),
                              metrics=metrics))
    assert found == "", found


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    import types

    import fpmatch_tpu_torch  # noqa: F401  (a name that starts with one)

    monkeypatch.delitem(sys.modules, "fpmatch_tpu", raising=False)
    assert "fpmatch_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("x"))
    assert "jaxlib" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    assert _run(REFERENCE.format(root=str(harness.ROOT))) == ""


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    """Only BENCHMARK.json and perfbench/: the run exits non-zero and
    prints no result line (the card check comes first here, so the
    program check is called directly as well)."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "resnet18.eval-n64", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout
    check = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.');"
         "from perfbench import harness; harness.check_program()"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert check.returncode != 0 and "not in the checkout" in check.stderr
