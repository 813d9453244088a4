"""The coverage map (`fpmatch_tpu_torch/COVERAGE.md`) against the two
packages: every public top-level function and class of `fpmatch_tpu/`,
every file of the root `scripts/` and the root `bench.py` has a row, and
every counterpart a row names exists in the port. Parsed with `ast`; nothing
is imported."""
import ast
import functools
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MAP = ROOT / "fpmatch_tpu_torch" / "COVERAGE.md"
ROW = re.compile(r"^\| `([^`]+)` \| (.+) \|$")


@functools.cache
def rows():
    out = {}
    for line in MAP.read_text().splitlines():
        m = ROW.match(line)
        if m:
            assert m.group(1) not in out, f"two rows for {m.group(1)}"
            out[m.group(1)] = m.group(2).strip()
    return out


@functools.cache
def top_level(path: Path, public: bool):
    tree = ast.parse(path.read_text())
    names = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))}
    if public:
        return {n for n in names if not n.startswith("_")}
    for n in tree.body:
        if isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
    return names


@functools.cache
def jax_names():
    pkg = ROOT / "fpmatch_tpu"
    return {f"fpmatch_tpu/{p.relative_to(pkg).as_posix()}::{n}"
            for p in sorted(pkg.rglob("*.py"))
            for n in top_level(p, public=True)}


def test_every_public_jax_name_has_a_row():
    missing = sorted(jax_names() - set(rows()))
    assert not missing, f"public names without a row: {missing}"


def test_every_tool_has_a_row():
    tools = {f"scripts/{p.name}" for p in (ROOT / "scripts").iterdir()
             if p.is_file()} | {"bench.py"}
    missing = sorted(tools - set(rows()))
    assert not missing, f"tools without a row: {missing}"


def test_no_row_names_something_that_is_not_there():
    stale = sorted(k for k in rows() if "::" in k and k not in jax_names())
    stale += sorted(k for k in rows()
                    if "::" not in k and not (ROOT / k).is_file())
    assert not stale, f"rows for names that do not exist: {stale}"


@pytest.mark.parametrize("kind", ["name", "file"])
def test_every_counterpart_exists(kind):
    bad = []
    for jax_name, cell in rows().items():
        if cell.startswith("no port"):
            assert "\n" not in cell and len(cell) > len("no port: ")
            continue
        m = re.fullmatch(r"`([^`]+)`", cell)
        assert m, f"{jax_name}: neither a counterpart nor a reason: {cell}"
        target = m.group(1)
        if kind == "name" and "::" in target:
            path, name = target.split("::")
            assert path.startswith("fpmatch_tpu_torch/"), target
            if not ((ROOT / path).is_file()
                    and name in top_level(ROOT / path, public=False)):
                bad.append(f"{jax_name} -> {target}")
        elif kind == "file" and "::" not in target:
            path, *flags = target.split()
            text = (ROOT / path).read_text() if (ROOT / path).is_file() \
                else None
            if text is None or any(f not in text for f in flags):
                bad.append(f"{jax_name} -> {target}")
    assert not bad, f"counterparts that the port does not have: {bad}"


def test_the_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for p in sorted((ROOT / "fpmatch_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{p.relative_to(ROOT)}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                           "fpmatch_tpu")]
    assert not bad, bad
