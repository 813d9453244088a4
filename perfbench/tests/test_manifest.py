"""BENCHMARK.json against the contract's rules, and every file a name
points at."""
import json
import re

import pytest

from perfbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for entry in MAN["configs"] + MAN["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic["task"] in ("evaluate", "train")
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.spec["batch"] >= 1 and c.spec["limits"]
    for name in c.per_layer:
        harness.metric_reader(name)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_per_layer_reader_and_moves(metric):
    entry = next(m for m in MAN["per_layer"] if m["name"] == metric)
    reader = harness.metric_reader(metric)
    assert reader.LAYER == entry["layer"] and reader.MOVES == entry["moves"]
    assert reader.UNIT == entry["unit"]
    moved = next(m for m in MAN["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry["workloads"]:
        assert harness.reports(moved, cell, MAN), (metric, cell)
    # a reader that finds nothing to read returns nothing
    assert reader.read({"trace": None, "work": {}, "peaks": {}}) is None


def test_config_files_state_their_source():
    for c in MAN["configs"]:
        cfg = harness.read_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
